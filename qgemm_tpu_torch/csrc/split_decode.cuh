// The split body of the decode kernels K2 (decode_attention.cu, the dense
// int8 KV cache) and K5 (paged_decode_attention.cu, the paged int8 and int4
// pools): one decode step (Sq = 1) of attention as flash-decoding.
//
// Math, for query head h of slot b (KV head h / G):
//   s_j = (bf16(q) . K_j) * scale * (kc_j / 127),   j < len_b,
// a softmax in f32, p_j * (vc_j / 127) rounded to bf16 before the V
// product, out = O / max(l, 1e-30), written once in q's dtype. int8 (and
// int4) codes are exact in bf16, so the products are exact and only the
// f32 sums round. A slot of length 0 writes zeros.
//
// One block of 4 warps takes one split of one (slot, KV head). A split
// holds about SP = ``split_positions(D)`` positions (128, or 64 at D 1024,
// whose code rows would pass the shared memory). K2's split is SP
// consecutive positions from position 0; so is K5's on int8 pools
// (``aligned``), staged piece by piece from the pages it touches, but for
// the pages the kernels took first (D up to 256, multiples of 8 up to 256),
// which keep whole pages. On int4 pools and those pages a split is
// ``split_pages`` whole pages where pages hold at most SP positions (SP /
// page of them), one page where a page is larger but at most
// ``max_whole_page(D)`` (256 up to D 256), and else a chunk of a page: SP / 2
// byte rows of an int4 page (their low and high nibbles, SP positions).
// The row source (``Rows::geom``) gives the body its split's layout (pages,
// positions a page, live positions) and the slot's live splits, which are
// a prefix of its splits, and stages the split (``stage``). The arithmetic
// below does not depend on where a row came from, so on the same int8 rows
// K2 and K5 give equal bits wherever their splits are the same positions:
// at every int8 page but the first pages that do not divide SP (24, 40,
// ..., 136 to 256). The block, given the split's code rows and scales
// staged in shared memory:
//   - scores: lanes take 16-byte column slices of a code row (D / 16 lanes
//     per row, at most 32: at D 1024 a lane takes two slices), hold their
//     slices of a pass's G query rows in registers, and sum over the row's
//     lanes with xor shuffles; an int4 byte row is read once for both of
//     its positions (w: low nibbles, w + rows: high);
//   - the split's softmax in f32 (a warp per query row): its max m, its sum
//     l of exp(s - m), and p * vc/127 rounded to bf16;
//   - P V: each thread takes 4 columns (8 at D 1024) of a set of rows,
//     then the row sets are summed in a fixed order: the split's partial
//     state (m, l, O[G, D]).
// Query rows: the group's g query heads run in passes of a compiled row
// tile G (registers hold G rows' q slices and P V sums; shared memory G
// rows of scores and partial sums). A group g in {1, 2, 4, 8} is one pass
// of G = g rows (at D 1024 G is at most 4: q's slices of 8 rows would be
// 256 registers); any other g runs ceil(g / 8) passes of G = 8 over the
// split's K and V, which are staged in shared memory once, the last
// pass's spare rows computed on zero q and never written. So a slot's
// cache is read from device memory once at any g: at g 71 (Falcon-7B, one
// KV head) a block makes 9 passes over its 128 positions. What bounds it
// is still the cache read (bytes), now at g / 8 passes of the score and
// P V loops per byte: at g 71, d 64, ~4 * 71 * 64 flops per 2 * 64 + 8
// bytes a position, ~130 per byte, still under the card's balance.
// A slot of one live split writes its output at once. Otherwise each block
// writes its partial state to scratch and, after a __threadfence, counts
// itself done on the (slot, KV head)'s counter; the last block to finish
// merges the states IN SPLIT ORDER (deterministic, whatever order the
// blocks finished in, and the same at every g and row tile), writes out =
// O / max(L, 1e-30), and resets the counter to 0 for the next call: one
// launch per call. Codes become f32 by a byte permute into an f32's
// mantissa (exact; no int-to-float convert).
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace qg {
namespace split_decode {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4, kThreads = 128;

// positions a split holds: 128, or 64 at D 1024
__host__ __device__ constexpr int split_positions(int D) { return D <= 512 ? 128 : 64; }
// the largest page a split holds whole: 256 up to D 256 (the shape the
// kernels took first), else one split's positions
__host__ __device__ constexpr int max_whole_page(int D) {
  return D <= 256 ? 256 : split_positions(D);
}
// int8 pools at the pages the kernels took first (D up to 256, pages that
// are multiples of 8 up to 256) keep whole-page splits; at every other int8
// page a split is K2's, SP consecutive positions from position 0, staged
// piece by piece from the pages it touches, so K5 equals K2 bit for bit
__host__ __device__ constexpr bool aligned(int bits, int D, int page) {
  return bits == 8 && !(D <= 256 && page % 8 == 0 && page <= 256);
}
// whether an int4 page of ``page`` positions is split into chunks of its rows
__host__ __device__ constexpr bool chunked(int D, int page) { return page > max_whole_page(D); }
// whole pages a split holds (1 where the split is a chunk of a page)
__host__ __device__ constexpr int split_pages(int D, int page) {
  return page < split_positions(D) ? split_positions(D) / page : 1;
}
// a chunked page's byte rows a split holds, and its splits a page
__host__ __device__ constexpr int chunk_rows(int bits, int D) {
  return bits == 8 ? split_positions(D) : split_positions(D) / 2;
}
__host__ __device__ constexpr int chunks_per_page(int bits, int D, int page) {
  return ((bits == 8 ? page : page / 2) + chunk_rows(bits, D) - 1) / chunk_rows(bits, D);
}
// a slot's splits over a page table of ``pps`` pages, and the whole pages
// a split holds (1 where it is K2's positions or a chunk of a page)
__host__ __device__ constexpr int paged_splits(int bits, int D, int page, int pps) {
  return aligned(bits, D, page)
             ? (pps * page + split_positions(D) - 1) / split_positions(D)
         : chunked(D, page) ? pps * chunks_per_page(bits, D, page)
                            : (pps + split_pages(D, page) - 1) / split_pages(D, page);
}
__host__ __device__ constexpr int paged_split_pages(int bits, int D, int page) {
  return aligned(bits, D, page) || chunked(D, page) ? 1 : split_pages(D, page);
}
// the most splits one launch takes (the grid's y), a launch per chunk past it
constexpr int kMaxGridSplits = 65535;
__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }
__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }
// the compiled row tile of a GQA group g: g itself where it is 1, 2, 4 or
// 8 (and at most max_rows(D)), else max_rows(D) (passes of that many rows)
__host__ __device__ constexpr int max_rows(int D) { return D <= 512 ? 8 : 4; }
__host__ __device__ constexpr int row_tile(int g, int D) {
  return (g == 1 || g == 2 || g == 4 || g == 8) && g <= max_rows(D) ? g : max_rows(D);
}
// P V: columns a thread takes, and the row sets of the pass
__host__ __device__ constexpr int pv_cols(int D) { return D <= 512 ? 4 : D / 128; }
__host__ __device__ constexpr int pv_row_sets(int D) { return kThreads / (D / pv_cols(D)); }

// the dynamic shared memory of one block at row tile G over a split of
// whole pages of ``page`` positions, region by region (see decode_split;
// the per-position regions rounded up to 4 floats, so every region stays
// 16-byte aligned at any page)
__host__ __device__ constexpr int smem_layout(int bits, int D, int G, int page) {
  return 2 * split_pages(D, page) * (bits == 8 ? page : page / 2) * D   // K, V code rows
         + 2 * round4(split_pages(D, page) * page) * 4                 // kc, vc
         + G * round4(split_pages(D, page) * page) * 4                 // scores, then p
         + round16(2 * G * 4)                                          // m, l
         + pv_row_sets(D) * G * D * 4                                  // P V partial sums
         + 16;                                                         // the last-block flag
}
// ... at ``page``: K2's splits and a chunk of a page are laid out as a
// page of SP
__host__ __device__ constexpr int smem_bytes(int bits, int D, int G, int page) {
  return smem_layout(bits, D, G,
                     aligned(bits, D, page) || chunked(D, page) ? split_positions(D) : page);
}

// A split's layout for the body: ``sp`` pages of ``page`` positions
// (byte rows: page, or page / 2 for int4), ``n_live`` live positions (a
// prefix of the split's), and the slot's live splits ``nsplit_live``.
struct Geom {
  int sp, page, n_live, nsplit_live;
};

// n_rows K and V code rows of true width dt (rows dt bytes apart) into
// shared rows of D bytes, columns past dt zero: 16-byte cp.async where
// ``fast`` (dt a multiple of 16, sources 16-byte aligned), byte loads
// otherwise.
template <int D>
__device__ __forceinline__ void stage_code_rows(int8_t* Kd, int8_t* Vd, const int8_t* Ks,
                                                const int8_t* Vs, int n_rows, int dt,
                                                bool fast) {
  constexpr int CH = D / 16;   // 16-byte chunks of a code row
  for (int i = threadIdx.x; i < 2 * n_rows * CH; i += kThreads) {
    const int which = i >= n_rows * CH, rem = which ? i - n_rows * CH : i;
    const int r = rem / CH, c = (rem % CH) * 16;
    const int8_t* src = (which ? Vs : Ks) + static_cast<size_t>(r) * dt + c;
    int8_t* dst = (which ? Vd : Kd) + r * D + c;
    if (fast) {
      cp_async16(smem_addr(dst), c < dt ? src : Ks, c < dt ? 16 : 0);
    } else {
      uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (c + e < dt) wd[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(src[e])) << (8 * (e % 4));
      *reinterpret_cast<uint4*>(dst) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
  }
}

// n positions' f32 K and V scales: 4 a 16-byte copy where ``vec`` (16-byte
// aligned sources and destinations holding a multiple of 4 floats past
// them; the last copy's positions past n are never read), else one a
// 4-byte copy.
__device__ __forceinline__ void stage_scales(float* kd, float* vd, const float* ks,
                                             const float* vs, int n, bool vec) {
  if (vec) {
    const int nch = (n + 3) / 4;
    for (int i = threadIdx.x; i < 2 * nch; i += kThreads) {
      const int which = i >= nch, c = (which ? i - nch : i) * 4;
      cp_async16(smem_addr((which ? vd : kd) + c), (which ? vs : ks) + c, 16);
    }
  } else {
    for (int i = threadIdx.x; i < 2 * n; i += kThreads) {
      const int which = i >= n, c = which ? i - n : i;
      cp_async4(smem_addr((which ? vd : kd) + c), (which ? vs : ks) + c, 4);
    }
  }
}

// K5's rows: a slot's split of its page table's pages. Pools [P, Hkv,
// rows, dt] int8 (rows = page, or page / 2 for int4), scales [P, Hkv, 1,
// page] f32, 16-byte aligned; any page (int4: even).
template <int BITS, int D>
struct PagedRows {
  const int8_t* kq;
  const float* kc;
  const int8_t* vq;
  const float* vc;
  const int* pt;   // the slot's page table row
  int hkv, h, page, dt;

  __device__ __forceinline__ Geom geom(int split, int len) const {
    const int rows_pp = BITS == 8 ? page : page / 2;
    if (aligned(BITS, D, page)) {   // K2's split: positions [split * SP, split * SP + SP)
      constexpr int SP = split_positions(D);
      return {1, SP, min(SP, len - split * SP), (len + SP - 1) / SP};
    }
    if (!chunked(D, page)) {
      const int sp = split_pages(D, page), np = sp * page;
      return {sp, page, min(np, len - split * np), (len + np - 1) / np};
    }
    // a chunk of byte rows [a, a + rc) of logical page j: int8 positions
    // a.., int4 positions a.. (low nibbles) and rows_pp + a.. (high)
    constexpr int RC = chunk_rows(BITS, D);
    const int cpp = (rows_pp + RC - 1) / RC;
    const int j = split / cpp, a = (split % cpp) * RC, rc = min(RC, rows_pp - a);
    const int n = len - j * page;   // the slot's positions from this page on
    const int low = max(0, min(rc, n - a));
    const int high = BITS == 8 ? 0 : max(0, min(rc, n - rows_pp - a));
    const int rem = len % page;
    const int live = (len / page) * cpp + min(cpp, (rem + RC - 1) / RC);
    return {1, BITS == 8 ? rc : 2 * rc, low + high, live};
  }

  __device__ __forceinline__ void stage(int8_t* Kc, int8_t* Vc, float* ksc, float* vsc,
                                        int split, const Geom& g) const {
    const int rows_pp = BITS == 8 ? page : page / 2;
    const bool fast = dt % 16 == 0;
    if (aligned(BITS, D, page)) {   // the pieces of the pages positions [p0, p0 + n_live) touch
      const int p0 = split * split_positions(D), p1 = p0 + g.n_live;
      for (int j = p0 / page; j * page < p1; ++j) {
        const int a = max(p0, j * page), z = min(p1, (j + 1) * page), w0 = a - j * page;
        const size_t ph = static_cast<size_t>(pt[j]) * hkv + h;
        stage_code_rows<D>(Kc + (a - p0) * D, Vc + (a - p0) * D, kq + (ph * page + w0) * dt,
                           vq + (ph * page + w0) * dt, z - a, dt, fast);
        stage_scales(ksc + (a - p0), vsc + (a - p0), kc + ph * page + w0, vc + ph * page + w0,
                     z - a, false);
      }
      return;
    }
    if (chunked(D, page)) {
      constexpr int RC = chunk_rows(BITS, D);
      const int cpp = (rows_pp + RC - 1) / RC;
      const int j = split / cpp, a = (split % cpp) * RC;
      const int rc = BITS == 8 ? g.page : g.page / 2;
      const int low = min(rc, g.n_live);
      const size_t ph = static_cast<size_t>(pt[j]) * hkv + h;
      stage_code_rows<D>(Kc, Vc, kq + (ph * rows_pp + a) * dt, vq + (ph * rows_pp + a) * dt,
                         low, dt, fast);
      stage_scales(ksc, vsc, kc + ph * page + a, vc + ph * page + a, low, false);
      if (g.n_live > low)   // int4: the high nibbles' positions
        stage_scales(ksc + rc, vsc + rc, kc + ph * page + rows_pp + a,
                     vc + ph * page + rows_pp + a, g.n_live - low, false);
      return;
    }
    const int sp = g.sp, rows = rows_pp, n_live = g.n_live;
    const bool vec = page % 4 == 0;
    for (int j = 0; j < sp; ++j) {
      const int pj = j * page;
      if (pj >= n_live) break;
      const int n_pos = min(page, n_live - pj);
      const int n_rows = BITS == 8 ? n_pos : min(n_pos, rows);
      const size_t ph = static_cast<size_t>(pt[split * sp + j]) * hkv + h;
      stage_code_rows<D>(Kc + j * rows * D, Vc + j * rows * D, kq + ph * rows * dt,
                         vq + ph * rows * dt, n_rows, dt, fast);
      stage_scales(ksc + pj, vsc + pj, kc + ph * page, vc + ph * page, n_pos, vec);
    }
  }
};

// K2's rows: a (slot, KV head)'s contiguous int8 rows [S, dt] and scales
// [S], in splits of SP positions. ``codes16``: dt a multiple of 16 and the
// rows 16-byte aligned; ``scales16``: S a multiple of 4 and the scales
// 16-byte aligned (``generate`` keeps the exact extent, so neither need
// hold).
template <int D>
struct DenseRows {
  const int8_t* k;
  const float* kc;
  const int8_t* v;
  const float* vc;
  int dt;
  bool codes16, scales16;

  __device__ __forceinline__ Geom geom(int split, int len) const {
    constexpr int SP = split_positions(D);
    return {1, SP, min(SP, len - split * SP), (len + SP - 1) / SP};
  }

  __device__ __forceinline__ void stage(int8_t* Kc, int8_t* Vc, float* ksc, float* vsc,
                                        int split, const Geom& g) const {
    const size_t p0 = static_cast<size_t>(split) * split_positions(D);
    stage_code_rows<D>(Kc, Vc, k + p0 * dt, v + p0 * dt, g.n_live, dt, codes16);
    stage_scales(ksc, vsc, kc + p0, vc + p0, g.n_live, scales16);
  }
};

// One block's split ``split`` of (slot, KV head) ``bh``, whose slot holds
// ``len`` positions, for the ``ng`` query heads of the KV head (the GQA
// group): one pass of the row tile G = ng (PASSES false), or ceil(ng / G)
// passes of G rows. q [bh * ng + g][D] in bf16 (q_bf16) or f32, out
// likewise; scratch [bh][nsplit][ng][D + 2]; counters [bh], 0 on entry, 0
// again when the call ends.
template <int BITS, int D, int G, bool PASSES, class Rows>
__device__ __forceinline__ void decode_split(const Rows& src, const void* __restrict__ q,
                                             void* __restrict__ out,
                                             float* __restrict__ scratch,
                                             int* __restrict__ counters, int q_bf16, int bh,
                                             int split, int nsplit, int len, float scale,
                                             int ng) {
  constexpr int LPR = D / 16 < 32 ? D / 16 : 32;   // lanes per code row in the score pass
  constexpr int SPL = D / 16 / LPR;                // 16-byte slices a lane takes
  constexpr int RPW = 32 / LPR;                    // code rows a warp takes at once
  constexpr int CW = pv_cols(D);                   // columns a thread takes in the P V pass
  constexpr int TPR = D / CW;                      // threads per code row in the P V pass
  constexpr int NRG = kThreads / TPR;              // row sets of the P V pass
  const int NG = PASSES ? ng : G;       // the group's query rows
  const int npass = PASSES ? (ng + G - 1) / G : 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t orow = static_cast<size_t>(bh) * NG * D;   // this (slot, KV head)'s outputs
  const auto store = [&](int i, float v) {
    if (q_bf16) static_cast<bf16*>(out)[orow + i] = __float2bfloat16_rn(v);
    else static_cast<float*>(out)[orow + i] = v;
  };
  if (len == 0) {
    if (split == 0)
      for (int i = tid; i < NG * D; i += kThreads) store(i, 0.f);
    return;
  }
  const Geom geo = src.geom(split, len);
  if (geo.n_live <= 0) return;
  const int sp = geo.sp, page = geo.page, np = sp * page;   // pages, positions per split
  const int npad = round4(np);                             // the per-position regions' stride
  const int n_live = geo.n_live;                           // the split's positions
  const int nsplit_live = geo.nsplit_live;
  const int rows = BITS == 8 ? page : page / 2;      // byte rows per page

  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* Kc = reinterpret_cast<int8_t*>(smem_raw);                // [sp * rows][D]
  int8_t* Vc = Kc + sp * rows * D;                                 // [sp * rows][D]
  float* ksc = reinterpret_cast<float*>(Vc + sp * rows * D);       // [npad]
  float* vsc = ksc + npad;                                         // [npad]
  float* S = vsc + npad;                                           // [G][npad]
  float* mrow = S + G * npad;                                      // [G]
  float* lrow = mrow + G;                                          // [G]
  float* part = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(mrow) +
                                         round16(2 * G * 4));      // [NRG][G][D]
  int* flag = reinterpret_cast<int*>(part + NRG * G * D);

  // the split's code rows and scales -> shared memory, once for every pass
  src.stage(Kc, Vc, ksc, vsc, split, geo);
  cp_async_commit();

  // the split's byte rows: every row below n_rows_all holds a live position
  // (int4: its low nibble's; its high nibble's is live if below n_live)
  const int last = (n_live - 1) / page;
  const int n_rows_all = BITS == 8 ? n_live : last * rows + min(rows, n_live - last * page);
  const auto pos_of = [&](int i) { return BITS == 8 || sp == 1 ? i : (i / rows) * page + i % rows; };
  const int lsub = lane % LPR, rsub = lane / LPR;
  const int cw = (tid % TPR) * CW, rs = tid / TPR;   // the P V pass's columns and row set
  float* state = scratch + (static_cast<size_t>(bh) * nsplit + split) * NG * (D + 2);

  for (int pass = 0; pass < npass; ++pass) {
    const int g0 = pass * G;                                // the pass's first query row
    const int rows_live = PASSES ? min(G, NG - g0) : G;   // its rows inside the group
    // this lane's 16-column slices of the pass's G query rows, as bf16 (the
    // first pass loads them while the split's copies are in flight; rows
    // past the group are zeros)
    float qr[G][16 * SPL];
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int sl = 0; sl < SPL; ++sl) {
        const size_t qrow = (static_cast<size_t>(bh) * NG + g0 + g) * D + (lsub + sl * LPR) * 16;
        float* qd = qr[g] + 16 * sl;
        if (PASSES && g >= rows_live) {
#pragma unroll
          for (int e = 0; e < 16; ++e) qd[e] = 0.f;
        } else if (q_bf16) {
          load8(static_cast<const bf16*>(q) + qrow, qd);
          load8(static_cast<const bf16*>(q) + qrow + 8, qd + 8);
        } else {
          load8(static_cast<const float*>(q) + qrow, qd);
          load8(static_cast<const float*>(q) + qrow + 8, qd + 8);
#pragma unroll
          for (int e = 0; e < 16; ++e) qd[e] = bf16_round(qd[e]);
        }
      }
    }
    if (pass == 0) cp_async_wait<0>();
    __syncthreads();   // the split is staged; the last pass's readers are done

    // scores: s = (q . K) * scale * kc/127, lanes on 16-byte slices of a row
    // (SPL of them at D 1024, summed in slice order before the lanes' sum)
    for (int i0 = warp * RPW; i0 < n_rows_all; i0 += kWarps * RPW) {
      const int i = i0 + rsub;
      const bool ok = i < n_rows_all;
      uint32_t wd[SPL][4];
#pragma unroll
      for (int sl = 0; sl < SPL; ++sl) {
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (ok) u = *reinterpret_cast<const uint4*>(Kc + i * D + (lsub + sl * LPR) * 16);
        wd[sl][0] = u.x;
        wd[sl][1] = u.y;
        wd[sl][2] = u.z;
        wd[sl][3] = u.w;
      }
#pragma unroll
      for (int half = 0; half < (BITS == 8 ? 1 : 2); ++half) {
        float s[G];
#pragma unroll
        for (int g = 0; g < G; ++g) s[g] = 0.f;
#pragma unroll
        for (int sl = 0; sl < SPL; ++sl) {
          float kv[16];
#pragma unroll
          for (int k = 0; k < 4; ++k) kv_codes4<BITS>(wd[sl][k], half == 1, kv + 4 * k);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float a = s[g];
#pragma unroll
            for (int e = 0; e < 16; ++e) a = fmaf(qr[g][16 * sl + e], kv[e], a);
            s[g] = a;
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float a = s[g];
#pragma unroll
          for (int o = LPR / 2; o; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
          s[g] = a;
        }
        const int pos = ok ? pos_of(i) + half * rows : n_live;
        if (lsub == 0 && pos < n_live) {
          const float ks = ksc[pos] * (1.f / 127.f);
#pragma unroll
          for (int g = 0; g < G; ++g) S[g * npad + pos] = (s[g] * scale) * ks;
        }
      }
    }
    __syncthreads();

    // the split's softmax, a warp per query row: m, l, and p * vc/127 in bf16
    for (int g = warp; g < G; g += kWarps) {
      float* sg = S + g * npad;
      float mx = -1e30f;
      for (int j = lane; j < n_live; j += 32) mx = fmaxf(mx, sg[j]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < n_live; j += 32) {
        const float p = expf(sg[j] - mx);
        sum += p;
        sg[j] = bf16_round(p * (vsc[j] * (1.f / 127.f)));
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        mrow[g] = mx;
        lrow[g] = sum;
      }
    }
    __syncthreads();

    // P V: thread (row set rs, CW columns cw) over rows rs, rs + NRG, ...
    float acc[G][CW];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < CW; ++e) acc[g][e] = 0.f;
    for (int i = rs; i < n_rows_all; i += NRG) {
      uint32_t w[CW / 4];
#pragma unroll
      for (int c = 0; c < CW / 4; ++c)
        w[c] = *reinterpret_cast<const uint32_t*>(Vc + i * D + cw + 4 * c);
      const int pos = pos_of(i);
#pragma unroll
      for (int half = 0; half < (BITS == 8 ? 1 : 2); ++half) {
        const int pp = pos + half * rows;
        if (pp >= n_live) break;
        float v[CW];
#pragma unroll
        for (int c = 0; c < CW / 4; ++c) kv_codes4<BITS>(w[c], half == 1, v + 4 * c);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = S[g * npad + pp];
#pragma unroll
          for (int e = 0; e < CW; ++e) acc[g][e] = fmaf(p, v[e], acc[g][e]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < CW / 4; ++c)
        *reinterpret_cast<float4*>(part + (rs * G + g) * D + cw + 4 * c) =
            make_float4(acc[g][4 * c], acc[g][4 * c + 1], acc[g][4 * c + 2], acc[g][4 * c + 3]);
    __syncthreads();
    // the pass's rows: out (one live split) or their partial state
    for (int i = tid; i < rows_live * D; i += kThreads) {
      float o = 0.f;
#pragma unroll
      for (int r = 0; r < NRG; ++r) o += part[r * G * D + i];
      if (nsplit_live == 1) store(g0 * D + i, o / fmaxf(lrow[i / D], 1e-30f));
      else state[g0 * D + i] = o;
    }
    if (nsplit_live > 1 && tid < rows_live) {
      state[NG * D + g0 + tid] = mrow[tid];
      state[NG * D + NG + g0 + tid] = lrow[tid];
    }
  }
  if (nsplit_live == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(counters + bh, 1) == nsplit_live - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();

  // the last block: merge the live splits' states in split order
  const float* st0 = scratch + static_cast<size_t>(bh) * nsplit * NG * (D + 2);
  for (int i = tid; i < NG * D; i += kThreads) {
    const int g = i / D;
    float mx = -1e30f;
    for (int s = 0; s < nsplit_live; ++s) mx = fmaxf(mx, __ldcg(st0 + s * NG * (D + 2) + NG * D + g));
    float l = 0.f, o = 0.f;
    for (int s = 0; s < nsplit_live; ++s) {
      const float* ss = st0 + s * NG * (D + 2);
      const float f = expf(__ldcg(ss + NG * D + g) - mx);
      l += __ldcg(ss + NG * D + NG + g) * f;
      o += __ldcg(ss + i) * f;
    }
    store(i, o / fmaxf(l, 1e-30f));
  }
  if (tid == 0) counters[bh] = 0;
}

}  // namespace split_decode
}  // namespace qg
