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
// One block of 4 warps takes one split of one (slot, KV head): the
// positions [p0, p0 + np) of a split of ``split_pages(page)`` pages of
// ``page`` positions (np = 128 where pages are at most 128). K2 runs the
// body with page = np = 128 over a dense row range, K5 over its page
// table's pages; positions and split boundaries are the same from
// position 0, and the arithmetic below does not depend on where a row came
// from, so on the same int8 rows (pages of at most 128) K2 and K5 give
// equal bits. The block, given the split's code rows and scales staged in
// shared memory by its row source (``stage``):
//   - scores: lanes take 16-byte column slices of a code row (D / 16 lanes
//     per row), hold their slices of a pass's G <= 8 query rows in
//     registers, and sum over the row's lanes with xor shuffles; an int4
//     byte row is read once for both of its positions (w: low nibbles, w +
//     page/2: high);
//   - the split's softmax in f32 (a warp per query row): its max m, its sum
//     l of exp(s - m), and p * vc/127 rounded to bf16;
//   - P V: each thread takes 4 columns of a set of rows, then the row sets
//     are summed in a fixed order: the split's partial state (m, l, O[G, D]).
// Query rows: the group's g query heads run in passes of a compiled row
// tile G (registers hold G rows' q slices and P V sums; shared memory G
// rows of scores and partial sums). A group g in {1, 2, 4, 8} is one pass
// of G = g rows; any other g runs ceil(g / 8) passes of G = 8 over the
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
constexpr int kSplitPositions = 128;   // a split holds max(1, 128 / page) pages

__host__ __device__ constexpr int split_pages(int page) {
  return page < kSplitPositions ? kSplitPositions / page : 1;
}
__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }
// the compiled row tile of a GQA group g: g itself where it is 1, 2, 4 or
// 8, else 8 (passes of 8 rows)
__host__ __device__ constexpr int row_tile(int g) { return g == 1 || g == 2 || g == 4 ? g : 8; }

// the dynamic shared memory of one block at row tile G, region by region
// (see decode_split)
__host__ __device__ constexpr int smem_bytes(int bits, int D, int G, int page) {
  return 2 * split_pages(page) * (bits == 8 ? page : page / 2) * D   // K, V code rows
         + 2 * split_pages(page) * page * 4                          // kc, vc
         + G * split_pages(page) * page * 4                          // scores, then p
         + round16(2 * G * 4)                                        // m, l
         + (512 / D) * G * D * 4                                     // P V partial sums
         + 16;                                                       // the last-block flag
}

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
// aligned sources holding a multiple of 4 floats past them; the last copy's
// positions past n are never read), else one a 4-byte copy.
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

// K5's rows: a slot's split of pages of its page table. Pools [P, Hkv,
// rows, dt] int8 (rows = page, or page / 2 for int4), scales [P, Hkv, 1,
// page] f32, 16-byte aligned.
template <int BITS, int D>
struct PagedRows {
  const int8_t* kq;
  const float* kc;
  const int8_t* vq;
  const float* vc;
  const int* pt;   // the slot's page table row
  int hkv, h, page, dt;

  __device__ __forceinline__ void stage(int8_t* Kc, int8_t* Vc, float* ksc, float* vsc,
                                        int split, int n_live) const {
    const int sp = split_pages(page), rows = BITS == 8 ? page : page / 2;
    const bool fast = dt % 16 == 0;
    for (int j = 0; j < sp; ++j) {
      const int pj = j * page;
      if (pj >= n_live) break;
      const int n_pos = min(page, n_live - pj);
      const int n_rows = BITS == 8 ? n_pos : min(n_pos, rows);
      const size_t ph = static_cast<size_t>(pt[split * sp + j]) * hkv + h;
      stage_code_rows<D>(Kc + j * rows * D, Vc + j * rows * D, kq + ph * rows * dt,
                         vq + ph * rows * dt, n_rows, dt, fast);
      stage_scales(ksc + pj, vsc + pj, kc + ph * page, vc + ph * page, n_pos, true);
    }
  }
};

// K2's rows: a (slot, KV head)'s contiguous int8 rows [S, dt] and scales
// [S]. ``codes16``: dt a multiple of 16 and the rows 16-byte aligned;
// ``scales16``: S a multiple of 4 and the scales 16-byte aligned (``generate``
// keeps the exact extent, so neither need hold).
template <int D>
struct DenseRows {
  const int8_t* k;
  const float* kc;
  const int8_t* v;
  const float* vc;
  int dt;
  bool codes16, scales16;

  __device__ __forceinline__ void stage(int8_t* Kc, int8_t* Vc, float* ksc, float* vsc,
                                        int split, int n_live) const {
    const size_t p0 = static_cast<size_t>(split) * kSplitPositions;
    stage_code_rows<D>(Kc, Vc, k + p0 * dt, v + p0 * dt, n_live, dt, codes16);
    stage_scales(ksc, vsc, kc + p0, vc + p0, n_live, scales16);
  }
};

// One block's split ``split`` of (slot, KV head) ``bh``, whose slot holds
// ``len`` positions, over pages of ``page`` positions, for the ``ng`` query
// heads of the KV head (the GQA group): one pass of the row tile G = ng
// (PASSES false), or ceil(ng / G) passes of G rows. q [bh * ng + g][D] in
// bf16 (q_bf16) or f32, out likewise; scratch [bh][nsplit][ng][D + 2];
// counters [bh], 0 on entry, 0 again when the call ends.
template <int BITS, int D, int G, bool PASSES, class Rows>
__device__ __forceinline__ void decode_split(const Rows& src, const void* __restrict__ q,
                                             void* __restrict__ out,
                                             float* __restrict__ scratch,
                                             int* __restrict__ counters, int q_bf16, int bh,
                                             int split, int nsplit, int len, int page,
                                             float scale, int ng) {
  constexpr int LPR = D / 16;           // lanes per code row in the score pass
  constexpr int RPW = 32 / LPR;         // code rows a warp takes at once
  constexpr int TPR = D / 4;            // threads per code row in the P V pass
  constexpr int NRG = kThreads / TPR;   // row sets of the P V pass
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
  const int sp = split_pages(page), np = sp * page;   // pages, positions per split
  const int p0 = split * np;
  if (p0 >= len) return;
  const int n_live = min(np, len - p0);              // the split's positions
  const int nsplit_live = (len + np - 1) / np;
  const int rows = BITS == 8 ? page : page / 2;      // byte rows per page

  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* Kc = reinterpret_cast<int8_t*>(smem_raw);                // [sp * rows][D]
  int8_t* Vc = Kc + sp * rows * D;                                 // [sp * rows][D]
  float* ksc = reinterpret_cast<float*>(Vc + sp * rows * D);       // [np]
  float* vsc = ksc + np;                                           // [np]
  float* S = vsc + np;                                             // [G][np]
  float* mrow = S + G * np;                                        // [G]
  float* lrow = mrow + G;                                          // [G]
  float* part = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(mrow) +
                                         round16(2 * G * 4));      // [NRG][G][D]
  int* flag = reinterpret_cast<int*>(part + NRG * G * D);

  // the split's code rows and scales -> shared memory, once for every pass
  src.stage(Kc, Vc, ksc, vsc, split, n_live);
  cp_async_commit();

  // the split's byte rows: every row below n_rows_all holds a live position
  // (int4: its low nibble's; its high nibble's is live if below n_live)
  const int last = (n_live - 1) / page;
  const int n_rows_all = BITS == 8 ? n_live : last * rows + min(rows, n_live - last * page);
  const auto pos_of = [&](int i) { return BITS == 8 || sp == 1 ? i : (i / rows) * page + i % rows; };
  const int lsub = lane % LPR, rsub = lane / LPR;
  const int c4 = (tid % TPR) * 4, rs = tid / TPR;   // the P V pass's columns and row set
  float* state = scratch + (static_cast<size_t>(bh) * nsplit + split) * NG * (D + 2);

  for (int pass = 0; pass < npass; ++pass) {
    const int g0 = pass * G;                                // the pass's first query row
    const int rows_live = PASSES ? min(G, NG - g0) : G;   // its rows inside the group
    // this lane's 16-column slice of the pass's G query rows, as bf16 (the
    // first pass loads them while the split's copies are in flight; rows
    // past the group are zeros)
    float qr[G][16];
    const size_t qrow = (static_cast<size_t>(bh) * NG + g0) * D + lsub * 16;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (PASSES && g >= rows_live) {
#pragma unroll
        for (int e = 0; e < 16; ++e) qr[g][e] = 0.f;
      } else if (q_bf16) {
        load8(static_cast<const bf16*>(q) + qrow + g * D, qr[g]);
        load8(static_cast<const bf16*>(q) + qrow + g * D + 8, qr[g] + 8);
      } else {
        load8(static_cast<const float*>(q) + qrow + g * D, qr[g]);
        load8(static_cast<const float*>(q) + qrow + g * D + 8, qr[g] + 8);
#pragma unroll
        for (int e = 0; e < 16; ++e) qr[g][e] = bf16_round(qr[g][e]);
      }
    }
    if (pass == 0) cp_async_wait<0>();
    __syncthreads();   // the split is staged; the last pass's readers are done

    // scores: s = (q . K) * scale * kc/127, lanes on 16-byte slices of a row
    for (int i0 = warp * RPW; i0 < n_rows_all; i0 += kWarps * RPW) {
      const int i = i0 + rsub;
      const bool ok = i < n_rows_all;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (ok) u = *reinterpret_cast<const uint4*>(Kc + i * D + lsub * 16);
      const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int half = 0; half < (BITS == 8 ? 1 : 2); ++half) {
        float kv[16];
#pragma unroll
        for (int k = 0; k < 4; ++k) kv_codes4<BITS>(wd[k], half == 1, kv + 4 * k);
        float s[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < 16; ++e) a = fmaf(qr[g][e], kv[e], a);
#pragma unroll
          for (int o = LPR / 2; o; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
          s[g] = a;
        }
        const int pos = ok ? pos_of(i) + half * rows : n_live;
        if (lsub == 0 && pos < n_live) {
          const float ks = ksc[pos] * (1.f / 127.f);
#pragma unroll
          for (int g = 0; g < G; ++g) S[g * np + pos] = (s[g] * scale) * ks;
        }
      }
    }
    __syncthreads();

    // the split's softmax, a warp per query row: m, l, and p * vc/127 in bf16
    for (int g = warp; g < G; g += kWarps) {
      float* sg = S + g * np;
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

    // P V: thread (row set rs, 4 columns c4) over rows rs, rs + NRG, ...
    float acc[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
    for (int i = rs; i < n_rows_all; i += NRG) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(Vc + i * D + c4);
      const int pos = pos_of(i);
#pragma unroll
      for (int half = 0; half < (BITS == 8 ? 1 : 2); ++half) {
        const int pp = pos + half * rows;
        if (pp >= n_live) break;
        float v[4];
        kv_codes4<BITS>(w, half == 1, v);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = S[g * np + pp];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(p, v[e], acc[g][e]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
      *reinterpret_cast<float4*>(part + (rs * G + g) * D + c4) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
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
