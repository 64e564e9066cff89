// Kernel K6: chunk (multi-row) attention over the PAGED KV cache, causal at
// a per-slot offset, int8 or int4 pools, for Hopper (sm_90a).
//
// Replaces _context_kernel / paged_context_attention of
// qgemm_tpu/ops/pallas/paged_attention.py, the blocked form of
// paged_context_attention_reference. The query heads of a KV head fold into
// the row axis: q [B, Hq, C, D] is read as [B, Hkv, R = G*C, D], row r being
// query head-group r / C at chunk position r % C. Row r attends position k
// iff k <= offset[b] + r % C and k < lengths[b]. Same math as K5:
//   s = (bf16(q) . K_k) * (1/sqrt(d)) * (kc_k / 127); online softmax in f32;
//   p * (vc_k / 127) rounded to bf16 before the V product;
//   out = acc / max(l, 1e-30), written once in q's dtype.
// The TPU kernel asserts int8 pools (the JAX model sends int4 chunks through
// its gather oracle); this kernel unpacks int4 pools too, so both pool types
// run it.
//
// What bounds it on the H100: at the engine's chunks (C = 256 rows after up
// to ~1024 resident positions, D = 128, MHA) the bf16 products, ~4 * D
// operations per (row, attended position), and the one read of the
// attended K/V pages take about the same least time (~0.004 ms each at one
// 256-row chunk after 768 positions). The first kernel ran both products as
// f32 FMAs on the CUDA cores over a shared-memory score tile (~96x that
// bound); this one puts them on the tensor cores and keeps S and P in
// registers.
//
// Design: K3's bf16 route (flash_fwd_mma_kernel, FlashAttention-2 on
// mma.sync m16n8k16) with the page walk and the per-key scales added. One
// block per (64 folded rows, slot * KV head), the last row blocks (the most
// keys) first: at one chunk of one slot that is only ~128 blocks, one an
// SM, so the block holds two groups of 4 warps (16 rows a warp) over the
// same rows, group g taking key tiles g, g + 2, ... Each group runs its own
// pipeline on a named barrier of its 128 threads, so one group converts a
// tile while the other runs its products, and the two merge their (m, l,
// acc) through shared memory at the end. q is rounded to bf16 as it is
// staged and held as A fragments in registers. Every operand of both
// products is exact in bf16 (q after that rounding, the int8 and int4
// codes, p * vc/127 after its rounding), so the products are the plain
// version's and only their f32 sums differ in order. K/V codes arrive in
// 64-position tiles through each group's two-stage cp.async ring; each
// 16-position sub-tile lies in one page (pages that are multiples of 16),
// whose physical page is resolved once, so a tile straddles pages at page
// 16 and 32. One pass turns a tile's codes into padded bf16 tiles (a byte permute
// per code, exact; int4 pools: a page's byte row w holds position w in its
// low nibbles and w + page/2 in its high ones, picked per position), which
// ldmatrix and ldmatrix.trans read as B operands. Each S column is scaled by
// (s * scale) * kc/127, the online softmax runs on the fragments (exp as
// ex2.approx, ~2 ulp), and p * vc/127 rounded to bf16 is packed straight
// into P V's A fragments. A row whose keys all lie in the first tile (the
// first causal rows of a chunk at offset 0, which attend a few keys with
// O(1) weights) is normalized before that rounding, as the plain version
// does (p / l, with CUDA's full-precision expf, within 2 ulp), so its
// outputs round like the plain version's. Only the tiles that cross a
// warp's diagonal or hold the length tail are masked; a warp whose rows all
// end before a tile skips it. The block's page walk stops at its rows' last
// causal position (the TPU kernel's "tight" bound) and at the slot's
// length, so later pages are never read.
//
// Head widths: compiled for D in {32, 64, 128, 256}; the pools' rows hold
// the true width d <= D (16-byte cp.async when d is a multiple of 16, byte
// loads otherwise; columns past d staged as zeros). The wrapper pads the
// per-call q to D and slices the output; the pools are never copied.
//
// D 256 has its own tiling (Tiling<256>): at D 128 a thread already holds
// q's A fragments (32 registers), O (64) and a 64-key tile's S and P (48),
// at 253-255 registers, and D 256 doubles q and O. So a D 256 block is one
// warp group (4 warps of 16 rows, 64 rows a block) over 32-key tiles, and
// q stays in shared memory (its A fragments loaded per k-chunk by
// ldmatrix): O 128 registers, S and P 24. Shared memory ~99 KB a block
// (the ring, the bf16 K and V tiles, q), two blocks an SM. The row blocks,
// page walk, scales, masks and rounding points are the narrower widths'.
//
// Pages: any size (int4: even). A key tile is walked in sub-tiles of 16
// positions where pages are multiples of 16, else of 8 where they are
// multiples of 8, else of 1, each in one page, whose physical page is
// resolved once: a sub-tile never straddles a page boundary. Large pages
// need nothing more: a sub-tile's rows are contiguous in its page.
//
// Grid: one dimension, (row block, slot * KV head) with row blocks
// fastest, so slots x KV heads may pass 65,535.
//
// Past D 256 a "wide" kernel takes over (paged_context_wide_kernel; the
// SIMT layout of flash_wide.cuh, which K3's and K7's wide routes share):
// widths are runtime multiples of 64 (the wrapper pads q), S accumulates
// over D in 64-column chunks staged in shared memory (q rounded to bf16, K
// codes read position by position through the page table), and O runs in
// chunks of 256 columns, one block per chunk. It makes two passes over the
// keys, the first for each row's max and sum, the second for P V with p
// normalized before its rounding, as the plain version does (so no row
// needs the first-tile rule). Slow, and right; it takes any width.
//
// The launch plan (row blocks, key tile, shared memory) comes from
// qgemm_tpu_torch/ops/cuda/paged_plan.py; the entry refuses any other.
#include "common.cuh"
#include "flash_wide.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kBQ = 64;      // folded rows per block: 4 warps x 16 in each group

// D <= 128: two warp groups (group g takes key tiles g, g + 2, ...) over
// 64-key tiles, q's A fragments in registers; D 256: one group over 32-key
// tiles, q in shared memory (the source note says why)
template <int D> struct Tiling {
  static constexpr bool kWide = D > 128;
  static constexpr int kGroups = kWide ? 1 : 2;
  static constexpr int kBK = kWide ? 32 : 64;   // key positions per tile
  static constexpr int kThreads = 128 * kGroups;
};

template <int D> __host__ __device__ constexpr int ldb() { return D + 8; }  // bf16 row stride (+16 B)
// SUB: positions per sub-tile, one page each (16, 8 or 1: the largest
// that divides the page)
template <int D, int SUB> constexpr size_t smem_bytes() {
  using T = Tiling<D>;
  return static_cast<size_t>(T::kGroups * 2 * 2 * T::kBK * D)  // code rings: groups x 2 stages x (K, V)
         + T::kGroups * 2 * 2 * T::kBK * sizeof(float)    // scale rings: groups x 2 stages x (kc, vc)
         + T::kGroups * 2 * sizeof(bf16) * T::kBK * ldb<D>()   // each group's K and V tile in bf16
         + T::kGroups * 2 * T::kBK * sizeof(float)        // each group's kc/127, vc/127
         + T::kGroups * 2 * (T::kBK / SUB) * sizeof(int)  // each stage's sub-tiles' first page row
         + (T::kWide ? sizeof(bf16) * kBQ * ldb<D>() : 0);   // q (wide: kept in shared memory)
}

template <int BITS, int D, int SUB>
__global__ void __launch_bounds__(Tiling<D>::kThreads)
paged_context_mma_kernel(const void* __restrict__ q, const int8_t* __restrict__ kq,
                         const float* __restrict__ kc, const int8_t* __restrict__ vq,
                         const float* __restrict__ vc, const int* __restrict__ page_table,
                         const int* __restrict__ lengths, const int* __restrict__ offsets,
                         int offset0, void* __restrict__ out, int q_bf16, int hkv, int C, int R,
                         int page, int pps, int dt, float scale) {
  constexpr bool kWide = Tiling<D>::kWide;
  constexpr int kGroups = Tiling<D>::kGroups, kBK = Tiling<D>::kBK;
  constexpr int kThreads = Tiling<D>::kThreads, kSub = SUB;
  constexpr int LDB = ldb<D>();
  constexpr int KD = D / 16;      // k16 chunks of the head width
  constexpr int NS = kBK / 8;     // n8 tiles of a warp's scores
  constexpr int NO = D / 8;       // n8 tiles of a warp's output
  constexpr int CH = D / 16;      // 16-byte chunks of a code row
  constexpr int NSUB = kBK / kSub;
  constexpr int TILE = 2 * kBK * D;                 // one tile's K and V codes, bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem_raw);                      // [G][2][K, V][kBK][D]
  float* ring_sc = reinterpret_cast<float*>(ring + 2 * kGroups * TILE);    // [G][2][kc, vc][kBK]
  bf16* Kb = reinterpret_cast<bf16*>(ring_sc + 2 * kGroups * 2 * kBK);     // [G][K, V][kBK][LDB]
  float* ks = reinterpret_cast<float*>(Kb + kGroups * 2 * kBK * LDB);      // [G][kc, vc][kBK]
  int* sub_w = reinterpret_cast<int*>(ks + kGroups * 2 * kBK);             // [G][2][NSUB]
  // q in bf16: its own region when wide, else group 0's K tile until the
  // fragments are in registers
  bf16* Qs = kWide ? reinterpret_cast<bf16*>(sub_w + kGroups * 2 * NSUB) : Kb;   // [kBQ][LDB]

  const int nrb = (R + kBQ - 1) / kBQ;
  const qg::FlatIdx blk = qg::flat_block(nrb);   // (row block, slot * KV head)
  const int bh = blk.o, b = bh / hkv, h = bh % hkv;
  const int r0 = (nrb - 1 - blk.i) * kBQ;   // the last row blocks first
  const int tid = threadIdx.x, lane = tid & 31, t = lane & 3;
  const int grp = tid / 128, warp = (tid / 32) % 4;     // warp group, warp in the group
  const int rows_pp = BITS == 8 ? page : page / 2;     // byte rows per page
  const int* pt = page_table + static_cast<size_t>(b) * pps;
  const int len = min(lengths[b], pps * page);        // never past the table
  const int off = offsets != nullptr ? offsets[b] : offset0;
  const bool fast = dt % 16 == 0;                      // rows 16-byte aligned

  // the block's rows attend positions up to their last causal one: within
  // one head-group, off + (last row) % C; across a group boundary, off + C - 1
  const int r_last = min(r0 + kBQ, R) - 1;
  const int bound = (r0 / C == r_last / C) ? off + r_last % C : off + C - 1;
  const int kv_end = max(0, min(bound + 1, len));
  const int nk = (kv_end + kBK - 1) / kBK;

  // Each warp group runs its own pipeline over its tiles (kt = grp,
  // grp + kGroups, ...) on a two-stage ring of its own, synchronised by a
  // named barrier of its 128 threads, so one group converts while the other
  // runs its products. Tile kt's codes and scales go into stage i & 1 of the
  // group's ring (i: the group's i-th tile); positions at or past kv_end
  // (and columns past d) are zero-filled and read nothing.
  const int lt = tid % 128;
  const auto group_sync = [&]() {   // immediate ids: ptxas then reserves 3 barriers, not 16
    if (grp == 0) asm volatile("bar.sync 1, 128;\n" ::: "memory");
    else asm volatile("bar.sync 2, 128;\n" ::: "memory");
  };
  // sub-tile j of tile kt into stage sg of the ring
  const auto issue_sub = [&](int sg, int kt, int j) {
    int8_t* rk = ring + sg * TILE;
    const int p0 = kt * kBK + j * kSub;
    const bool live = p0 < kv_end;
    int w0 = 0;
    size_t ph = 0;
    if (live) {
      const int lp = p0 / page;
      w0 = p0 - lp * page;
      ph = static_cast<size_t>(pt[lp]) * hkv + h;
    }
    if (lt == 0) sub_w[sg * NSUB + j] = w0;
#pragma unroll
    for (int it = 0; it < (2 * kSub * CH + 127) / 128; ++it) {
      const int c_i = it * 128 + lt;
      if (c_i < 2 * kSub * CH) {
        const int which = c_i / (kSub * CH), rem = c_i % (kSub * CH);
        const int rr = rem / CH, c = (rem % CH) * 16;
        const int w = w0 + rr;
        const int br = (BITS == 4 && w >= rows_pp) ? w - rows_pp : w;
        const bool ok = live && p0 + rr < kv_end;
        const int8_t* src = (which ? vq : kq) + (ph * rows_pp + br) * dt + c;
        int8_t* dst = rk + which * kBK * D + (j * kSub + rr) * D + c;
        if (fast) {
          const bool in = ok && c < dt;
          qg::cp_async16(qg::smem_addr(dst), in ? src : kq, in ? 16 : 0);
        } else {
          uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int e = 0; e < 16; ++e)
            if (ok && c + e < dt) wd[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(src[e])) << (8 * (e % 4));
          *reinterpret_cast<uint4*>(dst) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
        }
      }
    }
    // the sub-tile's scales, one 4-byte copy per position: 32 threads a sub-tile
    if (lt / (2 * kSub) == j) {
      const int which = (lt % (2 * kSub)) / kSub, rr = lt % kSub;
      const bool ok = live && p0 + rr < kv_end;
      const float* src = (which ? vc : kc) + ph * page + w0 + rr;
      qg::cp_async4(qg::smem_addr(ring_sc + (sg * 2 + which) * kBK + j * kSub + rr),
                    ok ? src : kc, ok ? 4 : 0);
    }
  };
  const auto issue = [&](int i) {
    const int sg = grp * 2 + (i & 1), kt = kGroups * i + grp;
    if constexpr (NSUB <= 8) {
#pragma unroll
      for (int j = 0; j < NSUB; ++j) issue_sub(sg, kt, j);
    } else {   // sub-tiles of 1 position: a loop, not 64 unrolled copies
#pragma unroll 1
      for (int j = 0; j < NSUB; ++j) issue_sub(sg, kt, j);
    }
  };

  // the group's stage i & 1 -> its bf16 K and V tiles and scales / 127
  bf16* Kt = Kb + grp * 2 * kBK * LDB;   // this group's tiles
  bf16* Vt = Kt + kBK * LDB;
  float* kst = ks + grp * 2 * kBK;
  float* vst = kst + kBK;
  const auto convert = [&](int i) {
    const int sg = grp * 2 + (i & 1);
    const int8_t* rk = ring + sg * TILE;
#pragma unroll
    for (int it = 0; it < 2 * kBK * (D / 8) / 128; ++it) {
      const int c_i = it * 128 + lt;
      const int which = c_i / (kBK * (D / 8)), rem = c_i % (kBK * (D / 8));
      const int r = rem / (D / 8), c = (rem % (D / 8)) * 8;
      const uint2 u = *reinterpret_cast<const uint2*>(rk + which * kBK * D + r * D + c);
      bool hi = false;
      if (BITS == 4) hi = sub_w[sg * NSUB + r / kSub] + r % kSub >= rows_pp;
      float f[8];
      qg::kv_codes4<BITS>(u.x, hi, f);
      qg::kv_codes4<BITS>(u.y, hi, f + 4);
      *reinterpret_cast<uint4*>((which ? Vt : Kt) + r * LDB + c) =
          make_uint4(qg::pack_code_bf16(f[0], f[1]), qg::pack_code_bf16(f[2], f[3]),
                     qg::pack_code_bf16(f[4], f[5]), qg::pack_code_bf16(f[6], f[7]));
    }
    if (lt < 2 * kBK) kst[lt] = ring_sc[sg * 2 * kBK + lt] * (1.f / 127.f);   // kc then vc
  };

  const int n_own = (nk - grp + kGroups - 1) / kGroups;   // this group's tiles
  if (n_own > 0) issue(0);
  qg::cp_async_commit();

  // the block's rows, rounded to bf16, staged in Qs (narrow: group 0's K
  // tile, which holds no tile yet: a group converts only after the block
  // barrier below)
  const size_t qb = static_cast<size_t>(bh) * R * D;
  for (int i = tid; i < kBQ * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r0 + r < R) {
      if (q_bf16) qg::load8(static_cast<const bf16*>(q) + qb + static_cast<size_t>(r0 + r) * D + c, v);
      else qg::load8(static_cast<const float*>(q) + qb + static_cast<size_t>(r0 + r) * D + c, v);
    }
    *reinterpret_cast<uint4*>(Qs + r * LDB + c) =
        make_uint4(qg::pack_bf16(v[0], v[1]), qg::pack_bf16(v[2], v[3]),
                   qg::pack_bf16(v[4], v[5]), qg::pack_bf16(v[6], v[7]));
  }
  __syncthreads();
  // ldmatrix row offsets of this lane: A from 16 rows, B from 16 keys
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + (((lane >> 3) & 1) << 3), t_col = (lane >> 4) * 8;
  uint32_t qf[kWide ? 1 : KD][4];   // wide: one k-chunk's, loaded where it is used
  if constexpr (!kWide) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      qg::ldmatrix_x4(qf[kk], qg::smem_addr(Qs + (warp * 16 + a_row) * LDB + kk * 16 + a_col));
  }
  __syncthreads();   // every warp holds its q before group 0 converts over it

  // this thread's two rows and the last position each attends (-1: none);
  // the warp's least and largest of those
  const int qi0 = r0 + warp * 16 + (lane >> 2), qi1 = qi0 + 8;
  const int lim0 = qi0 < R ? min(off + qi0 % C, kv_end - 1) : -1;
  const int lim1 = qi1 < R ? min(off + qi1 % C, kv_end - 1) : -1;
  int wmin = min(lim0, lim1), wmax = max(lim0, lim1);
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    wmin = min(wmin, __shfl_xor_sync(0xffffffffu, wmin, o));
    wmax = max(wmax, __shfl_xor_sync(0xffffffffu, wmax, o));
  }

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < n_own; ++i) {
    if (i + 1 < n_own) issue(i + 1);
    qg::cp_async_commit();
    qg::cp_async_wait<1>();   // this tile has landed
    group_sync();             // ... for the group; its last tile's readers are done
    convert(i);
    group_sync();
    const int kt = kGroups * i + grp, k0 = kt * kBK;
    if (k0 <= wmax) {
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        if (kWide)
          qg::ldmatrix_x4(qf[0], qg::smem_addr(Qs + (warp * 16 + a_row) * LDB + kk * 16 + a_col));
        const uint32_t* qa = qf[kWide ? 0 : kk];
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp) {
          uint32_t bb[4];
          qg::ldmatrix_x4(bb, qg::smem_addr(Kt + (jp * 16 + b_row) * LDB + kk * 16 + b_col));
          qg::mma_bf16(s[2 * jp], qa, bb);
          qg::mma_bf16(s[2 * jp + 1], qa, bb + 2);
        }
      }
      // (s * scale) * kc/127 per column; -inf past a row's last position,
      // only where the tile crosses the warp's diagonal or the length tail
      const bool mask = k0 + kBK - 1 > wmin;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * t + (e & 1);
          float x = (s[j][e] * scale) * kst[col];
          if (mask && k0 + col > (e < 2 ? lim0 : lim1)) x = -INFINITY;
          s[j][e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x);
          else mx1 = fmaxf(mx1, x);
        }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = qg::exp_approx(m0 - mn0), a1 = qg::exp_approx(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      // p = exp(s - m) in f32, summed unrounded. A row whose keys all lie in
      // the first tile (a chunk's first causal rows) is normalized here, as
      // the plain version normalizes before it rounds (p / l, with the
      // full-precision expf), and keeps l = 1: its few O(1) weights would otherwise
      // round to bf16 at another scale than the plain version's.
      const bool n0 = kt == 0 && lim0 >= 0 && lim0 < kBK;
      const bool n1 = kt == 0 && lim1 >= 0 && lim1 < kBK;
      const bool norm = __any_sync(0xffffffffu, n0 || n1);   // warp-uniform
      float ps0 = 0.f, ps1 = 0.f;
      if (norm) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = s[j][e] - (e < 2 ? mn0 : mn1);   // masked: exp(-inf) = 0
            s[j][e] = (e < 2 ? n0 : n1) ? expf(x) : qg::exp_approx(x);
          }
      } else {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = qg::exp_approx(s[j][e] - (e < 2 ? mn0 : mn1));
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        ps0 += s[j][0] + s[j][1];
        ps1 += s[j][2] + s[j][3];
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        ps0 += __shfl_xor_sync(0xffffffffu, ps0, o);
        ps1 += __shfl_xor_sync(0xffffffffu, ps1, o);
      }
      if (norm) {
        const float d0 = n0 ? ps0 : 1.f, d1 = n1 ? ps1 : 1.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          if (n0) s[j][0] /= d0, s[j][1] /= d0;
          if (n1) s[j][2] /= d1, s[j][3] /= d1;
        }
        if (n0) ps0 = 1.f;
        if (n1) ps1 = 1.f;
      }
      // p * vc/127 rounded to bf16 as the A fragments of P V (n-tiles 2c
      // and 2c + 1 are k-chunk c)
      uint32_t pa[NS / 2][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float v0 = vst[j * 8 + 2 * t], v1 = vst[j * 8 + 2 * t + 1];
        pa[j / 2][(j & 1) * 2] = qg::pack_bf16(s[j][0] * v0, s[j][1] * v1);
        pa[j / 2][(j & 1) * 2 + 1] = qg::pack_bf16(s[j][2] * v0, s[j][3] * v1);
      }
      l0 = l0 * a0 + ps0;
      l1 = l1 * a1 + ps1;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j][0] *= a0;
        acc[j][1] *= a0;
        acc[j][2] *= a1;
        acc[j][3] *= a1;
      }
#pragma unroll
      for (int c = 0; c < NS / 2; ++c)
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {
          uint32_t bb[4];
          qg::ldmatrix_x4_trans(bb, qg::smem_addr(Vt + (c * 16 + t_row) * LDB + dp * 16 + t_col));
          qg::mma_bf16(acc[2 * dp], pa[c], bb);
          qg::mma_bf16(acc[2 * dp + 1], pa[c], bb + 2);
        }
    }
  }

  const size_t ob = static_cast<size_t>(bh) * R * D;
  qg::cp_async_wait<0>();
  if constexpr (kGroups == 1) {   // wide: one group's state, normalized and written
    const float l0c = fmaxf(l0, 1e-30f), l1c = fmaxf(l1, 1e-30f);
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = j * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int qi = half ? qi1 : qi0;
        if (qi >= R) continue;
        const float lc = half ? l1c : l0c;
        const float x0 = acc[j][2 * half] / lc, x1 = acc[j][2 * half + 1] / lc;
        const size_t o = ob + static_cast<size_t>(qi) * D + col;
        if (q_bf16)
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + o) = __floats2bfloat162_rn(x0, x1);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(x0, x1);
      }
    }
    return;
  }
  // group 1 hands its state to group 0 through the (idle) ring, element-major
  // so that the 128 threads' stores do not collide; group 0 merges the two
  // (a row only one group saw keeps that group's state exactly) and writes
  constexpr int NE = 4 * NO + 4;
  float* xs = reinterpret_cast<float*>(ring);
  __syncthreads();
  if (grp == 1) {
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[(4 * j + e) * 128 + lt] = acc[j][e];
    xs[(4 * NO) * 128 + lt] = m0;
    xs[(4 * NO + 1) * 128 + lt] = m1;
    xs[(4 * NO + 2) * 128 + lt] = l0;
    xs[(4 * NO + 3) * 128 + lt] = l1;
  }
  static_assert(kGroups == 1 || NE * 128 * sizeof(float) <= 2 * kGroups * TILE,
                "merge state fits the ring");
  __syncthreads();
  if (grp == 1) return;
  const float mb0 = xs[(4 * NO) * 128 + lt], mb1 = xs[(4 * NO + 1) * 128 + lt];
  const float mx0 = fmaxf(m0, mb0), mx1 = fmaxf(m1, mb1);
  const float fa0 = qg::exp_approx(m0 - mx0), fb0 = qg::exp_approx(mb0 - mx0);
  const float fa1 = qg::exp_approx(m1 - mx1), fb1 = qg::exp_approx(mb1 - mx1);
  const float l0c = fmaxf(l0 * fa0 + xs[(4 * NO + 2) * 128 + lt] * fb0, 1e-30f);
  const float l1c = fmaxf(l1 * fa1 + xs[(4 * NO + 3) * 128 + lt] * fb1, 1e-30f);
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int col = j * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = half ? qi1 : qi0;
      if (qi >= R) continue;
      const float fa = half ? fa1 : fa0, fb = half ? fb1 : fb0, lc = half ? l1c : l0c;
      const int e0 = 4 * j + 2 * half;
      const float x0 = (acc[j][2 * half] * fa + xs[e0 * 128 + lt] * fb) / lc;
      const float x1 = (acc[j][2 * half + 1] * fa + xs[(e0 + 1) * 128 + lt] * fb) / lc;
      const size_t o = ob + static_cast<size_t>(qi) * D + col;
      if (q_bf16)
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + o) = __floats2bfloat162_rn(x0, x1);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(x0, x1);
    }
  }
}

template <int BITS, int D, int SUB>
cudaError_t launch(const void* q, const void* kq, const void* kc, const void* vq,
                   const void* vc, const void* pt, const void* len, const void* offs,
                   int offset0, void* out, int q_bf16, int B, int hkv, int C, int R, int page,
                   int pps, int dt, float scale, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<D, SUB>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(paged_context_mma_kernel<BITS, D, SUB>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(((R + kBQ - 1) / kBQ) * B * hkv);
  paged_context_mma_kernel<BITS, D, SUB><<<grid, Tiling<D>::kThreads, smem, s>>>(
      q, static_cast<const int8_t*>(kq), static_cast<const float*>(kc),
      static_cast<const int8_t*>(vq), static_cast<const float*>(vc),
      static_cast<const int*>(pt), static_cast<const int*>(len), static_cast<const int*>(offs),
      offset0, out, q_bf16, hkv, C, R, page, pps, dt, scale);
  return cudaGetLastError();
}


// ------------------------------------------------------------ wide: SIMT, any width
namespace wd = qg::wide;

// A key tile's positions through the page table: each position's code row
// (element offset into a pool), its nibble (int4), and kc / kden and
// vc / 127, or -1 where the position is at or past kv_end.
struct TileKeys {
  long long row[wd::kTile];
  int hi[wd::kTile];
  float ks[wd::kTile], vs[wd::kTile];
};

template <int BITS>
__device__ __forceinline__ float pool_code(const int8_t* pool, long long row, int hi, int c) {
  const int8_t b = pool[row + c];
  if constexpr (BITS == 8) return static_cast<float>(b);
  const int nib = hi ? (static_cast<int>(b) >> 4) : ((static_cast<int>(b) & 15) ^ 8) - 8;
  return static_cast<float>(nib);
}

// the key tile's code rows [kTile][c0, c0 + ncols) of ``pool`` as f32 into
// dst (row stride ld); columns past dt and positions past kv_end are zeros
template <int BITS>
__device__ __forceinline__ void stage_keys(float* dst, int ld, const int8_t* pool,
                                           const TileKeys& tk, int c0, int ncols, int dt) {
  for (int i = threadIdx.x; i < wd::kTile * ncols; i += wd::kThreads) {
    const int r = i / ncols, c = i % ncols;
    const long long row = tk.row[r];
    dst[r * ld + c] = row >= 0 && c0 + c < dt ? pool_code<BITS>(pool, row, tk.hi[r], c0 + c) : 0.f;
  }
}

// grid (row blocks * output chunks * B * Hkv), flattened in that order;
// q [B, Hkv, R, Dp] (zero past d), out likewise, Dp a multiple of 64;
// scale: 127 * sqrt(d), the plain version's divisor of kc.
template <int BITS>
__global__ void __launch_bounds__(wd::kThreads)
paged_context_wide_kernel(const void* __restrict__ q, const int8_t* __restrict__ kq,
                          const float* __restrict__ kc, const int8_t* __restrict__ vq,
                          const float* __restrict__ vc, const int* __restrict__ page_table,
                          const int* __restrict__ lengths, const int* __restrict__ offsets,
                          int offset0, void* __restrict__ out, int q_bf16, int hkv, int C, int R,
                          int page, int pps, int dt, int Dp, float kden) {
  constexpr int kBR = wd::kRows, kBK = wd::kTile, CPT = wd::kOut / 16;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                              // q chunk [64][kLdC]
  float* Bs = As + kBR * wd::kLdC;               // K chunk [32][kLdC]
  float* Ws = Bs + kBK * wd::kLdC;               // scores, then weights [64][kLdS]
  float* Ms = Ws + kBR * wd::kLdS;               // V chunk [32][kLdO]
  float* row_m = Ms + kBK * wd::kLdO;
  float* row_l = row_m + kBR;
  __shared__ TileKeys tk;

  const int nrb = (R + kBR - 1) / kBR, nc = (Dp + wd::kOut - 1) / wd::kOut;
  const int bx = static_cast<int>(blockIdx.x % static_cast<unsigned>(nrb * nc));
  const int bh = static_cast<int>(blockIdx.x / static_cast<unsigned>(nrb * nc));
  const int r0 = (bx % nrb) * kBR, c0 = (bx / nrb) * wd::kOut;
  const int ncols = min(wd::kOut, Dp - c0);
  const int b = bh / hkv, h = bh % hkv;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16, warp = tid / 32, lane = tid % 32;
  const int rows_pp = BITS == 8 ? page : page / 2;
  const int* pt = page_table + static_cast<size_t>(b) * pps;
  const int len = min(lengths[b], pps * page);
  const int off = offsets != nullptr ? offsets[b] : offset0;
  const int r_last = min(r0 + kBR, R) - 1;
  const int bound = (r0 / C == r_last / C) ? off + r_last % C : off + C - 1;
  const int kv_end = max(0, min(bound + 1, len));
  const int nk = (kv_end + kBK - 1) / kBK;
  const size_t qb = static_cast<size_t>(bh) * R * Dp;

  // S for key tile kt into s[4][2] (raw dot products), the tile's keys in tk
  const auto scores = [&](int kt, float s[4][2]) {
    if (tid < kBK) {
      const int p = kt * kBK + tid;
      if (p < kv_end) {
        const int lp = p / page, w = p - lp * page;
        const size_t ph = static_cast<size_t>(pt[lp]) * hkv + h;
        const int hi = BITS == 4 && w >= rows_pp;
        tk.row[tid] = static_cast<long long>(ph * rows_pp + (hi ? w - rows_pp : w)) * dt;
        tk.hi[tid] = hi;
        tk.ks[tid] = kc[ph * page + w] / kden;
        tk.vs[tid] = vc[ph * page + w] * (1.f / 127.f);
      } else {
        tk.row[tid] = -1;
        tk.hi[tid] = 0;
        tk.ks[tid] = tk.vs[tid] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    __syncthreads();
    for (int d0 = 0; d0 < Dp; d0 += wd::kChunk) {
      for (int i = tid; i < kBR * (wd::kChunk / 8); i += wd::kThreads) {   // q, rounded to bf16
        const int rr = i / (wd::kChunk / 8), c = (i % (wd::kChunk / 8)) * 8;
        float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (r0 + rr < R) {
          const size_t o = qb + static_cast<size_t>(r0 + rr) * Dp + d0 + c;
          if (q_bf16) qg::load8(static_cast<const bf16*>(q) + o, v);
          else qg::load8(static_cast<const float*>(q) + o, v);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) As[rr * wd::kLdC + c + e] = qg::bf16_round(v[e]);
      }
      stage_keys<BITS>(Bs, wd::kLdC, kq, tk, d0, wd::kChunk, dt);
      __syncthreads();
      wd::dot_chunk(As, Bs, s);
      __syncthreads();
    }
  };
  const auto live = [&](int rr, int p) {
    return r0 + rr < R && p < kv_end && p <= off + (r0 + rr) % C;
  };

  if (tid < kBR) {
    row_m[tid] = -1e30f;
    row_l[tid] = 0.f;
  }
  // pass 1: each row's max and sum of exp over its keys
  for (int kt = 0; kt < nk; ++kt) {
    float s[4][2];
    scores(kt, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int rr = ty * 4 + i, cc = tx * 2 + j;
        Ws[rr * wd::kLdS + cc] = live(rr, kt * kBK + cc) ? s[i][j] * tk.ks[cc] : -INFINITY;
      }
    __syncthreads();
    for (int k = 0; k < kBR / (wd::kThreads / 32); ++k) {
      const int rr = warp * (kBR / (wd::kThreads / 32)) + k;
      const float sv = Ws[rr * wd::kLdS + lane];
      const float m_prev = row_m[rr];
      const float m_new = fmaxf(m_prev, qg::warp_max(sv));
      const float psum = qg::warp_sum(sv == -INFINITY ? 0.f : expf(sv - m_new));
      if (lane == 0) {
        row_l[rr] = row_l[rr] * expf(m_prev - m_new) + psum;
        row_m[rr] = m_new;
      }
      __syncwarp();
    }
    __syncthreads();
  }

  // pass 2: P V with p = exp(s - m) / l, times vc / 127, rounded to bf16
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    float s[4][2];
    scores(kt, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int rr = ty * 4 + i, cc = tx * 2 + j;
        float w = 0.f;
        if (live(rr, kt * kBK + cc))
          w = qg::bf16_round(expf(s[i][j] * tk.ks[cc] - row_m[rr]) / row_l[rr] * tk.vs[cc]);
        Ws[rr * wd::kLdS + cc] = w;
      }
    stage_keys<BITS>(Ms, wd::kLdO, vq, tk, c0, ncols, dt);
    __syncthreads();
    wd::acc_tile(Ws, Ms, ncols, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = r0 + ty * 4 + i;
    if (rr < R) {
      const size_t o = qb + static_cast<size_t>(rr) * Dp + c0;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        if (16 * j >= ncols) break;
        if (q_bf16) static_cast<bf16*>(out)[o + tx + 16 * j] = __float2bfloat16_rn(acc[i][j]);
        else static_cast<float*>(out)[o + tx + 16 * j] = acc[i][j];
      }
    }
  }
}

template <int BITS>
cudaError_t launch_wide(const void* q, const void* kq, const void* kc, const void* vq,
                        const void* vc, const void* pt, const void* len, const void* offs,
                        int offset0, void* out, int q_bf16, int B, int hkv, int C, int R,
                        int page, int pps, int dt, int Dp, float kden, cudaStream_t s) {
  constexpr size_t smem = wd::smem_bytes();
  const cudaError_t e = cudaFuncSetAttribute(paged_context_wide_kernel<BITS>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const long long blocks = static_cast<long long>((R + wd::kRows - 1) / wd::kRows) *
                           ((Dp + wd::kOut - 1) / wd::kOut) * B * hkv;
  if (!qg::flat_grid_ok(blocks)) return cudaErrorInvalidValue;
  paged_context_wide_kernel<BITS><<<dim3(static_cast<unsigned>(blocks)), wd::kThreads, smem, s>>>(
      q, static_cast<const int8_t*>(kq), static_cast<const float*>(kc),
      static_cast<const int8_t*>(vq), static_cast<const float*>(vc),
      static_cast<const int*>(pt), static_cast<const int*>(len), static_cast<const int*>(offs),
      offset0, out, q_bf16, hkv, C, R, page, pps, dt, Dp, kden);
  return cudaGetLastError();
}

}  // namespace

// q [B, Hkv, R = G*C, D] float32 (dtype 0) or bfloat16 (dtype 1), query
// heads folded into rows, D in {32, 64, 128}, zero past d; kq/vq int8
// [P, Hkv, rows, d], d <= D (rows = page for bits 8, page/2 for bits 4),
// 16-byte aligned; kc/vc f32 [P, Hkv, 1, page]; page_table int32 [B, pps];
// lengths int32 [B]; offsets int32 [B], or null for one offset ``offset0``;
// out [B, Hkv, R, D] in q's dtype. Any page >= 1 (int4: even).
// The plan (``paged_plan.k6_plan``): 64 rows per block, 64-position key
// tiles (32 at D 256), ``smem`` bytes of dynamic shared memory; any other is
// refused.
// Returns cudaGetLastError() (cudaErrorInvalidValue for a plan or shape no
// instantiation takes).
extern "C" int qgemm_paged_context_attention(const void* q, const void* kq, const void* kc,
                                             const void* vq, const void* vc,
                                             const void* page_table, const void* lengths,
                                             const void* offsets, int offset0, void* out,
                                             int dtype, int bits, int B, int hkv, int C, int R,
                                             int D, int d, int page, int pps, float scale,
                                             int block_rows, int key_tile, int smem,
                                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || hkv <= 0 || C <= 0 || R <= 0 || R % C || pps <= 0 || page < 1 ||
      (bits == 4 && page % 2) ||
      !qg::flat_grid_ok(static_cast<long long>((R + kBQ - 1) / kBQ) * B * hkv) || d < 1 ||
      d > D ||
      (dtype != 0 && dtype != 1) || block_rows != kBQ ||
      key_tile != (D > 128 ? Tiling<256>::kBK : Tiling<128>::kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto go = [&](auto fn, size_t want) {
    if (static_cast<size_t>(smem) != want) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(fn(q, kq, kc, vq, vc, page_table, lengths, offsets, offset0, out,
                               dtype, B, hkv, C, R, page, pps, d, scale, s));
  };
#define QG_K6(SUB)                                                                    \
  if (bits == 8 && D == 32) return go(launch<8, 32, SUB>, smem_bytes<32, SUB>());     \
  if (bits == 8 && D == 64) return go(launch<8, 64, SUB>, smem_bytes<64, SUB>());     \
  if (bits == 8 && D == 128) return go(launch<8, 128, SUB>, smem_bytes<128, SUB>());  \
  if (bits == 8 && D == 256) return go(launch<8, 256, SUB>, smem_bytes<256, SUB>());  \
  if (bits == 4 && D == 32) return go(launch<4, 32, SUB>, smem_bytes<32, SUB>());     \
  if (bits == 4 && D == 64) return go(launch<4, 64, SUB>, smem_bytes<64, SUB>());     \
  if (bits == 4 && D == 128) return go(launch<4, 128, SUB>, smem_bytes<128, SUB>());  \
  if (bits == 4 && D == 256) return go(launch<4, 256, SUB>, smem_bytes<256, SUB>());
  if (page % 16 == 0) {
    QG_K6(16)
  } else if (page % 8 == 0) {
    QG_K6(8)
  } else {
    QG_K6(1)
  }
#undef QG_K6
  return static_cast<int>(cudaErrorInvalidValue);
}

// The wide kernel: q [B, Hkv, R, Dp] (dtype 0 f32, 1 bf16; Dp a multiple
// of 64, zero past d), the pools and tables as above at any width d <= Dp,
// out [B, Hkv, R, Dp] in q's dtype; kden = 127 * sqrt(d) in f32 (the plain
// version's divisor of kc); smem the plan's (qg::wide::smem_bytes). Returns
// cudaGetLastError() (cudaErrorInvalidValue for a plan or shape it does not
// take).
extern "C" int qgemm_paged_context_attention_wide(const void* q, const void* kq, const void* kc,
                                                  const void* vq, const void* vc,
                                                  const void* page_table, const void* lengths,
                                                  const void* offsets, int offset0, void* out,
                                                  int dtype, int bits, int B, int hkv, int C,
                                                  int R, int Dp, int d, int page, int pps,
                                                  float kden, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || hkv <= 0 || C <= 0 || R <= 0 || R % C || pps <= 0 || page < 1 ||
      (bits == 4 && page % 2) || d < 1 || d > Dp || Dp % wd::kChunk ||
      (dtype != 0 && dtype != 1) || static_cast<size_t>(smem) != wd::smem_bytes())
    return static_cast<int>(cudaErrorInvalidValue);
  if (bits == 8)
    return static_cast<int>(launch_wide<8>(q, kq, kc, vq, vc, page_table, lengths, offsets,
                                           offset0, out, dtype, B, hkv, C, R, page, pps, d, Dp,
                                           kden, s));
  if (bits == 4)
    return static_cast<int>(launch_wide<4>(q, kq, kc, vq, vc, page_table, lengths, offsets,
                                           offset0, out, dtype, B, hkv, C, R, page, pps, d, Dp,
                                           kden, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
