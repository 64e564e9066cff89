// Kernel K3: blockwise (flash) attention forward, causal or not, for Hopper
// (sm_90a). Returns O and the per-row logsumexp.
//
// Replaces _flash_kernel / _flash_attention_fwd_impl of
// qgemm_tpu/ops/pallas/flash_attention.py (pallas_call at :193). Same math
// and rounding points: s = (q . k) * (1/sqrt(D)) with products exact in f32
// (bf16 x bf16, or f32 x f32 on the f32 route) and f32 sums, s * scale
// rounded; masked entries (k >= Sk, and k > q when causal; no offset when
// Sq != Sk) get p = 0, and the row max starts at -1e30; p = exp(s - m) in
// f32 and l sums the unrounded p; P is cast to V's dtype before the second
// product; O = acc / max(l, 1e-30); lse = m + log(max(l, 1e-30)).
//
// What bounds it on the H100: the operations at training lengths and
// nearly so at prefill. Two products of 2 * D flops per attended (query,
// key) pair against 4 * S * D input and output elements per head: at
// S 2048, D 128, causal, ~1,000 flops per byte, far above the bf16 ridge
// (~295); at S 512 the byte bound is the larger, by less than 2x.
//
// Two routes, chosen by the wrapper's launch plan (flash_fwd_plan in
// ops/cuda/flash_attention.py), which passes the route and the dynamic
// shared memory; the entry refuses a plan that does not match a compiled
// instantiation.
//
//  * bf16, the "mma" route (FlashAttention-2 on mma.sync): one block of 4
//    warps per (64 query rows, batch*head), the last query blocks (the most
//    keys when causal) first; each warp owns 16 query rows. Q is copied
//    once and its A fragments held in registers (ldmatrix). K and V stream
//    through a two-stage ring of 64-key tiles in shared memory, kept in
//    bf16, by 16-byte cp.async; the next tile's copies are issued before
//    this tile's products. Rows are padded by 16 B so that ldmatrix's eight
//    row addresses fall on distinct banks. S = Q K^T runs on mma.sync
//    m16n8k16 bf16 -> f32 (K's B fragments by ldmatrix); the online softmax
//    runs on the accumulator fragments, a row's max and sum reduced over
//    its quad by __shfl_xor_sync; alpha rescales the O accumulator in
//    registers; P, rounded to bf16, is the A operand of P V directly (V's
//    B fragments by ldmatrix.trans). Neither S nor P touches shared memory.
//    The softmax is what the tensor cores wait on, so exp is one ex2.approx
//    of (s - m) * log2 e (qg::exp_approx, ~2 ulp; exp(-inf) = 0 gives the
//    masked p), and only tiles that hold the Sk tail or cross the causal
//    diagonal compute a mask. Causal: tiles above the block's last row are
//    never loaded, and a warp whose 16 rows precede a tile skips it (its p
//    would all be 0, alpha 1). 64-row blocks beat 128-row blocks of 8 warps
//    at S 512 and at S 2048 on the H100 (PERF.md §6).
//  * f32, the "simt" route: the first design, unchanged. The tensor cores
//    take f32 only as TF32 (a 10-bit mantissa), which would break the
//    port's f32 parity (1e-5 * max; JAX computes f32 products in f32 here
//    too). One block of 256 threads per (64 query rows, batch*head); Q is
//    staged once, K and V stream through shared memory in 32-row tiles;
//    each thread owns a 4 x 2 patch of the score tile and a 4 x (D/16)
//    patch of O, and one warp per 8 rows runs the online softmax with
//    expf. It serves the copy-task trainer (GPTConfig's default dtype is
//    float32) and the f32 parity cases.
//
// Scores never reach device memory: O(S * D) traffic on both routes.
//
// Head widths: compiled for D in {32, 64, 128, 256} with Dv == D. The
// wrapper zero-pads q, k and v (per-call tensors) to the D that holds both
// the true d and dv, passes the softmax scale of the true d, and slices O
// to dv: zero columns add nothing to a score, and O's padded columns are 0.
// D 256 on the mma route takes fewer keys a tile and no Q in registers: a
// warp's 16 rows of O are 128 f32 registers a thread there, and Q's A
// fragments (64 more) with a 64-key tile's S and P (48) would pass the 255
// cap, so Q's fragments are loaded from shared memory per k-chunk (ldmatrix)
// and K/V tiles hold 32 keys (S and P 24 registers); shared memory 99 KB a
// block, two blocks an SM (FlashAttention-2's hdim-256 forward also takes
// smaller tiles). The f32 route takes D 256 as it is (O 64 registers, 139
// KB of shared memory).
//
// Past 256 (either width), both dtypes take the "wide" route
// (flash_fwd_wide_kernel, flash_wide.cuh): widths are runtime multiples of
// 64 (the wrapper pads q and k to one, v to another, so d and dv may
// differ), S accumulates over d in 64-column chunks staged in shared
// memory, and Dv runs in chunks of 256 columns, one block per chunk, each
// recomputing S. f32 FMAs on the CUDA cores; bf16 rounds P as the mma
// route does. Slow, and right; it takes any width.
//
// Grids are one dimension, (query tile[, Dv chunk], batch*head) with the
// query tile fastest, so batch*heads may pass 65,535.
#include <type_traits>

#include "common.cuh"
#include "flash_wide.cuh"
#include "mma.cuh"

namespace {

// ------------------------------------------------------------ f32: SIMT
constexpr int kBQ = 64, kBK = 32, kThreads = 256;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

template <int D> __host__ __device__ constexpr int ld() { return D + 4; }  // f32 row stride, 16 B aligned
template <int D> constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ) * ld<D>() + 2 * kBK * ld<D>() +
                          kBQ * (kBK + 1) + 3 * kBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                 int sq, int sk, int causal, float scale) {
  constexpr bool kRound = !std::is_same<T, float>::value;  // P cast to V's dtype
  constexpr int LD = ld<D>();
  constexpr int CPT = D / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;
  float* row_m = Ps + kBQ * (kBK + 1);
  float* row_l = row_m + kBQ;
  float* row_a = row_l + kBQ;

  const qg::FlatIdx blk = qg::flat_block((sq + kBQ - 1) / kBQ);   // (query tile, batch*head)
  const int bh = blk.o, q0 = blk.i * kBQ, tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const T* qb = q + static_cast<size_t>(bh) * sq * D;
  const T* kb = k + static_cast<size_t>(bh) * sk * D;
  const T* vb = v + static_cast<size_t>(bh) * sk * D;

  for (int i = tid; i < kBQ * (D / 8); i += kThreads) {
    const int r = i / (D / 8), d = (i % (D / 8)) * 8;
    float vals[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (q0 + r < sq) qg::load8(qb + static_cast<size_t>(q0 + r) * D + d, vals);
#pragma unroll
    for (int e = 0; e < 8; ++e) Qs[r * LD + d + e] = vals[e];
  }
  if (tid < kBQ) {
    row_m[tid] = -1e30f;
    row_l[tid] = 0.f;
  }
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  int nk = (sk + kBK - 1) / kBK;
  if (causal) nk = min(nk, (min(q0 + kBQ, sq) - 1) / kBK + 1);
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    for (int i = tid; i < kBK * (D / 8); i += kThreads) {
      const int r = i / (D / 8), d = (i % (D / 8)) * 8;
      float kv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float vv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k0 + r < sk) {
        qg::load8(kb + static_cast<size_t>(k0 + r) * D + d, kv);
        qg::load8(vb + static_cast<size_t>(k0 + r) * D + d, vv);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        Ks[r * LD + d + e] = kv[e];
        Vs[r * LD + d + e] = vv[e];
      }
    }
    __syncthreads();

    // S = Q K^T on a 4 x 2 patch: rows ty*4+i, cols tx*2+j
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx * 2 + j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty * 4 + i, c = tx * 2 + j;
        const int gq = q0 + r, gk = k0 + c;
        const bool ok = gk < sk && (!causal || gk <= gq);
        Ps[r * (kBK + 1) + c] = ok ? s[i][j] * scale : neg_inf();
      }
    __syncthreads();

    // online softmax: warp w owns rows 8w..8w+7, lane = column
    for (int rr = 0; rr < kBQ / (kThreads / 32); ++rr) {
      const int r = warp * (kBQ / (kThreads / 32)) + rr;
      const float sv = Ps[r * (kBK + 1) + lane];
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, qg::warp_max(sv));
      const float p = sv == neg_inf() ? 0.f : expf(sv - m_new);
      const float alpha = expf(m_prev - m_new);
      const float psum = qg::warp_sum(p);
      Ps[r * (kBK + 1) + lane] = kRound ? qg::bf16_round(p) : p;
      __syncwarp();
      if (lane == 0) {
        row_m[r] = m_new;
        row_l[r] = row_l[r] * alpha + psum;
        row_a[r] = alpha;
      }
      __syncwarp();
    }
    __syncthreads();

    // O = O * alpha + P V on rows ty*4+i, cols tx + 16*j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = row_a[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= a;
    }
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float vv = Vs[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, gq = q0 + r;
    if (gq < sq) {
      const float l = fmaxf(row_l[r], 1e-30f);
      T* orow = o + (static_cast<size_t>(bh) * sq + gq) * D;
#pragma unroll
      for (int j = 0; j < CPT; ++j) orow[tx + 16 * j] = qg::from_f32<T>(acc[i][j] / l);
      if (tx == 0) lse[static_cast<size_t>(bh) * sq + gq] = row_m[r] + logf(l);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int bh, int sq, int sk, int causal, float scale, cudaStream_t s) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(((sq + kBQ - 1) / kBQ) * bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, sq, sk, causal, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------ bf16: mma.sync
using bf16 = __nv_bfloat16;
constexpr int kTileK = 64;   // keys per K/V tile

template <int D> __host__ __device__ constexpr int mma_ld() { return D + 8; }  // bf16 row stride (+16 B)
constexpr int kMmaBQ = 64, kMmaWarps = 4;   // 4 warps of 16 query rows
// the mma route's tiling at width D: keys per K/V tile, and whether a warp
// holds Q's A fragments in registers (D 256: 32 keys, Q read per k-chunk)
template <int D> __host__ __device__ constexpr int mma_tile_k() { return D > 128 ? 32 : kTileK; }
template <int D> __host__ __device__ constexpr bool mma_q_regs() { return D <= 128; }
template <int D> constexpr size_t mma_smem_bytes() {
  // Q, then two stages of K and V tiles
  return sizeof(bf16) * static_cast<size_t>(mma_ld<D>()) * (kMmaBQ + 4 * mma_tile_k<D>());
}

// cp.async of rows r0 .. r0 + ROWS - 1 of a [n, D] bf16 matrix into a
// shared tile of row stride mma_ld<D>(); rows at or past n are zero-filled.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* src, int r0, int n) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  static_assert((ROWS * CH) % NT == 0, "tile copy must divide evenly over the block");
#pragma unroll
  for (int it = 0; it < ROWS * CH / NT; ++it) {
    const int i = it * NT + static_cast<int>(threadIdx.x);
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r0 + r < n;
    qg::cp_async16(qg::smem_addr(dst + r * mma_ld<D>() + c),
                   src + static_cast<size_t>(ok ? r0 + r : 0) * D + c, ok ? 16 : 0);
  }
}

// s *= scale over a warp's 16 x (8 * NS) score fragments (columns from
// key0 = the tile's first key + 2t); with MASK, keys at or past sk, or past
// the row when causal, become -inf. mx0 / mx1: this thread's maxima of rows
// qi0 and qi1.
template <bool MASK, int NS>
__device__ __forceinline__ void scale_scores(float (&s)[NS][4], float scale, int key0, int qi0,
                                             int qi1, int sk, int causal, float& mx0,
                                             float& mx1) {
  mx0 = mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * scale;
      if (MASK) {
        const int key = key0 + j * 8 + (e & 1), qi = e < 2 ? qi0 : qi1;
        if (!(key < sk && (!causal || key <= qi))) x = -INFINITY;
      }
      s[j][e] = x;
      if (e < 2) mx0 = fmaxf(mx0, x);
      else mx1 = fmaxf(mx1, x);
    }
}

template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int sq, int sk, int causal, float scale) {
  constexpr int BQ = kMmaBQ, NT = kMmaWarps * 32, LD = mma_ld<D>();
  constexpr int TK = mma_tile_k<D>();   // keys per K/V tile
  constexpr bool QREG = mma_q_regs<D>();
  constexpr int KD = D / 16;       // k16 chunks of the head width
  constexpr int NS = TK / 8;       // n8 tiles of a warp's scores
  constexpr int NO = D / 8;        // n8 tiles of a warp's output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * LD;          // [2][TK][LD]
  bf16* Vs = Ks + 2 * TK * LD;      // [2][TK][LD]

  // the last query blocks, which attend the most keys when causal, first
  const int nqt = (sq + BQ - 1) / BQ;
  const qg::FlatIdx blk = qg::flat_block(nqt);   // (query tile, batch*head)
  const int bh = blk.o, q0 = (nqt - 1 - blk.i) * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int w0 = q0 + warp * 16;                 // the warp's first query row
  const int qi0 = w0 + (lane >> 2), qi1 = qi0 + 8;  // this thread's two rows
  const bf16* qb = q + static_cast<size_t>(bh) * sq * D;
  const bf16* kb = k + static_cast<size_t>(bh) * sk * D;
  const bf16* vb = v + static_cast<size_t>(bh) * sk * D;

  int nk = (sk + TK - 1) / TK;
  if (causal) nk = min(nk, (min(q0 + BQ, sq) - 1) / TK + 1);

  cp_tile<D, BQ, NT>(Qs, qb, q0, sq);
  cp_tile<D, TK, NT>(Ks, kb, 0, sk);
  cp_tile<D, TK, NT>(Vs, vb, 0, sk);
  qg::cp_async_commit();

  uint32_t qf[QREG ? KD : 1][4];   // D 256: one k-chunk's, loaded where it is used
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;
  // ldmatrix row offsets of this lane: A from 16 rows, B from 16 keys
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + (((lane >> 3) & 1) << 3), t_col = (lane >> 4) * 8;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1, k0 = kt * TK;
    if (kt + 1 < nk) {
      cp_tile<D, TK, NT>(Ks + (st ^ 1) * TK * LD, kb, k0 + TK, sk);
      cp_tile<D, TK, NT>(Vs + (st ^ 1) * TK * LD, vb, k0 + TK, sk);
    }
    qg::cp_async_commit();
    qg::cp_async_wait<1>();   // this tile (and Q) have landed
    __syncthreads();
    if constexpr (QREG) {
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          qg::ldmatrix_x4(qf[kk], qg::smem_addr(Qs + (warp * 16 + a_row) * LD + kk * 16 + a_col));
      }
    }
    // a warp whose rows all precede the tile (causal) or lie past Sq skips it
    if (w0 < sq && !(causal && w0 + 15 < k0)) {
      const bf16* Kt = Ks + st * TK * LD;
      const bf16* Vt = Vs + st * TK * LD;
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        if (!QREG)
          qg::ldmatrix_x4(qf[0], qg::smem_addr(Qs + (warp * 16 + a_row) * LD + kk * 16 + a_col));
        const uint32_t* qa = qf[QREG ? kk : 0];
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp) {
          uint32_t b[4];
          qg::ldmatrix_x4(b, qg::smem_addr(Kt + (jp * 16 + b_row) * LD + kk * 16 + b_col));
          qg::mma_bf16(s[2 * jp], qa, b);
          qg::mma_bf16(s[2 * jp + 1], qa, b + 2);
        }
      }
      // scale, and mask where the tile holds the Sk tail or crosses the
      // diagonal; the rows' maxima over the quad
      float mx0, mx1;
      if (k0 + TK > sk || (causal && k0 + TK - 1 > w0))
        scale_scores<true>(s, scale, k0 + 2 * t, qi0, qi1, sk, causal, mx0, mx1);
      else
        scale_scores<false>(s, scale, k0 + 2 * t, qi0, qi1, sk, causal, mx0, mx1);
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = qg::exp_approx(m0 - mn0), a1 = qg::exp_approx(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      // p = exp(s - m) in f32, summed unrounded; P rounded to bf16 as the
      // A fragments of P V (n-tiles 2c and 2c + 1 are k-chunk c)
      uint32_t pa[NS / 2][4];
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = qg::exp_approx(s[j][e] - (e < 2 ? mn0 : mn1));   // masked: exp(-inf) = 0
        ps0 += p[0] + p[1];
        ps1 += p[2] + p[3];
        pa[j / 2][(j & 1) * 2] = qg::pack_bf16(p[0], p[1]);
        pa[j / 2][(j & 1) * 2 + 1] = qg::pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        ps0 += __shfl_xor_sync(0xffffffffu, ps0, off);
        ps1 += __shfl_xor_sync(0xffffffffu, ps1, off);
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
          uint32_t b[4];
          qg::ldmatrix_x4_trans(b, qg::smem_addr(Vt + (c * 16 + t_row) * LD + dp * 16 + t_col));
          qg::mma_bf16(acc[2 * dp], pa[c], b);
          qg::mma_bf16(acc[2 * dp + 1], pa[c], b + 2);
        }
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
  }

  const float l0c = fmaxf(l0, 1e-30f), l1c = fmaxf(l1, 1e-30f);
  bf16* ob = o + static_cast<size_t>(bh) * sq * D;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int col = j * 8 + 2 * t;
    if (qi0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(qi0) * D + col) =
          __floats2bfloat162_rn(acc[j][0] / l0c, acc[j][1] / l0c);
    if (qi1 < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(qi1) * D + col) =
          __floats2bfloat162_rn(acc[j][2] / l1c, acc[j][3] / l1c);
  }
  if (t == 0) {
    if (qi0 < sq) lse[static_cast<size_t>(bh) * sq + qi0] = m0 + logf(l0c);
    if (qi1 < sq) lse[static_cast<size_t>(bh) * sq + qi1] = m1 + logf(l1c);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* lse,
                       int bh, int sq, int sk, int causal, float scale, int smem,
                       cudaStream_t s) {
  constexpr size_t want = mma_smem_bytes<D>();
  if (static_cast<size_t>(smem) != want) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_mma_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(want));
  if (e != cudaSuccess) return e;
  const dim3 grid(((sq + kMmaBQ - 1) / kMmaBQ) * bh);
  flash_fwd_mma_kernel<D><<<grid, kMmaWarps * 32, want, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, sq, sk, causal, scale);
  return cudaGetLastError();
}


// ------------------------------------------------------------ wide: SIMT, any width
namespace wd = qg::wide;

// grid (query tiles * Dv chunks * BH), flattened in that order; q, k [BH,
// S, dqk], v [BH, Sk, dvp], o [BH, Sq, dvp] (dqk, dvp multiples of 64);
// lse [BH, Sq] written by the first chunk's blocks.
template <typename T>
__global__ void __launch_bounds__(wd::kThreads)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ o, float* __restrict__ lse, int sq, int sk, int dqk,
                      int dvp, int causal, float scale) {
  constexpr bool kRound = !std::is_same<T, float>::value;  // P cast to V's dtype
  constexpr int kBQ = wd::kRows, kBK = wd::kTile, CPT = wd::kOut / 16;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = As + kBQ * wd::kLdC;
  float* Ps = Bs + kBK * wd::kLdC;
  float* Vs = Ps + kBQ * wd::kLdS;
  float* row_m = Vs + kBK * wd::kLdO;
  float* row_l = row_m + kBQ;
  float* row_a = row_l + kBQ;

  const int nqt = (sq + kBQ - 1) / kBQ, nvc = (dvp + wd::kOut - 1) / wd::kOut;
  const int bx = static_cast<int>(blockIdx.x % static_cast<unsigned>(nqt * nvc));
  const int bh = static_cast<int>(blockIdx.x / static_cast<unsigned>(nqt * nvc));
  const int q0 = (bx % nqt) * kBQ, vc = bx / nqt;
  const int c0 = vc * wd::kOut, ncols = min(wd::kOut, dvp - c0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const T* qb = q + static_cast<size_t>(bh) * sq * dqk;
  const T* kb = k + static_cast<size_t>(bh) * sk * dqk;
  const T* vb = v + static_cast<size_t>(bh) * sk * dvp;

  if (tid < kBQ) {
    row_m[tid] = -1e30f;
    row_l[tid] = 0.f;
  }
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  int nk = (sk + kBK - 1) / kBK;
  if (causal) nk = min(nk, (min(q0 + kBQ, sq) - 1) / kBK + 1);
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    float s[4][2];
    wd::dot_tile(qb, q0, sq, kb, k0, sk, dqk, As, Bs, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty * 4 + i, c = tx * 2 + j;
        const int gq = q0 + r, gk = k0 + c;
        const bool ok = gk < sk && (!causal || gk <= gq);
        Ps[r * wd::kLdS + c] = ok ? s[i][j] * scale : neg_inf();
      }
    wd::stage<T, kBK>(Vs, wd::kLdO, vb, dvp, k0, sk, c0, ncols);
    __syncthreads();

    // online softmax: warp w owns rows 8w..8w+7, lane = column
    for (int rr = 0; rr < kBQ / (wd::kThreads / 32); ++rr) {
      const int r = warp * (kBQ / (wd::kThreads / 32)) + rr;
      const float sv = Ps[r * wd::kLdS + lane];
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, qg::warp_max(sv));
      const float p = sv == neg_inf() ? 0.f : expf(sv - m_new);
      const float alpha = expf(m_prev - m_new);
      const float psum = qg::warp_sum(p);
      Ps[r * wd::kLdS + lane] = kRound ? qg::bf16_round(p) : p;
      __syncwarp();
      if (lane == 0) {
        row_m[r] = m_new;
        row_l[r] = row_l[r] * alpha + psum;
        row_a[r] = alpha;
      }
      __syncwarp();
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = row_a[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= a;
    }
    wd::acc_tile(Ps, Vs, ncols, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, gq = q0 + r;
    if (gq < sq) {
      const float l = fmaxf(row_l[r], 1e-30f);
      T* orow = o + (static_cast<size_t>(bh) * sq + gq) * dvp + c0;
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        if (16 * j < ncols) orow[tx + 16 * j] = qg::from_f32<T>(acc[i][j] / l);
      if (tx == 0 && vc == 0) lse[static_cast<size_t>(bh) * sq + gq] = row_m[r] + logf(l);
    }
  }
}

template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o, float* lse,
                        int bh, int sq, int sk, int dqk, int dvp, int causal, float scale,
                        cudaStream_t s) {
  constexpr size_t smem = wd::smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_wide_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const long long blocks = static_cast<long long>((sq + wd::kRows - 1) / wd::kRows) *
                           ((dvp + wd::kOut - 1) / wd::kOut) * bh;
  if (!qg::flat_grid_ok(blocks)) return cudaErrorInvalidValue;
  flash_fwd_wide_kernel<T><<<dim3(static_cast<unsigned>(blocks)), wd::kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, sq, sk, dqk, dvp, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q [BH, Sq, D], k/v [BH, Sk, D], o [BH, Sq, D], D in {32, 64, 128, 256}; lse f32
// [BH, Sq]. The launch plan: route 0 (SIMT) takes dtype 0 (f32), route 1
// (mma) dtype 1 (bf16), both 64 query rows per block; smem is the plan's
// dynamic shared memory, checked against the
// instantiation's. Returns cudaGetLastError() (cudaErrorInvalidValue for a
// plan or shape no instantiation takes).
extern "C" int qgemm_flash_attention_fwd(const void* q, const void* k, const void* v,
                                         void* o, void* lse, int dtype, int bh, int sq,
                                         int sk, int D, int causal, float scale, int route,
                                         int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || sq <= 0 || sk <= 0 ||
      !qg::flat_grid_ok(static_cast<long long>((sq + 63) / 64) * bh))
    return static_cast<int>(cudaErrorInvalidValue);
  float* l = static_cast<float*>(lse);
  if (route == 0 && dtype == 0) {
    if (D == 32 && static_cast<size_t>(smem) == smem_bytes<32>())
      return launch<float, 32>(q, k, v, o, l, bh, sq, sk, causal, scale, s);
    if (D == 64 && static_cast<size_t>(smem) == smem_bytes<64>())
      return launch<float, 64>(q, k, v, o, l, bh, sq, sk, causal, scale, s);
    if (D == 128 && static_cast<size_t>(smem) == smem_bytes<128>())
      return launch<float, 128>(q, k, v, o, l, bh, sq, sk, causal, scale, s);
    if (D == 256 && static_cast<size_t>(smem) == smem_bytes<256>())
      return launch<float, 256>(q, k, v, o, l, bh, sq, sk, causal, scale, s);
  }
  if (route == 1 && dtype == 1) {
    if (D == 32) return launch_mma<32>(q, k, v, o, l, bh, sq, sk, causal, scale, smem, s);
    if (D == 64) return launch_mma<64>(q, k, v, o, l, bh, sq, sk, causal, scale, smem, s);
    if (D == 128) return launch_mma<128>(q, k, v, o, l, bh, sq, sk, causal, scale, smem, s);
    if (D == 256) return launch_mma<256>(q, k, v, o, l, bh, sq, sk, causal, scale, smem, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The wide route: q, k [BH, Sq or Sk, dqk], v [BH, Sk, dvp], o [BH, Sq,
// dvp] in f32 (dtype 0) or bf16 (dtype 1), dqk and dvp multiples of 64 (any
// size); lse f32 [BH, Sq]; smem the plan's (qg::wide::smem_bytes).
// Returns cudaGetLastError() (cudaErrorInvalidValue for a plan or shape it
// does not take).
extern "C" int qgemm_flash_attention_fwd_wide(const void* q, const void* k, const void* v,
                                              void* o, void* lse, int dtype, int bh, int sq,
                                              int sk, int dqk, int dvp, int causal, float scale,
                                              int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || sq <= 0 || sk <= 0 || dqk <= 0 || dvp <= 0 || dqk % wd::kChunk ||
      dvp % wd::kChunk || static_cast<size_t>(smem) != wd::smem_bytes())
    return static_cast<int>(cudaErrorInvalidValue);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return static_cast<int>(launch_wide<float>(q, k, v, o, l, bh, sq, sk, dqk, dvp, causal, scale, s));
  if (dtype == 1)
    return static_cast<int>(launch_wide<bf16>(q, k, v, o, l, bh, sq, sk, dqk, dvp, causal, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
