// Kernel K7: blockwise (FlashAttention-2) attention backward, causal or not,
// for Hopper (sm_90a). From q, k, v, the forward's O and per-row logsumexp,
// and dO, it computes dQ, dK and dV.
//
// Replaces _flash_attention_bwd_impl (_flash_bwd_dq_kernel,
// _flash_bwd_dkv_kernel, _mask_and_p; pallas_calls at :372 and :399) of
// qgemm_tpu/ops/pallas/flash_attention.py. Same math and rounding points:
// delta = rowsum(dO * O) in f32; P = exp(s * scale - lse) recomputed with
// the forward's masks (keys >= Sk, query rows >= Sq, and k > q when causal
// get p = 0), s * scale rounded before the subtraction; dP = dO V^T in f32;
// dS = P * (dP - delta) * scale in f32, cast to the input dtype before
// dQ += dS K and dK += dS^T Q; P cast to dO's dtype before dV += P^T dO.
// Products take input-dtype values and sum in f32.
//
// What bounds it on the H100: the operations. Five products of 2 * D flops
// per attended (query, key) pair (S recomputed, dP, dV, dQ, dK; about half
// of the pairs when causal) against 8 * S * D input and output elements per
// head: at training lengths (S = 2048, D = 128) far above the bf16 ridge.
// This kernel does 7 products per pair, not 5: the dQ kernel recomputes S
// and dP, which the dK/dV kernel computes too. That buys one writer per
// output element and no atomics, so the result does not depend on
// scheduling; the bound counts 5, and at best the kernel reaches 5/7 of it.
//
// Three launches on the caller's stream, chosen by the wrapper's launch
// plan (flash_bwd_plan in ops/cuda/flash_attention_bwd.py), which passes
// the route and both kernels' dynamic shared memory; the entry refuses a
// plan that does not match a compiled instantiation:
//   * delta_kernel: one warp per query row, delta = rowsum(dO * O) (about
//     3 % of the backward at the training shape);
//   * the dQ kernel: one block per (64 query rows, batch*head), K and V
//     streamed up to the causal limit, the last query blocks first;
//   * the dK/dV kernel: one block per (64 key rows, batch*head), Q, dO, lse
//     and delta streamed from the first query tile that can attend the
//     block's keys (the first key blocks, which the most queries attend,
//     come first in the grid).
//
//  * bf16, the "mma" route (FlashAttention-2 backward on mma.sync), 4 warps
//    of 16 rows per block. dQ kernel: Q's and dO's A fragments are held in
//    registers (ldmatrix); K and V tiles of 64 keys stream through a
//    two-stage ring in shared memory, kept in bf16, by 16-byte cp.async,
//    the next tile's copies issued before this tile's products; per half
//    tile of 32 keys S = Q K^T and dP = dO V^T run on mma.sync m16n8k16 into
//    registers, dS is formed there and, rounded to bf16, is the A operand of
//    dQ += dS K (K's B fragments by ldmatrix.trans). dK/dV kernel: K's and
//    V's A fragments in registers (with both f32 accumulators, ~230-255
//    registers a thread at D 128 and no spills); Q and dO tiles of 64
//    queries and their lse and delta stream through the ring; per 16
//    queries S^T = K Q^T and dP^T = V dO^T on mma.sync, P^T and dS^T in
//    registers, then dV += bf16(P^T) dO and dK += bf16(dS^T) Q from the
//    register A operands (dO's and Q's B fragments by ldmatrix.trans).
//    Rows are padded by 16 B so that ldmatrix's row addresses fall on
//    distinct banks. Nothing of S, P, dP or dS touches shared memory. A
//    warp skips the pieces that the causal mask or Sq / Sk empty; only
//    pieces on the diagonal or a ragged edge compute a mask, and exp is
//    one ex2.approx (qg::exp_approx), as in K3.
//  * f32, the "simt" route: the first design, unchanged. The tensor cores
//    take f32 only as TF32 (a 10-bit mantissa), which would break the
//    port's f32 parity (1e-5 * max; JAX computes f32 products in f32 here
//    too); it serves the copy-task trainer (GPTConfig's default dtype is
//    float32) and the f32 parity cases. 256 threads per block; each thread
//    owns a 4 x 2 patch of a 64 x 32 score tile and 4 x (D/16) patches of
//    the outputs; operands are staged as f32 (K3's SIMT layout), and P and
//    dS go through shared memory.
//
// Head widths: compiled for D in {32, 64, 128, 256} with Dv == D; the
// wrapper zero-pads q, k, v, O and dO to one such D and slices dQ, dK and
// dV to the true widths (the padded columns of every product are zeros).
//
// D 256 on the mma route: a thread's f32 accumulator of 16 rows x 256
// columns is 128 registers, so the D <= 128 designs (the dQ kernel's Q and
// dO fragments in registers, 128 more; the dK/dV kernel's K and V
// fragments and two accumulators, 384) would pass the 255 cap. There the
// dQ kernel reads Q's and dO's fragments from shared memory per k-chunk,
// and the dK/dV work runs as two blocks per 64 keys (grid z: 0 computes
// dV from S, 1 computes dK from S and dP), each with one accumulator and
// K's and V's fragments read from shared memory (flash_bwd_dkv_wide_kernel):
// 8 products per attended pair, not 7. Shared memory stays the D <= 128
// layout: ~198 KB a block at D 256, one block an SM. The f32 route takes D
// 256 as it is (204 and 212 KB).
//
// Past 256 (either width), both dtypes take the "wide" route
// (flash_bwd_wide_kernel, flash_wide.cuh; K3's wide route's layout): widths
// are runtime multiples of 64, the wrapper pads q, k, dQ and dK to one, v,
// O, dO and dV to another. Four launches: delta over the runtime width,
// then one kernel three times, for dQ (blocks of 64 query rows), dK and dV
// (blocks of 64 key rows), each block one 256-column chunk of its output,
// recomputing S (and, for dQ and dK, dP) over the widths in 64-column
// chunks staged in shared memory. The same rounding points as the f32 and
// mma routes. Slow, and right; it takes any width.
//
// Grids are one dimension, (row tile[, column chunk], batch*head) with the
// row tile fastest (the mma route's dK/dV grid keeps z for its two blocks
// at D 256), so batch*heads may pass 65,535.
#include <type_traits>

#include "common.cuh"
#include "flash_wide.cuh"
#include "mma.cuh"

namespace {

// ------------------------------------------------------------ f32: SIMT

constexpr int kBR = 64, kBC = 32, kThreads = 256;

template <int D> __host__ __device__ constexpr int ld() { return D + 4; }  // f32 row stride, 16 B aligned

template <int D> constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * static_cast<size_t>(kBR) * ld<D>() + 2 * kBC * ld<D>() +
                          kBR * (kBC + 1) + 2 * kBR);
}
template <int D> constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * static_cast<size_t>(kBR) * ld<D>() + 2 * kBC * ld<D>() +
                          2 * kBR * (kBC + 1) + 2 * kBC);
}

// Copy rows r0 .. r0 + ROWS - 1 of a [n, D] matrix into f32 shared memory
// (row stride ld<D>()); rows at or past n are zeros.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0, int n) {
  constexpr int LD = ld<D>();
  for (int i = threadIdx.x; i < ROWS * (D / 8); i += kThreads) {
    const int r = i / (D / 8), d = (i % (D / 8)) * 8;
    float vals[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r0 + r < n) qg::load8(src + static_cast<size_t>(r0 + r) * D + d, vals);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[r * LD + d + e] = vals[e];
  }
}

// out[i][j] = A[ty*4 + i] . B[tx*2 + j] over D (rows of two staged tiles).
template <int D>
__device__ __forceinline__ void dot_patch(const float* A, const float* B, int ty, int tx,
                                          float out[4][2]) {
  constexpr int LD = ld<D>();
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i][0] = out[i][1] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(&A[(ty * 4 + i) * LD + d]);
#pragma unroll
    for (int j = 0; j < 2; ++j) b[j] = *reinterpret_cast<const float4*>(&B[(tx * 2 + j) * LD + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float s = out[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        out[i][j] = s;
      }
  }
}

// The probability of one (query, key) pair from its raw score and the row's
// lse; s * scale is rounded before the subtraction, as the forward does.
__device__ __forceinline__ float prob(bool ok, float s, float scale, float lse) {
  return ok ? expf(__fmul_rn(s, scale) - lse) : 0.f;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             long long rows) {
  const long long row = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* orow = o + static_cast<size_t>(row) * D;
  const T* grow = dout + static_cast<size_t>(row) * D;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc = fmaf(qg::to_f32(grow[d]), qg::to_f32(orow[d]), acc);
  acc = qg::warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int sq, int sk, int causal, float scale) {
  constexpr bool kRound = !std::is_same<T, float>::value;  // dS cast to K's dtype
  constexpr int LD = ld<D>();
  constexpr int CPT = D / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + kBR * LD;
  float* Ks = dOs + kBR * LD;
  float* Vs = Ks + kBC * LD;
  float* Ds = Vs + kBC * LD;
  float* row_lse = Ds + kBR * (kBC + 1);
  float* row_dlt = row_lse + kBR;

  const qg::FlatIdx blk = qg::flat_block((sq + kBR - 1) / kBR);   // (query tile, batch*head)
  const int bh = blk.o, q0 = blk.i * kBR, tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const size_t qoff = static_cast<size_t>(bh) * sq * D, koff = static_cast<size_t>(bh) * sk * D;

  stage<T, D, kBR>(Qs, q + qoff, q0, sq);
  stage<T, D, kBR>(dOs, dout + qoff, q0, sq);
  if (tid < kBR) {
    const bool ok = q0 + tid < sq;
    row_lse[tid] = ok ? lse[static_cast<size_t>(bh) * sq + q0 + tid] : 0.f;
    row_dlt[tid] = ok ? delta[static_cast<size_t>(bh) * sq + q0 + tid] : 0.f;
  }
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  int nk = (sk + kBC - 1) / kBC;
  if (causal) nk = min(nk, (min(q0 + kBR, sq) - 1) / kBC + 1);
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBC;
    stage<T, D, kBC>(Ks, k + koff, k0, sk);
    stage<T, D, kBC>(Vs, v + koff, k0, sk);
    __syncthreads();

    float s[4][2], dp[4][2];
    dot_patch<D>(Qs, Ks, ty, tx, s);
    dot_patch<D>(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty * 4 + i, c = tx * 2 + j;
        const int gq = q0 + r, gk = k0 + c;
        const bool ok = gq < sq && gk < sk && (!causal || gk <= gq);
        const float p = prob(ok, s[i][j], scale, row_lse[r]);
        const float ds = p * (dp[i][j] - row_dlt[r]) * scale;
        Ds[r * (kBC + 1) + c] = kRound ? qg::bf16_round(ds) : ds;
      }
    __syncthreads();

    // dQ += dS K on rows ty*4+i, cols tx + 16*j
    for (int c = 0; c < kBC; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = Ds[(ty * 4 + i) * (kBC + 1) + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float kv = Ks[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gq = q0 + ty * 4 + i;
    if (gq < sq) {
      T* row = dq + qoff + static_cast<size_t>(gq) * D;
#pragma unroll
      for (int j = 0; j < CPT; ++j) row[tx + 16 * j] = qg::from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int causal,
                     float scale) {
  constexpr bool kRound = !std::is_same<T, float>::value;  // P and dS cast to the input dtype
  constexpr int LD = ld<D>();
  constexpr int CPT = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBR * LD;
  float* Qs = Vs + kBR * LD;
  float* dOs = Qs + kBC * LD;
  float* Ps = dOs + kBC * LD;
  float* Ds = Ps + kBR * (kBC + 1);
  float* col_lse = Ds + kBR * (kBC + 1);
  float* col_dlt = col_lse + kBC;

  const qg::FlatIdx blk = qg::flat_block((sk + kBR - 1) / kBR);   // (key tile, batch*head)
  const int bh = blk.o, k0 = blk.i * kBR, tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const size_t qoff = static_cast<size_t>(bh) * sq * D, koff = static_cast<size_t>(bh) * sk * D;

  stage<T, D, kBR>(Ks, k + koff, k0, sk);
  stage<T, D, kBR>(Vs, v + koff, k0, sk);
  float dk_acc[4][CPT], dv_acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal: query i attends key j only if j <= i, so the walk starts at
  // the tile holding query k0
  const int nq = (sq + kBC - 1) / kBC;
  for (int qt = causal ? k0 / kBC : 0; qt < nq; ++qt) {
    const int qs0 = qt * kBC;
    stage<T, D, kBC>(Qs, q + qoff, qs0, sq);
    stage<T, D, kBC>(dOs, dout + qoff, qs0, sq);
    if (tid < kBC) {
      const bool ok = qs0 + tid < sq;
      col_lse[tid] = ok ? lse[static_cast<size_t>(bh) * sq + qs0 + tid] : 0.f;
      col_dlt[tid] = ok ? delta[static_cast<size_t>(bh) * sq + qs0 + tid] : 0.f;
    }
    __syncthreads();

    // transposed tiles: row r is key k0 + r, column c is query qs0 + c
    float s[4][2], dp[4][2];
    dot_patch<D>(Ks, Qs, ty, tx, s);
    dot_patch<D>(Vs, dOs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty * 4 + i, c = tx * 2 + j;
        const int gk = k0 + r, gq = qs0 + c;
        const bool ok = gq < sq && gk < sk && (!causal || gk <= gq);
        const float p = prob(ok, s[i][j], scale, col_lse[c]);
        const float ds = p * (dp[i][j] - col_dlt[c]) * scale;
        Ps[r * (kBC + 1) + c] = kRound ? qg::bf16_round(p) : p;
        Ds[r * (kBC + 1) + c] = kRound ? qg::bf16_round(ds) : ds;
      }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q on key rows ty*4+i, cols tx + 16*j
    for (int c = 0; c < kBC; ++c) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[(ty * 4 + i) * (kBC + 1) + c];
        dsv[i] = Ds[(ty * 4 + i) * (kBC + 1) + c];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float g = dOs[c * LD + tx + 16 * j];
        const float qv = Qs[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][j] = fmaf(pv[i], g, dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dsv[i], qv, dk_acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gk = k0 + ty * 4 + i;
    if (gk < sk) {
      T* krow = dk + koff + static_cast<size_t>(gk) * D;
      T* vrow = dv + koff + static_cast<size_t>(gk) * D;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        krow[tx + 16 * j] = qg::from_f32<T>(dk_acc[i][j]);
        vrow[tx + 16 * j] = qg::from_f32<T>(dv_acc[i][j]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const float* lse, const void* dout, void* dq, void* dk, void* dv,
                   float* delta, int bh, int sq, int sk, int causal, float scale,
                   cudaStream_t s) {
  const size_t smem_q = dq_smem_bytes<D>(), smem_kv = dkv_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem_q));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_kv));
  if (e != cudaSuccess) return e;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const long long rows = static_cast<long long>(bh) * sq;
  const unsigned delta_blocks = static_cast<unsigned>((rows * 32 + kThreads - 1) / kThreads);
  delta_kernel<T, D><<<delta_blocks, kThreads, 0, s>>>(static_cast<const T*>(o), gt, delta,
                                                      rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq_kernel<T, D><<<dim3(((sq + kBR - 1) / kBR) * bh), kThreads, smem_q, s>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), sq, sk, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_kernel<T, D><<<dim3(((sk + kBR - 1) / kBR) * bh), kThreads, smem_kv, s>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, causal,
      scale);
  return cudaGetLastError();
}

// ------------------------------------------------------ bf16: mma.sync
using bf16 = __nv_bfloat16;
constexpr int kMmaRows = 64, kMmaThreads = 128;   // 4 warps of 16 rows

template <int D> __host__ __device__ constexpr int mma_ld() { return D + 8; }  // bf16 row stride (+16 B)
// the resident pair (Q and dO, or K and V), then two stages of the streamed pair
template <int D> constexpr size_t mma_dq_smem_bytes() {
  return sizeof(bf16) * static_cast<size_t>(mma_ld<D>()) * 6 * kMmaRows;
}
// ... plus two stages of the streamed tile's lse and delta
template <int D> constexpr size_t mma_dkv_smem_bytes() {
  return mma_dq_smem_bytes<D>() + sizeof(float) * 4 * kMmaRows;
}

// cp.async of rows r0 .. r0 + kMmaRows - 1 of a [n, D] bf16 matrix into a
// shared tile of row stride mma_ld<D>(); rows at or past n are zero-filled.
template <int D>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* src, int r0, int n) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  static_assert((kMmaRows * CH) % kMmaThreads == 0, "tile copy must divide evenly");
#pragma unroll
  for (int it = 0; it < kMmaRows * CH / kMmaThreads; ++it) {
    const int i = it * kMmaThreads + static_cast<int>(threadIdx.x);
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r0 + r < n;
    qg::cp_async16(qg::smem_addr(dst + r * mma_ld<D>() + c),
                   src + static_cast<size_t>(ok ? r0 + r : 0) * D + c, ok ? 16 : 0);
  }
}

// ldmatrix row and column offsets of this lane: an A fragment from 16 rows
// (x4: rows 0-15, columns 0-7 then 8-15), two n8 B fragments from 16 rows
// of a [n][k] tile, and two n8 B fragments from 16 rows of a [k][n] tile
// (ldmatrix.trans).
struct Lane {
  int a_row, a_col, b_row, b_col, t_row, t_col;
  __device__ explicit Lane(int lane)
      : a_row(lane & 15), a_col((lane >> 4) * 8),
        b_row((lane & 7) + ((lane >> 4) << 3)), b_col(((lane >> 3) & 1) * 8),
        t_row((lane & 7) + (((lane >> 3) & 1) << 3)), t_col((lane >> 4) * 8) {}
};

// A warp's two fragment rows (this thread's r0 and r0 + 8) and what masks a
// (row, column) pair: rows index queries in the dQ kernel and keys in the
// dK/dV kernel (columns the other), so the causal test flips with them.
struct Rows {
  int r0, r1, n_rows, n_cols, causal;
};

__device__ __forceinline__ bool attends(const Rows& r, int row, int col, bool rows_are_queries) {
  const int qi = rows_are_queries ? row : col, key = rows_are_queries ? col : row;
  return row < r.n_rows && col < r.n_cols && (!r.causal || key <= qi);
}

// dQ kernel: from S and dP fragments (rows are queries; columns col0 + 8j
// + {0, 1} are keys) the bf16(dS) A fragments, dS = P (dP - delta) * scale
// with P = exp(s * scale - lse) (s * scale rounded first); with MASK,
// pairs that do not attend get P = 0.
template <bool MASK, int NJ>
__device__ __forceinline__ void ds_fragments(const float (&s)[NJ][4], const float (&dp)[NJ][4],
                                             uint32_t (&da)[NJ / 2][4], const Rows& r,
                                             int col0, const float (&lse)[2],
                                             const float (&dl)[2], float scale) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      float p = qg::exp_approx(__fmul_rn(s[j][e], scale) - lse[h]);
      if (MASK && !attends(r, h ? r.r1 : r.r0, col0 + j * 8 + (e & 1), true)) p = 0.f;
      ds[e] = p * (dp[j][e] - dl[h]) * scale;
    }
    da[j / 2][(j & 1) * 2] = qg::pack_bf16(ds[0], ds[1]);
    da[j / 2][(j & 1) * 2 + 1] = qg::pack_bf16(ds[2], ds[3]);
  }
}

// dK/dV kernel: from S^T and dP^T fragments of 16 keys x 16 queries (rows
// keys; columns col0 + {0, 1, 8, 9} queries, whose lse and delta are
// given in that order) the bf16(P^T) and bf16(dS^T) A fragments.
template <bool MASK>
__device__ __forceinline__ void pds_fragments(const float (&s)[2][4], const float (&dp)[2][4],
                                              uint32_t (&pa)[4], uint32_t (&da)[4],
                                              const Rows& r, int col0, const float (&lse)[4],
                                              const float (&dl)[4], float scale) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 2 * j + (e & 1);   // index of the column's lse and delta
      p[e] = qg::exp_approx(__fmul_rn(s[j][e], scale) - lse[c]);
      if (MASK && !attends(r, e < 2 ? r.r0 : r.r1, col0 + j * 8 + (e & 1), false)) p[e] = 0.f;
      ds[e] = p[e] * (dp[j][e] - dl[c]) * scale;
    }
    pa[2 * j] = qg::pack_bf16(p[0], p[1]);
    pa[2 * j + 1] = qg::pack_bf16(p[2], p[3]);
    da[2 * j] = qg::pack_bf16(ds[0], ds[1]);
    da[2 * j + 1] = qg::pack_bf16(ds[2], ds[3]);
  }
}

// whether a warp holds its resident A fragments in registers (D <= 128)
template <int D> __host__ __device__ constexpr bool mma_a_regs() { return D <= 128; }

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int sq, int sk, int causal, float scale) {
  constexpr int LD = mma_ld<D>(), KD = D / 16, NO = D / 8;
  constexpr bool AREG = mma_a_regs<D>();   // D 256: Q's and dO's fragments per k-chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kMmaRows * LD;
  bf16* Ks = dOs + kMmaRows * LD;     // [2][kMmaRows][LD]
  bf16* Vs = Ks + 2 * kMmaRows * LD;  // [2][kMmaRows][LD]

  // the last query blocks, which attend the most keys when causal, first
  const int nqt = (sq + kMmaRows - 1) / kMmaRows;
  const qg::FlatIdx blk = qg::flat_block(nqt);   // (query tile, batch*head)
  const int bh = blk.o, q0 = (nqt - 1 - blk.i) * kMmaRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int w0 = q0 + warp * 16, qi0 = w0 + (lane >> 2), qi1 = qi0 + 8;
  const Lane ln(lane);
  const size_t qoff = static_cast<size_t>(bh) * sq * D, koff = static_cast<size_t>(bh) * sk * D;
  const size_t roff = static_cast<size_t>(bh) * sq;

  int nk = (sk + kMmaRows - 1) / kMmaRows;
  if (causal) nk = min(nk, (min(q0 + kMmaRows, sq) - 1) / kMmaRows + 1);
  cp_tile<D>(Qs, q + qoff, q0, sq);
  cp_tile<D>(dOs, dout + qoff, q0, sq);
  cp_tile<D>(Ks, k + koff, 0, sk);
  cp_tile<D>(Vs, v + koff, 0, sk);
  qg::cp_async_commit();
  const float lse0 = qi0 < sq ? lse[roff + qi0] : 0.f, lse1 = qi1 < sq ? lse[roff + qi1] : 0.f;
  const float dl0 = qi0 < sq ? delta[roff + qi0] : 0.f, dl1 = qi1 < sq ? delta[roff + qi1] : 0.f;

  uint32_t qf[AREG ? KD : 1][4], gf[AREG ? KD : 1][4];
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1, k0 = kt * kMmaRows;
    if (kt + 1 < nk) {
      cp_tile<D>(Ks + (st ^ 1) * kMmaRows * LD, k + koff, k0 + kMmaRows, sk);
      cp_tile<D>(Vs + (st ^ 1) * kMmaRows * LD, v + koff, k0 + kMmaRows, sk);
    }
    qg::cp_async_commit();
    qg::cp_async_wait<1>();
    __syncthreads();
    if constexpr (AREG) {
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          const int off = (warp * 16 + ln.a_row) * LD + kk * 16 + ln.a_col;
          qg::ldmatrix_x4(qf[kk], qg::smem_addr(Qs + off));
          qg::ldmatrix_x4(gf[kk], qg::smem_addr(dOs + off));
        }
      }
    }
    const bf16* Kt = Ks + st * kMmaRows * LD;
    const bf16* Vt = Vs + st * kMmaRows * LD;
#pragma unroll
    for (int h = 0; h < 2; ++h) {      // halves of 32 keys
      const int kh = k0 + h * 32;
      if (w0 >= sq || kh >= sk || (causal && w0 + 15 < kh)) continue;
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        if (!AREG) {
          const int off = (warp * 16 + ln.a_row) * LD + kk * 16 + ln.a_col;
          qg::ldmatrix_x4(qf[0], qg::smem_addr(Qs + off));
          qg::ldmatrix_x4(gf[0], qg::smem_addr(dOs + off));
        }
        const uint32_t* qa = qf[AREG ? kk : 0];
        const uint32_t* ga = gf[AREG ? kk : 0];
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          const int off = (h * 32 + jp * 16 + ln.b_row) * LD + kk * 16 + ln.b_col;
          uint32_t b[4];
          qg::ldmatrix_x4(b, qg::smem_addr(Kt + off));
          qg::mma_bf16(s[2 * jp], qa, b);
          qg::mma_bf16(s[2 * jp + 1], qa, b + 2);
          qg::ldmatrix_x4(b, qg::smem_addr(Vt + off));
          qg::mma_bf16(dp[2 * jp], ga, b);
          qg::mma_bf16(dp[2 * jp + 1], ga, b + 2);
        }
      }
      uint32_t da[2][4];   // bf16(dS) as the A fragments of dS K
      const Rows r{qi0, qi1, sq, sk, causal};
      const float lse2[2] = {lse0, lse1}, dl2[2] = {dl0, dl1};
      if (w0 + 15 >= sq || kh + 32 > sk || (causal && kh + 31 > w0))
        ds_fragments<true, 4>(s, dp, da, r, kh + 2 * t, lse2, dl2, scale);
      else
        ds_fragments<false, 4>(s, dp, da, r, kh + 2 * t, lse2, dl2, scale);
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int dp2 = 0; dp2 < NO / 2; ++dp2) {
          uint32_t b[4];
          qg::ldmatrix_x4_trans(b, qg::smem_addr(Kt + (h * 32 + c * 16 + ln.t_row) * LD +
                                                 dp2 * 16 + ln.t_col));
          qg::mma_bf16(acc[2 * dp2], da[c], b);
          qg::mma_bf16(acc[2 * dp2 + 1], da[c], b + 2);
        }
    }
    __syncthreads();
  }

  bf16* db = dq + qoff;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int col = j * 8 + 2 * t;
    if (qi0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(db + static_cast<size_t>(qi0) * D + col) =
          __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    if (qi1 < sq)
      *reinterpret_cast<__nv_bfloat162*>(db + static_cast<size_t>(qi1) * D + col) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk,
                         int causal, float scale) {
  constexpr int LD = mma_ld<D>(), KD = D / 16, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kMmaRows * LD;
  bf16* Qs = Vs + kMmaRows * LD;       // [2][kMmaRows][LD]
  bf16* dOs = Qs + 2 * kMmaRows * LD;  // [2][kMmaRows][LD]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * kMmaRows * LD);  // [2][kMmaRows]
  float* Dl = Ls + 2 * kMmaRows;                                  // [2][kMmaRows]

  const qg::FlatIdx blk = qg::flat_block((sk + kMmaRows - 1) / kMmaRows);   // (key tile, batch*head)
  const int bh = blk.o, k0 = blk.i * kMmaRows, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int kw0 = k0 + warp * 16, ki0 = kw0 + (lane >> 2), ki1 = ki0 + 8;
  const Lane ln(lane);
  const size_t qoff = static_cast<size_t>(bh) * sq * D, koff = static_cast<size_t>(bh) * sk * D;
  const float* lb = lse + static_cast<size_t>(bh) * sq;
  const float* db = delta + static_cast<size_t>(bh) * sq;

  // the query tiles that can attend this block's keys (causal: from k0)
  const int nq = (sq + kMmaRows - 1) / kMmaRows, qt0 = causal ? k0 / kMmaRows : 0;
  auto load_q_tile = [&](int qt, int st) {
    const int qs0 = qt * kMmaRows;
    cp_tile<D>(Qs + st * kMmaRows * LD, q + qoff, qs0, sq);
    cp_tile<D>(dOs + st * kMmaRows * LD, dout + qoff, qs0, sq);
    const int r = tid & (kMmaRows - 1), qi = qs0 + r;
    const bool ok = qi < sq;
    const float* src = (tid < kMmaRows ? lb : db) + (ok ? qi : 0);
    float* dst = (tid < kMmaRows ? Ls : Dl) + st * kMmaRows + r;
    qg::cp_async4(qg::smem_addr(dst), src, ok ? 4 : 0);
  };
  static_assert(kMmaThreads == 2 * kMmaRows, "one thread per lse and per delta row");
  cp_tile<D>(Ks, k + koff, k0, sk);
  cp_tile<D>(Vs, v + koff, k0, sk);
  if (qt0 < nq) load_q_tile(qt0, 0);
  qg::cp_async_commit();

  uint32_t kf[KD][4], vf[KD][4];
  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int qt = qt0; qt < nq; ++qt) {
    const int st = (qt - qt0) & 1, qs0 = qt * kMmaRows;
    if (qt + 1 < nq) load_q_tile(qt + 1, st ^ 1);
    qg::cp_async_commit();
    qg::cp_async_wait<1>();
    __syncthreads();
    if (qt == qt0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const int off = (warp * 16 + ln.a_row) * LD + kk * 16 + ln.a_col;
        qg::ldmatrix_x4(kf[kk], qg::smem_addr(Ks + off));
        qg::ldmatrix_x4(vf[kk], qg::smem_addr(Vs + off));
      }
    }
    const bf16* Qt = Qs + st * kMmaRows * LD;
    const bf16* dOt = dOs + st * kMmaRows * LD;
    const float* Lt = Ls + st * kMmaRows;
    const float* Dt = Dl + st * kMmaRows;
#pragma unroll
    for (int h = 0; h < 4; ++h) {      // pieces of 16 queries
      const int qh = qs0 + h * 16;
      if (kw0 >= sk || qh >= sq || (causal && qh + 15 < kw0)) continue;
      // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t b[4];
        const int off = (h * 16 + ln.b_row) * LD + kk * 16 + ln.b_col;
        qg::ldmatrix_x4(b, qg::smem_addr(Qt + off));
        qg::mma_bf16(s[0], kf[kk], b);
        qg::mma_bf16(s[1], kf[kk], b + 2);
        qg::ldmatrix_x4(b, qg::smem_addr(dOt + off));
        qg::mma_bf16(dp[0], vf[kk], b);
        qg::mma_bf16(dp[1], vf[kk], b + 2);
      }
      // bf16(P^T) and bf16(dS^T) as A fragments; rows are keys here
      uint32_t pa[4], da[4];
      const Rows r{ki0, ki1, sk, sq, causal};
      const int c0 = h * 16 + 2 * t;
      const float lse2[4] = {Lt[c0], Lt[c0 + 1], Lt[c0 + 8], Lt[c0 + 9]};
      const float dl2[4] = {Dt[c0], Dt[c0 + 1], Dt[c0 + 8], Dt[c0 + 9]};
      if (qh + 16 > sq || kw0 + 16 > sk || (causal && kw0 + 15 > qh))
        pds_fragments<true>(s, dp, pa, da, r, qs0 + c0, lse2, dl2, scale);
      else
        pds_fragments<false>(s, dp, pa, da, r, qs0 + c0, lse2, dl2, scale);
      // dV += P^T dO and dK += dS^T Q over these 16 queries
#pragma unroll
      for (int dp2 = 0; dp2 < NO / 2; ++dp2) {
        const int off = (h * 16 + ln.t_row) * LD + dp2 * 16 + ln.t_col;
        uint32_t b[4];
        qg::ldmatrix_x4_trans(b, qg::smem_addr(dOt + off));
        qg::mma_bf16(dva[2 * dp2], pa, b);
        qg::mma_bf16(dva[2 * dp2 + 1], pa, b + 2);
        qg::ldmatrix_x4_trans(b, qg::smem_addr(Qt + off));
        qg::mma_bf16(dka[2 * dp2], da, b);
        qg::mma_bf16(dka[2 * dp2 + 1], da, b + 2);
      }
    }
    __syncthreads();
  }
  qg::cp_async_wait<0>();   // a block with no query tile still has K/V copies in flight

#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int col = j * 8 + 2 * t;
    if (ki0 < sk) {
      const size_t o = koff + static_cast<size_t>(ki0) * D + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + o) = __floats2bfloat162_rn(dka[j][0], dka[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + o) = __floats2bfloat162_rn(dva[j][0], dva[j][1]);
    }
    if (ki1 < sk) {
      const size_t o = koff + static_cast<size_t>(ki1) * D + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + o) = __floats2bfloat162_rn(dka[j][2], dka[j][3]);
      *reinterpret_cast<__nv_bfloat162*>(dv + o) = __floats2bfloat162_rn(dva[j][2], dva[j][3]);
    }
  }
}

// The dK/dV work at D 256: block (64 keys, batch*head, z) computes dV (z 0,
// from S: dV += bf16(P^T) dO) or dK (z 1, from S and dP: dK += bf16(dS^T)
// Q) with one accumulator; K's and V's A fragments are read from shared
// memory per k-chunk. The walk, masks and rounding points are
// flash_bwd_dkv_mma_kernel's, so each output is what that kernel computes.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk,
                          int causal, float scale) {
  constexpr int LD = mma_ld<D>(), KD = D / 16, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kMmaRows * LD;
  bf16* Qs = Vs + kMmaRows * LD;       // [2][kMmaRows][LD]
  bf16* dOs = Qs + 2 * kMmaRows * LD;  // [2][kMmaRows][LD]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * kMmaRows * LD);  // [2][kMmaRows]
  float* Dl = Ls + 2 * kMmaRows;                                  // [2][kMmaRows]

  const qg::FlatIdx blk = qg::flat_block((sk + kMmaRows - 1) / kMmaRows);   // (key tile, batch*head)
  const int bh = blk.o, k0 = blk.i * kMmaRows, tid = threadIdx.x;
  const bool want_dk = blockIdx.z == 1;   // block-uniform
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int kw0 = k0 + warp * 16, ki0 = kw0 + (lane >> 2), ki1 = ki0 + 8;
  const Lane ln(lane);
  const size_t qoff = static_cast<size_t>(bh) * sq * D, koff = static_cast<size_t>(bh) * sk * D;
  const float* lb = lse + static_cast<size_t>(bh) * sq;
  const float* db = delta + static_cast<size_t>(bh) * sq;

  const int nq = (sq + kMmaRows - 1) / kMmaRows, qt0 = causal ? k0 / kMmaRows : 0;
  auto load_q_tile = [&](int qt, int st) {
    const int qs0 = qt * kMmaRows;
    cp_tile<D>(Qs + st * kMmaRows * LD, q + qoff, qs0, sq);
    cp_tile<D>(dOs + st * kMmaRows * LD, dout + qoff, qs0, sq);
    const int r = tid & (kMmaRows - 1), qi = qs0 + r;
    const bool ok = qi < sq;
    const float* src = (tid < kMmaRows ? lb : db) + (ok ? qi : 0);
    float* dst = (tid < kMmaRows ? Ls : Dl) + st * kMmaRows + r;
    qg::cp_async4(qg::smem_addr(dst), src, ok ? 4 : 0);
  };
  cp_tile<D>(Ks, k + koff, k0, sk);
  cp_tile<D>(Vs, v + koff, k0, sk);
  if (qt0 < nq) load_q_tile(qt0, 0);
  qg::cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int qt = qt0; qt < nq; ++qt) {
    const int st = (qt - qt0) & 1, qs0 = qt * kMmaRows;
    if (qt + 1 < nq) load_q_tile(qt + 1, st ^ 1);
    qg::cp_async_commit();
    qg::cp_async_wait<1>();
    __syncthreads();
    const bf16* Qt = Qs + st * kMmaRows * LD;
    const bf16* dOt = dOs + st * kMmaRows * LD;
    const float* Lt = Ls + st * kMmaRows;
    const float* Dt = Dl + st * kMmaRows;
#pragma unroll 1
    for (int h = 0; h < 4; ++h) {      // pieces of 16 queries
      const int qh = qs0 + h * 16;
      if (kw0 >= sk || qh >= sq || (causal && qh + 15 < kw0)) continue;
      // S^T = K Q^T (and, for dK, dP^T = V dO^T): rows are keys, columns queries
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const int aoff = (warp * 16 + ln.a_row) * LD + kk * 16 + ln.a_col;
        const int off = (h * 16 + ln.b_row) * LD + kk * 16 + ln.b_col;
        uint32_t a[4], b[4];
        qg::ldmatrix_x4(a, qg::smem_addr(Ks + aoff));
        qg::ldmatrix_x4(b, qg::smem_addr(Qt + off));
        qg::mma_bf16(s[0], a, b);
        qg::mma_bf16(s[1], a, b + 2);
        if (want_dk) {
          qg::ldmatrix_x4(a, qg::smem_addr(Vs + aoff));
          qg::ldmatrix_x4(b, qg::smem_addr(dOt + off));
          qg::mma_bf16(dp[0], a, b);
          qg::mma_bf16(dp[1], a, b + 2);
        }
      }
      uint32_t pa[4], da[4];
      const Rows r{ki0, ki1, sk, sq, causal};
      const int c0 = h * 16 + 2 * t;
      const float lse2[4] = {Lt[c0], Lt[c0 + 1], Lt[c0 + 8], Lt[c0 + 9]};
      const float dl2[4] = {Dt[c0], Dt[c0 + 1], Dt[c0 + 8], Dt[c0 + 9]};
      if (qh + 16 > sq || kw0 + 16 > sk || (causal && kw0 + 15 > qh))
        pds_fragments<true>(s, dp, pa, da, r, qs0 + c0, lse2, dl2, scale);
      else
        pds_fragments<false>(s, dp, pa, da, r, qs0 + c0, lse2, dl2, scale);
      // dV += P^T dO, or dK += dS^T Q, over these 16 queries
      const uint32_t* fa = want_dk ? da : pa;
      const bf16* Bt = want_dk ? Qt : dOt;
#pragma unroll
      for (int dp2 = 0; dp2 < NO / 2; ++dp2) {
        uint32_t b[4];
        qg::ldmatrix_x4_trans(b, qg::smem_addr(Bt + (h * 16 + ln.t_row) * LD + dp2 * 16 + ln.t_col));
        qg::mma_bf16(acc[2 * dp2], fa, b);
        qg::mma_bf16(acc[2 * dp2 + 1], fa, b + 2);
      }
    }
    __syncthreads();
  }
  qg::cp_async_wait<0>();   // a block with no query tile still has K/V copies in flight

  bf16* dst = want_dk ? dk : dv;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int col = j * 8 + 2 * t;
    if (ki0 < sk)
      *reinterpret_cast<__nv_bfloat162*>(dst + koff + static_cast<size_t>(ki0) * D + col) =
          __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    if (ki1 < sk)
      *reinterpret_cast<__nv_bfloat162*>(dst + koff + static_cast<size_t>(ki1) * D + col) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
}

// the dK/dV kernel of width D (only that one is instantiated)
template <int D> constexpr auto dkv_kernel_of() {
  if constexpr (mma_a_regs<D>()) return flash_bwd_dkv_mma_kernel<D>;
  else return flash_bwd_dkv_wide_kernel<D>;
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* o,
                       const float* lse, const void* dout, void* dq, void* dk, void* dv,
                       float* delta, int bh, int sq, int sk, int causal, float scale,
                       int smem_dq, int smem_dkv, cudaStream_t s) {
  constexpr size_t want_q = mma_dq_smem_bytes<D>(), want_kv = mma_dkv_smem_bytes<D>();
  if (static_cast<size_t>(smem_dq) != want_q || static_cast<size_t>(smem_dkv) != want_kv)
    return cudaErrorInvalidValue;
  constexpr bool wide = !mma_a_regs<D>();   // D 256: flash_bwd_dkv_wide_kernel
  const auto dkv_kernel = dkv_kernel_of<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(want_q));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(want_kv));
  if (e != cudaSuccess) return e;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* gt = static_cast<const bf16*>(dout);
  const long long rows = static_cast<long long>(bh) * sq;
  const unsigned delta_blocks = static_cast<unsigned>((rows * 32 + kThreads - 1) / kThreads);
  delta_kernel<bf16, D><<<delta_blocks, kThreads, 0, s>>>(static_cast<const bf16*>(o), gt,
                                                         delta, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq_mma_kernel<D><<<dim3(((sq + kMmaRows - 1) / kMmaRows) * bh), kMmaThreads, want_q,
                               s>>>(qt, kt, vt, gt, lse, delta, static_cast<bf16*>(dq), sq, sk,
                                    causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkv_kernel<<<dim3(((sk + kMmaRows - 1) / kMmaRows) * bh, 1, wide ? 2 : 1), kMmaThreads, want_kv,
               s>>>(qt, kt, vt, gt, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                    sq, sk, causal, scale);
  return cudaGetLastError();
}


// ------------------------------------------------------------ wide: SIMT, any width
namespace wd = qg::wide;

// delta = rowsum(dO * O) at a runtime width: one warp per row
template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_wide_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                  long long rows, int width) {
  const long long row = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* orow = o + static_cast<size_t>(row) * width;
  const T* grow = dout + static_cast<size_t>(row) * width;
  float acc = 0.f;
  for (int d = lane; d < width; d += 32) acc = fmaf(qg::to_f32(grow[d]), qg::to_f32(orow[d]), acc);
  acc = qg::warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

// MODE 0: dQ = dS K (own rows: queries; streamed: keys); 1: dK = dS^T Q
// (own: keys; streamed: queries); 2: dV = P^T dO. Grid (own tiles *
// column chunks * BH), flattened in that order; the output's width is dqk
// (dQ, dK) or dvp (dV), each block 256 columns of it.
template <typename T, int MODE>
__global__ void __launch_bounds__(wd::kThreads)
flash_bwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ grad, int sq, int sk,
                      int dqk, int dvp, int causal, float scale) {
  constexpr bool kRound = !std::is_same<T, float>::value;  // P and dS cast to the input dtype
  constexpr bool kOwnQ = MODE == 0;
  constexpr int R = wd::kRows, C = wd::kTile, CPT = wd::kOut / 16;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = As + R * wd::kLdC;
  float* Ws = Bs + C * wd::kLdC;
  float* Ms = Ws + R * wd::kLdS;
  float* st_lse = Ms + C * wd::kLdO;   // the tile's queries' lse and delta (own: 64, streamed: 32)
  float* st_dlt = st_lse + R;

  const int n_own = kOwnQ ? sq : sk, n_str = kOwnQ ? sk : sq;
  const int width = MODE == 2 ? dvp : dqk;
  const int nt = (n_own + R - 1) / R, nc = (width + wd::kOut - 1) / wd::kOut;
  const int bx = static_cast<int>(blockIdx.x % static_cast<unsigned>(nt * nc));
  const int bh = static_cast<int>(blockIdx.x / static_cast<unsigned>(nt * nc));
  const int r0 = (bx % nt) * R, c0 = (bx / nt) * wd::kOut;
  const int ncols = min(wd::kOut, width - c0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t qo = static_cast<size_t>(bh) * sq, ko = static_cast<size_t>(bh) * sk;
  const T* qb = q + qo * dqk;
  const T* kb = k + ko * dqk;
  const T* vb = v + ko * dvp;
  const T* gb = dout + qo * dvp;

  if (kOwnQ && tid < R) {
    const bool ok = r0 + tid < sq;
    st_lse[tid] = ok ? lse[qo + r0 + tid] : 0.f;
    st_dlt[tid] = ok ? delta[qo + r0 + tid] : 0.f;
  }
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  // the streamed tiles: keys up to the causal limit (dQ), or queries from
  // the first that attends the block's keys (dK, dV)
  const int ntiles = (n_str + C - 1) / C;
  int t_begin = 0, t_end = ntiles;
  if (causal && kOwnQ) t_end = min(ntiles, (min(r0 + R, sq) - 1) / C + 1);
  if (causal && !kOwnQ) t_begin = r0 / C;
  __syncthreads();

  for (int t = t_begin; t < t_end; ++t) {
    const int s0 = t * C;
    if (!kOwnQ && tid < C) {
      const bool ok = s0 + tid < sq;
      st_lse[tid] = ok ? lse[qo + s0 + tid] : 0.f;
      st_dlt[tid] = ok ? delta[qo + s0 + tid] : 0.f;
    }
    float sc[4][2], dp[4][2];
    if (kOwnQ) wd::dot_tile(qb, r0, sq, kb, s0, sk, dqk, As, Bs, sc);
    else wd::dot_tile(kb, r0, sk, qb, s0, sq, dqk, As, Bs, sc);
    if (MODE == 0) wd::dot_tile(gb, r0, sq, vb, s0, sk, dvp, As, Bs, dp);
    if (MODE == 1) wd::dot_tile(vb, r0, sk, gb, s0, sq, dvp, As, Bs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int rr = ty * 4 + i, cc = tx * 2 + j;
        const int gq = kOwnQ ? r0 + rr : s0 + cc, gk = kOwnQ ? s0 + cc : r0 + rr;
        const int qi = kOwnQ ? rr : cc;   // the query's slot in st_lse / st_dlt
        const bool ok = gq < sq && gk < sk && (!causal || gk <= gq);
        const float p = prob(ok, sc[i][j], scale, st_lse[qi]);
        float w;
        if (MODE == 2) {
          w = kRound ? qg::bf16_round(p) : p;
        } else {
          const float ds = p * (dp[i][j] - st_dlt[qi]) * scale;
          w = kRound ? qg::bf16_round(ds) : ds;
        }
        Ws[rr * wd::kLdS + cc] = w;
      }
    // the streamed rows' columns [c0, c0 + ncols) of K (dQ), Q (dK), dO (dV)
    if (MODE == 0) wd::stage<T, C>(Ms, wd::kLdO, kb, dqk, s0, sk, c0, ncols);
    if (MODE == 1) wd::stage<T, C>(Ms, wd::kLdO, qb, dqk, s0, sq, c0, ncols);
    if (MODE == 2) wd::stage<T, C>(Ms, wd::kLdO, gb, dvp, s0, sq, c0, ncols);
    __syncthreads();
    wd::acc_tile(Ws, Ms, ncols, acc);
    __syncthreads();
  }

  T* ob = grad + (kOwnQ ? qo : ko) * width;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = r0 + ty * 4 + i;
    if (gr < n_own) {
      T* row = ob + static_cast<size_t>(gr) * width + c0;
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        if (16 * j < ncols) row[tx + 16 * j] = qg::from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int MODE>
cudaError_t launch_wide_one(const T* q, const T* k, const T* v, const T* g, const float* lse,
                            const float* delta, void* grad, int bh, int sq, int sk, int dqk,
                            int dvp, int causal, float scale, cudaStream_t s) {
  constexpr size_t smem = wd::smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_wide_kernel<T, MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int n_own = MODE == 0 ? sq : sk, width = MODE == 2 ? dvp : dqk;
  const long long blocks = static_cast<long long>((n_own + wd::kRows - 1) / wd::kRows) *
                           ((width + wd::kOut - 1) / wd::kOut) * bh;
  if (!qg::flat_grid_ok(blocks)) return cudaErrorInvalidValue;
  flash_bwd_wide_kernel<T, MODE><<<dim3(static_cast<unsigned>(blocks)), wd::kThreads, smem, s>>>(
      q, k, v, g, lse, delta, static_cast<T*>(grad), sq, sk, dqk, dvp, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* o,
                        const float* lse, const void* dout, void* dq, void* dk, void* dv,
                        float* delta, int bh, int sq, int sk, int dqk, int dvp, int causal,
                        float scale, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const long long rows = static_cast<long long>(bh) * sq;
  const long long delta_blocks = (rows * 32 + kThreads - 1) / kThreads;
  if (!qg::flat_grid_ok(delta_blocks)) return cudaErrorInvalidValue;
  delta_wide_kernel<T><<<static_cast<unsigned>(delta_blocks), kThreads, 0, s>>>(
      static_cast<const T*>(o), gt, delta, rows, dvp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = launch_wide_one<T, 0>(qt, kt, vt, gt, lse, delta, dq, bh, sq, sk, dqk, dvp, causal, scale, s);
  if (e != cudaSuccess) return e;
  e = launch_wide_one<T, 1>(qt, kt, vt, gt, lse, delta, dk, bh, sq, sk, dqk, dvp, causal, scale, s);
  if (e != cudaSuccess) return e;
  return launch_wide_one<T, 2>(qt, kt, vt, gt, lse, delta, dv, bh, sq, sk, dqk, dvp, causal,
                               scale, s);
}

}  // namespace

// q, o, dout, dq [BH, Sq, D]; k, v, dk, dv [BH, Sk, D]; lse f32 [BH, Sq]
// from the forward; delta f32 [BH, Sq] scratch. The launch plan: route 0
// (SIMT) takes dtype 0 (f32), route 1 (mma) dtype 1 (bf16); smem_dq and
// smem_dkv are the two kernels' dynamic shared memory, checked against the
// instantiation's. Returns cudaGetLastError() (cudaErrorInvalidValue for a
// plan or shape no instantiation takes).
extern "C" int qgemm_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* lse, const void* dout,
                                         void* dq, void* dk, void* dv, void* delta,
                                         int dtype, int bh, int sq, int sk, int D,
                                         int causal, float scale, int route, int smem_dq,
                                         int smem_dkv, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || sq <= 0 || sk <= 0 ||
      !qg::flat_grid_ok(static_cast<long long>(((sq > sk ? sq : sk) + 63) / 64) * bh) ||
      !qg::flat_grid_ok((static_cast<long long>(bh) * sq + 7) / 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (route == 0 && dtype == 0) {
#define QG_BWD(DD)                                                                  \
  (static_cast<size_t>(smem_dq) == dq_smem_bytes<DD>() &&                           \
           static_cast<size_t>(smem_dkv) == dkv_smem_bytes<DD>()                    \
       ? launch<float, DD>(q, k, v, o, l, dout, dq, dk, dv, dl, bh, sq, sk, causal, \
                           scale, s)                                                \
       : cudaErrorInvalidValue)
    if (D == 32) return QG_BWD(32);
    if (D == 64) return QG_BWD(64);
    if (D == 128) return QG_BWD(128);
    if (D == 256) return QG_BWD(256);
#undef QG_BWD
  }
  if (route == 1 && dtype == 1) {
#define QG_BWD(DD)                                                                      \
  launch_mma<DD>(q, k, v, o, l, dout, dq, dk, dv, dl, bh, sq, sk, causal, scale, smem_dq, \
                 smem_dkv, s)
    if (D == 32) return QG_BWD(32);
    if (D == 64) return QG_BWD(64);
    if (D == 128) return QG_BWD(128);
    if (D == 256) return QG_BWD(256);
#undef QG_BWD
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The wide route: q, dq [BH, Sq, dqk]; k, dk [BH, Sk, dqk]; v, dv [BH, Sk,
// dvp]; o, dout [BH, Sq, dvp] in f32 (dtype 0) or bf16 (dtype 1), dqk and
// dvp multiples of 64 (any size); lse f32 [BH, Sq] from the forward; delta
// f32 [BH, Sq] scratch; smem the plan's (qg::wide::smem_bytes). Four
// launches. Returns cudaGetLastError() (cudaErrorInvalidValue for a plan or
// shape it does not take).
extern "C" int qgemm_flash_attention_bwd_wide(const void* q, const void* k, const void* v,
                                              const void* o, const void* lse, const void* dout,
                                              void* dq, void* dk, void* dv, void* delta,
                                              int dtype, int bh, int sq, int sk, int dqk,
                                              int dvp, int causal, float scale, int smem,
                                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || sq <= 0 || sk <= 0 || dqk <= 0 || dvp <= 0 || dqk % wd::kChunk ||
      dvp % wd::kChunk || static_cast<size_t>(smem) != wd::smem_bytes())
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return static_cast<int>(launch_wide<float>(q, k, v, o, l, dout, dq, dk, dv, dl, bh, sq, sk,
                                               dqk, dvp, causal, scale, s));
  if (dtype == 1)
    return static_cast<int>(launch_wide<bf16>(q, k, v, o, l, dout, dq, dk, dv, dl, bh, sq, sk,
                                              dqk, dvp, causal, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
