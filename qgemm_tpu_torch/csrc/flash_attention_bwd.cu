// Kernel K7: blockwise (FlashAttention-2) attention backward, causal or not,
// for Hopper (sm_90a). From q, k, v, the forward's O and per-row logsumexp,
// and dO, it computes dQ, dK and dV.
//
// Replaces _flash_attention_bwd_impl (_flash_bwd_dq_kernel,
// _flash_bwd_dkv_kernel, _mask_and_p) of qgemm_tpu/ops/pallas/flash_attention.py.
// Same math and rounding points: delta = rowsum(dO * O) in f32;
// P = exp(s * scale - lse) recomputed with the forward's masks (keys >= Sk,
// query rows >= Sq, and k > q when causal get p = 0); dP = dO V^T in f32;
// dS = P * (dP - delta) * scale in f32, cast to the input dtype before
// dQ += dS K and dK += dS^T Q; P cast to dO's dtype before dV += P^T dO.
// Products take input-dtype values and sum in f32.
//
// What bounds it on the H100: the flops. Five products of 2 * Sq * Sk * D
// per head (S recomputed, dP, dV, dQ, dK; about half of the pairs when
// causal) against 8 * S * D input and output elements per head, so at
// training lengths (S = 2048, D = 128) it sits far above the bf16 ridge.
// This first kernel runs the products on the f32 SIMT units, as K3 does,
// not the tensor cores; wgmma/TMA are later work.
//
// Design, three launches on the caller's stream:
//   * delta_kernel: one warp per query row, delta = rowsum(dO * O);
//   * flash_bwd_dq_kernel: one block per (64 query rows, batch*head). Q and
//     dO are staged once as f32; K and V stream through shared memory in
//     32-row tiles up to the causal limit; dS goes through shared memory and
//     each thread keeps a 4 x (D/16) patch of dQ in registers;
//   * flash_bwd_dkv_kernel: one block per (64 key rows, batch*head). K and V
//     are staged once; Q, dO, lse and delta stream in 32-row tiles from the
//     first tile that can attend the block's keys; P and dS go through shared
//     memory and each thread keeps 4 x (D/16) patches of dK and dV.
// The tile layout (4 x 2 score patch per thread, f32 rows padded to D + 4)
// is K3's. Every output element is written by exactly one block: no
// atomics, so the result does not depend on scheduling.
#include <type_traits>

//
// Head widths: compiled for D in {32, 64, 128} with Dv == D; the wrapper
// zero-pads q, k, v, O and dO to one such D and slices dQ, dK and dV to
// the true widths (the padded columns of every product are zeros).
#include "common.cuh"

namespace {

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
             int rows) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) / 32, lane = threadIdx.x % 32;
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

  const int bh = blockIdx.y, q0 = blockIdx.x * kBR, tid = threadIdx.x;
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

  const int bh = blockIdx.y, k0 = blockIdx.x * kBR, tid = threadIdx.x;
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
                                                      static_cast<int>(rows));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq_kernel<T, D><<<dim3((sq + kBR - 1) / kBR, bh), kThreads, smem_q, s>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), sq, sk, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_kernel<T, D><<<dim3((sk + kBR - 1) / kBR, bh), kThreads, smem_kv, s>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq [BH, Sq, D]; k, v, dk, dv [BH, Sk, D] (dtype 0 = f32,
// 1 = bf16); lse f32 [BH, Sq] from the forward; delta f32 [BH, Sq] scratch.
// Returns cudaGetLastError().
extern "C" int qgemm_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* lse, const void* dout,
                                         void* dq, void* dk, void* dv, void* delta,
                                         int dtype, int bh, int sq, int sk, int D,
                                         int causal, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || sq <= 0 || sk <= 0 || bh > 65535 ||
      static_cast<long long>(bh) * sq > 0x7fffffffLL / 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define QG_BWD(T, DD) \
  launch<T, DD>(q, k, v, o, l, dout, dq, dk, dv, dl, bh, sq, sk, causal, scale, s)
  if (dtype == 0 && D == 32) return QG_BWD(float, 32);
  if (dtype == 1 && D == 32) return QG_BWD(__nv_bfloat16, 32);
  if (dtype == 0 && D == 64) return QG_BWD(float, 64);
  if (dtype == 0 && D == 128) return QG_BWD(float, 128);
  if (dtype == 1 && D == 64) return QG_BWD(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) return QG_BWD(__nv_bfloat16, 128);
#undef QG_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
