// Kernel K3: blockwise (flash) attention forward, causal or not, for Hopper
// (sm_90a). Returns O and the per-row logsumexp.
//
// Replaces _flash_kernel / _flash_attention_fwd_impl of
// qgemm_tpu/ops/pallas/flash_attention.py. Same math: s = (q . k) * (1/sqrt(D))
// with products in the input dtype and f32 sums; masked entries (k >= Sk,
// and k > q when causal) get p = 0; online softmax in f32; P is cast to V's
// dtype before the second product; O = acc / max(l, 1e-30);
// lse = m + log(max(l, 1e-30)).
//
// What bounds it on the H100: at prefill lengths (Sq = Sk = 128..2048,
// D = 128) the flops — ~4 * Sq * Sk * D per head (half of it when causal)
// against 3 * S * D input bytes per head. This first kernel runs its two
// products on the f32 SIMT units, not the tensor cores, so it is far from
// that bound; wgmma is later work.
//
// Design: one block per (64 query rows, batch*head). Q is staged once in
// shared memory as f32; K and V stream through shared memory in 32-row
// tiles; each thread owns a 4 x 2 patch of the score tile and a 4 x (D/16)
// patch of the output accumulator (kept in registers across K tiles). One
// warp per 8 rows runs the online-softmax update between the products.
// Causal blocks above the diagonal are never visited (the K loop stops at
// the tile holding the block's last valid row). Scores never reach device
// memory: O(S * D) traffic.
#include <type_traits>

#include "common.cuh"

namespace {

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

  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ, tid = threadIdx.x;
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
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, sq, sk, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q [BH, Sq, D], k/v [BH, Sk, D], o [BH, Sq, D] (dtype 0 = f32, 1 = bf16);
// lse f32 [BH, Sq]. Returns cudaGetLastError().
extern "C" int qgemm_flash_attention_fwd(const void* q, const void* k, const void* v,
                                         void* o, void* lse, int dtype, int bh, int sq,
                                         int sk, int D, int causal, float scale,
                                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || sq <= 0 || sk <= 0 || bh > 65535) return static_cast<int>(cudaErrorInvalidValue);
  float* l = static_cast<float*>(lse);
  if (dtype == 0 && D == 64) return launch<float, 64>(q, k, v, o, l, bh, sq, sk, causal, scale, s);
  if (dtype == 0 && D == 128) return launch<float, 128>(q, k, v, o, l, bh, sq, sk, causal, scale, s);
  if (dtype == 1 && D == 64) return launch<__nv_bfloat16, 64>(q, k, v, o, l, bh, sq, sk, causal, scale, s);
  if (dtype == 1 && D == 128) return launch<__nv_bfloat16, 128>(q, k, v, o, l, bh, sq, sk, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
