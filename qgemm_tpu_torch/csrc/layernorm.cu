// Fused residual-add + LayerNorm over the last axis for Hopper (sm_90a):
// the kernel of row 13.
//
// Replaces _ln_kernel / layernorm_residual_pallas of
// qgemm_tpu/ops/pallas/layernorm.py. Same math, in f32 whatever the
// inputs' dtypes: x (+ residual), mean = sum(x) * (1/n),
// var = sum((x - mean)^2) * (1/n), y = (x - mean) * rsqrt(var + eps) *
// gamma + beta, stored in x's dtype. Lanes past the width are left out of
// both sums, as the TPU kernel masks its padded columns. gamma and beta
// are optional (ones and zeros), and so is the residual.
//
// What bounds it on the H100: bytes. x (and the residual) are read once
// and y written once against ~10 flops an element.
//
// Design: row_ops.cuh's, as softmax.cu: one block per row, the row (x plus
// residual, summed in f32) in registers with 16-byte loads where the width
// allows, two block-wide sums, gamma and beta read once per element. Rows
// too wide for the registers run the loop variant (three reads of x and
// the residual).
#include "row_ops.cuh"

namespace {

using namespace qg::rows;

template <typename T, typename R, int SLOTS>
__global__ void layernorm_kernel(const T* __restrict__ x, const R* __restrict__ res,
                                 const float* __restrict__ gamma,
                                 const float* __restrict__ beta, T* __restrict__ out, int n,
                                 int vec, float inv_n, float eps) {
  constexpr int V = Vec<T>::N;
  static_assert(Vec<R>::N % V == 0 || V % Vec<R>::N == 0, "slot widths");
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  float v[SLOTS][V];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const int e0 = (threadIdx.x + i * blockDim.x) * V;
    load_slot(x + row * n, e0, n, vec, 0.f, v[i]);
    if (res != nullptr) {
      float r[V];
      if constexpr (Vec<R>::N == V) {
        load_slot(res + row * n, e0, n, vec, 0.f, r);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) r[j] = e0 + j < n ? qg::to_f32(res[row * n + e0 + j]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) v[i][j] += r[j];
    }
#pragma unroll
    for (int j = 0; j < V; ++j) sum += v[i][j];
  }
  const float mean = block_reduce<false>(sum, red) * inv_n;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const int e0 = (threadIdx.x + i * blockDim.x) * V;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float c = e0 + j < n ? v[i][j] - mean : 0.f;
      v[i][j] = c;
      sq += c * c;
    }
  }
  const float rstd = 1.f / sqrtf(block_reduce<false>(sq, red) * inv_n + eps);
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const int e0 = (threadIdx.x + i * blockDim.x) * V;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int e = e0 + j;
      float y = v[i][j] * rstd;
      if (e < n) {
        if (gamma != nullptr) y = y * gamma[e];
        if (beta != nullptr) y = y + beta[e];
      }
      v[i][j] = y;
    }
    store_slot(out + row * n, e0, n, vec, v[i]);
  }
}

// rows wider than the registers hold: x (+ residual) read in each pass
template <typename T, typename R>
__global__ void layernorm_loop_kernel(const T* __restrict__ x, const R* __restrict__ res,
                                      const float* __restrict__ gamma,
                                      const float* __restrict__ beta, T* __restrict__ out,
                                      int n, float inv_n, float eps) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const auto at = [&](int e) {
    float a = qg::to_f32(x[row * n + e]);
    if (res != nullptr) a += qg::to_f32(res[row * n + e]);
    return a;
  };
  float sum = 0.f;
  for (int e = threadIdx.x; e < n; e += blockDim.x) sum += at(e);
  const float mean = block_reduce<false>(sum, red) * inv_n;
  float sq = 0.f;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float c = at(e) - mean;
    sq += c * c;
  }
  const float rstd = 1.f / sqrtf(block_reduce<false>(sq, red) * inv_n + eps);
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    float y = (at(e) - mean) * rstd;
    if (gamma != nullptr) y = y * gamma[e];
    if (beta != nullptr) y = y + beta[e];
    out[row * n + e] = qg::from_f32<T>(y);
  }
}

template <typename T, typename R>
cudaError_t launch(const void* x, const void* res, const float* g, const float* b, void* out,
                   int rows, int n, int vec, float eps, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const R* rt = static_cast<const R*>(res);
  T* ot = static_cast<T*>(out);
  const float inv_n = static_cast<float>(1.0 / n);   // the TPU kernel's 1.0 / n_valid
  int threads, slots;
  plan<T>(n, &threads, &slots);
#define QG_LN(S) \
  layernorm_kernel<T, R, S><<<rows, threads, 0, s>>>(xt, rt, g, b, ot, n, vec, inv_n, eps)
  switch (slots) {
    case 1: QG_LN(1); break;
    case 2: QG_LN(2); break;
    case 4: QG_LN(4); break;
    case 8: QG_LN(8); break;
    default:
      layernorm_loop_kernel<T, R><<<rows, threads, 0, s>>>(xt, rt, g, b, ot, n, inv_n, eps);
  }
#undef QG_LN
  return cudaGetLastError();
}

}  // namespace

// x, out [rows, n] contiguous (dtype 0 = f32, 1 = bf16); residual [rows, n]
// (res_dtype 0 = f32, 1 = bf16) or null; gamma, beta f32 [n] or null; vec =
// 1 when n is a multiple of the 16-byte vector of both x's and the
// residual's dtype and every row pointer is then 16-byte aligned.
// Returns cudaGetLastError().
extern "C" int qgemm_layernorm_residual(const void* x, const void* residual,
                                        const void* gamma, const void* beta, void* out,
                                        int dtype, int res_dtype, int rows, int n, int vec,
                                        float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0 && res_dtype == 0)
    e = launch<float, float>(x, residual, g, b, out, rows, n, vec, eps, s);
  else if (dtype == 0 && res_dtype == 1)
    e = launch<float, __nv_bfloat16>(x, residual, g, b, out, rows, n, vec, eps, s);
  else if (dtype == 1 && res_dtype == 0)
    e = launch<__nv_bfloat16, float>(x, residual, g, b, out, rows, n, vec, eps, s);
  else if (dtype == 1 && res_dtype == 1)
    e = launch<__nv_bfloat16, __nv_bfloat16>(x, residual, g, b, out, rows, n, vec, eps, s);
  return static_cast<int>(e);
}
