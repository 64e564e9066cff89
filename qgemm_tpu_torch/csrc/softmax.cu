// Row softmax over the last axis for Hopper (sm_90a): the kernel of row 14.
//
// Replaces _softmax_kernel / softmax_pallas of
// qgemm_tpu/ops/pallas/softmax.py. Same math, in f32 whatever x's dtype:
// m = max(x), e = exp(x - m), s = sum(e), out = e / s as a true division,
// stored in x's dtype. Lanes past the row's width are -inf, as the TPU
// kernel masks its padded lanes, so they add exp(-inf) = 0 to the sum.
//
// What bounds it on the H100: bytes. The row is read once and written
// once (8 bytes an element in f32, 4 in bf16) against ~5 flops an element.
//
// Design: one block per row, the row in registers (row_ops.cuh): 16-byte
// vector loads where the width allows, one block-wide max and one
// block-wide sum (warp shuffles, then 32 floats of shared memory), the
// quotient stored from the same registers. Rows too wide for the
// registers (beyond 8 slots of 1024 threads) run the loop variant, which
// reads the row three times.
#include "row_ops.cuh"

namespace {

using namespace qg::rows;

template <typename T, int SLOTS>
__global__ void softmax_kernel(const T* __restrict__ x, T* __restrict__ out, int n, int vec) {
  constexpr int V = Vec<T>::N;
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * n;
  T* orow = out + row * n;
  float v[SLOTS][V];
  float mx = neg_inf();
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const int e0 = (threadIdx.x + i * blockDim.x) * V;
    load_slot(xr, e0, n, vec, neg_inf(), v[i]);
#pragma unroll
    for (int j = 0; j < V; ++j) mx = fmaxf(mx, v[i][j]);
  }
  mx = block_reduce<true>(mx, red);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      v[i][j] = expf(v[i][j] - mx);
      sum += v[i][j];
    }
  sum = block_reduce<false>(sum, red);
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const int e0 = (threadIdx.x + i * blockDim.x) * V;
#pragma unroll
    for (int j = 0; j < V; ++j) v[i][j] = v[i][j] / sum;
    store_slot(orow, e0, n, vec, v[i]);
  }
}

// rows wider than the registers hold: three passes over device memory
template <typename T>
__global__ void softmax_loop_kernel(const T* __restrict__ x, T* __restrict__ out, int n) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * n;
  T* orow = out + row * n;
  float mx = neg_inf();
  for (int e = threadIdx.x; e < n; e += blockDim.x) mx = fmaxf(mx, qg::to_f32(xr[e]));
  mx = block_reduce<true>(mx, red);
  float sum = 0.f;
  for (int e = threadIdx.x; e < n; e += blockDim.x) sum += expf(qg::to_f32(xr[e]) - mx);
  sum = block_reduce<false>(sum, red);
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    orow[e] = qg::from_f32<T>(expf(qg::to_f32(xr[e]) - mx) / sum);
}

template <typename T>
cudaError_t launch(const void* x, void* out, int rows, int n, int vec, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  int threads, slots;
  plan<T>(n, &threads, &slots);
  switch (slots) {
    case 1: softmax_kernel<T, 1><<<rows, threads, 0, s>>>(xt, ot, n, vec); break;
    case 2: softmax_kernel<T, 2><<<rows, threads, 0, s>>>(xt, ot, n, vec); break;
    case 4: softmax_kernel<T, 4><<<rows, threads, 0, s>>>(xt, ot, n, vec); break;
    case 8: softmax_kernel<T, 8><<<rows, threads, 0, s>>>(xt, ot, n, vec); break;
    default: softmax_loop_kernel<T><<<rows, threads, 0, s>>>(xt, ot, n); break;
  }
  return cudaGetLastError();
}

}  // namespace

// x, out [rows, n] contiguous, dtype 0 = f32, 1 = bf16; vec = 1 when n is a
// multiple of the 16-byte vector and both pointers are 16-byte aligned.
// Returns cudaGetLastError().
extern "C" int qgemm_softmax(const void* x, void* out, int dtype, int rows, int n, int vec,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return static_cast<int>(launch<float>(x, out, rows, n, vec, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(x, out, rows, n, vec, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
