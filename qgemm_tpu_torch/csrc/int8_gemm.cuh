// The fused row-quantize -> int8 GEMM -> dequant kernels shared by K1
// (quantized_matmul.cu, one matrix) and K8 (expert_matmul.cu, a batch of
// expert matrices, one per blockIdx.y / blockIdx.z). A grid's y and z stop
// at 65,535, so past that many experts the host launches the kernels once
// per 65,535 experts, the operands' pointers (and tensor maps) advanced to
// the chunk's first expert: the kernels' code is the same at every count.
//
//   out[e, m, n] = (acc[e, m, n] * (cx[e, m] / 127^2)) * cw[e, n],
//   acc = sum_k q(x[e, m, k]) * wq[e, k, n]   (exact, int32),
//   q(x) = clip(rint(x * (127 / cx[e, m])), -127, 127),  cx[e, m] = max|x[e, m, :]|,
//
// then max(out, 0) when relu is set. Operands are contiguous batches: x
// [E, m, k] (f32 or bf16), K-major weights wt [E, n, k] int8, cw [E, n],
// out [E, m, n]; E = 1 is K1's single matrix.
//
// What bounds it on the H100: at decode (m <= 16) the weight stream, every
// int8 weight byte read once for ~2 int8 operations per byte, far under the
// card's 1979 TOP/s : 3.35 TB/s balance; at prefill (m = a prompt bucket of
// 128-512 rows) the tensor-core rate. Measured on an H100 80GB HBM3 at 700
// W at m 8 (PERF.md), the decode call (pre-pass and GEMV) reaches 0.35 of
// the byte bound at k = n = 4096, where two launches' latency outweighs the
// 5 us stream, 0.57-0.66 at the FFN shapes and 0.81 at the lm_head; the
// GEMV alone streams at 72-87 % of 3.35 TB/s at the larger shapes. At m 512
// the call (pre-pass and tile kernel) reaches 0.27 of the operations bound
// at k = n = 4096 and 0.39-0.44 at the FFN shapes and the lm_head, 1.0-1.1x
// the time of cuBLAS's int8 product alone (torch._int_mm, no quantize, no
// dequant); the tile kernel alone runs at 700-1050 TOP/s. Neither its K
// ring's depth nor the bytes it brings in set that: halving the bytes (X's
// tiles only) or the ring (4 stages) moved it by 0-13 %.
//
// Design:
//   * one pre-pass (row_quantize.cuh, one block per row) writes cx and the
//     int8 codes xq [E * m, k] with the plain version's f32 operations; both
//     GEMM kernels read only codes;
//   * weights are stored K-major ([n, k]), so W and X load as 16-byte
//     vectors along K;
//   * m <= 16, the decode GEMV (qmm_gemv_kernel): mma.sync m16n8k32 with W
//     as the A operand (16 output columns x 32 K) and X^T as B (8 rows; two
//     n8 tiles for m 9-16). The int32 sum does not depend on the order of K,
//     so a lane loads 16 contiguous bytes of a column straight from device
//     memory into its A registers (bytes 16t..16t+15 of each 64-code step
//     stand for the fragment's k 4t..4t+3 and 16+4t..16+4t+3 of two k32
//     products) and the X fragment is one 16-byte load of the same bytes of
//     its row: no shared-memory staging of W, no shuffles. A block holds 16
//     output columns; each warp owns a K slice (a multiple of 64 codes) and
//     walks it in batches of 256 codes, 8 weight and 4 X loads of 16 bytes
//     per lane in flight at a time (4 KB of weights a warp; at m <= 8, 74
//     registers, three blocks and ~96 KB a SM);
//     no block barrier stands in the K loop. The warps' int32 partials meet
//     once in shared memory. The GEMV is launched with programmatic
//     dependent launch: it starts while the pre-pass runs, prefetches its
//     first batch of weights into L2 and waits for the codes with
//     griddepcontrol.wait. The launch plan (warps, K slice, shared memory)
//     comes from ops/cuda/gemv_plan.py and is checked here;
//   * m > 16, the tile kernel (qmm_wgmma_kernel<BM, BN>): wgmma m64nBNk32
//     s8 -> s32 from shared memory, one consumer warpgroup per 64 rows, fed
//     by one producer warp through a ring of up to 8 stages of 128 K codes
//     (TMA loads of X's codes and W's, 128-byte swizzle, full and empty
//     mbarriers); the int32 accumulator stays in registers over all of K,
//     and the epilogue applies the f32 steps to it once. Tiles 64 x 32 to
//     128 x 256; the plan (ops/cuda/tile_plan.py) takes the fewest stage
//     bytes per wave of blocks, and row blocks are fastest in the grid, so a
//     weight tile is read from device memory once per call;
//   * int32 accumulation is exact, so every tiling gives the same bits —
//     a row's result does not depend on m or on which kernel ran;
//   * ragged m, n and k edges are masked in the GEMV and zero-filled by TMA
//     in the tile kernel (the 50272 vocab is not a multiple of the tile); k
//     must be a multiple of 16 (TMA's 16-byte row pitch): the
//     wrappers zero-pad x and W along K on the calls where it is not (no
//     model of the repo takes that path at full width), since zeros
//     change neither the row absmax nor the int32 sums. A row of zeros (an empty
//     expert capacity slot) has cx = 1e-12, codes 0 and output exactly 0.
#pragma once

#include "mma.cuh"
#include "row_quantize.cuh"
#include "wgmma.cuh"

namespace qg {
namespace gemm {

__device__ __forceinline__ float epilogue(int acc, float cx, float cw, int relu) {
  const float v = (static_cast<float>(acc) * (cx * (1.0f / (kQRange * kQRange)))) * cw;
  return relu ? fmaxf(v, 0.f) : v;
}

__device__ __forceinline__ uint32_t u32(int v) { return static_cast<uint32_t>(v); }

// ------------------------------------------------------- m <= 16 rows: GEMV
constexpr int kGvStep = 64;        // K codes per lane step: two k32 products
constexpr int kGvBatch = 4;        // steps whose X fragments a warp holds (256 codes)
constexpr int kGvMaxWarps = 8;

// grid (ceil(n / 16), E), 32 * warps threads; warp w takes K codes
// [w * k_slice, min(k, (w + 1) * k_slice)) of the block's 16 columns.
// Dynamic shared memory: int32 partials [warps][16 columns][8 * NR rows].
template <int NR>
__global__ void __launch_bounds__(32 * kGvMaxWarps)
qmm_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ cx,
                const int8_t* __restrict__ wt, const float* __restrict__ cw,
                float* __restrict__ out, int m, int n, int k, int k_slice, int relu) {
  constexpr int R = 8 * NR;
  extern __shared__ int part[];
  const size_t e = blockIdx.y;
  xq += e * m * k;
  cx += e * m;
  wt += e * n * k;
  cw += e * n;
  out += e * m * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * 16, col = col0 + g;
  const int kb = warp * k_slice, ke = min(k, kb + k_slice);
  // while the pre-pass may still run: the warp's first batch of weights into L2
  if (lane < 16 && col0 + lane < n && kb < ke)
    prefetch_l2(wt + static_cast<size_t>(col0 + lane) * k + kb,
                min(kGvBatch * kGvStep, ke - kb));
  grid_dependency_wait();   // the pre-pass's codes and scales are written

  int acc[NR][4];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0;
  const int8_t* wa = wt + static_cast<size_t>(col) * k;   // columns g and g + 8
  const int8_t* wb = wa + static_cast<size_t>(8) * k;
  for (int k0 = kb; k0 < ke; k0 += kGvBatch * kGvStep) {
    // A fragments: bytes [16t, 16t + 16) of each step of columns g and g + 8;
    // B fragments: the same bytes of rows g and g + 8
    int4 va[kGvBatch], vb[kGvBatch], xf[NR][kGvBatch];
#pragma unroll
    for (int s = 0; s < kGvBatch; ++s) {
      const int kk = k0 + s * kGvStep + 16 * t;
      va[s] = load16(wa + kk, col < n && kk < ke);
      vb[s] = load16(wb + kk, col + 8 < n && kk < ke);
#pragma unroll
      for (int r = 0; r < NR; ++r)
        xf[r][s] = load16(xq + static_cast<size_t>(g + 8 * r) * k + kk, g + 8 * r < m && kk < ke);
    }
#pragma unroll
    for (int s = 0; s < kGvBatch; ++s) {
      const uint32_t a0[4] = {u32(va[s].x), u32(vb[s].x), u32(va[s].y), u32(vb[s].y)};
      const uint32_t a1[4] = {u32(va[s].z), u32(vb[s].z), u32(va[s].w), u32(vb[s].w)};
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const uint32_t b0[2] = {u32(xf[r][s].x), u32(xf[r][s].y)};
        const uint32_t b1[2] = {u32(xf[r][s].z), u32(xf[r][s].w)};
        mma_s8(acc[r], a0, b0);
        mma_s8(acc[r], a1, b1);
      }
    }
  }

  // C fragment: (column g, rows 2t, 2t + 1) and (column g + 8, the same rows)
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    int* p = part + (static_cast<size_t>(warp) * 16 + g) * R + 8 * r + 2 * t;
    *reinterpret_cast<int2*>(p) = make_int2(acc[r][0], acc[r][1]);
    *reinterpret_cast<int2*>(p + 8 * R) = make_int2(acc[r][2], acc[r][3]);
  }
  __syncthreads();
  const int warps = blockDim.x >> 5;
  for (int i = threadIdx.x; i < 16 * m; i += blockDim.x) {
    const int cl = i / m, row = i % m, c = col0 + cl;
    if (c >= n) continue;
    int sum = 0;
    for (int w = 0; w < warps; ++w) sum += part[(static_cast<size_t>(w) * 16 + cl) * R + row];
    out[static_cast<size_t>(row) * n + c] = epilogue(sum, cx[row], cw[c], relu);
  }
}

// ------------------------------------------------------------ m > 16 rows
// The tile kernel: a block computes BM rows x BN columns of one batch
// (expert) with BM / 64 consumer warpgroups (warps 0 .. 4 BM/64 - 1, each 64
// rows on wgmma m64nBNk32, the whole accumulator in registers) and one
// producer warp (the last). The producer's lane 0 keeps a ring of STAGES
// stages full: each stage is the X codes' tile [BM rows x 128 codes] and the
// weights' tile [BN columns x 128 codes], both by TMA in the 128-byte
// swizzle, completing on the stage's full barrier; each consumer warp
// arrives on the stage's empty barrier once its products have read it.
// TMA reads zeros outside the tensors, so ragged m, n and k need no masks
// in the main loop; the 3-D maps [E, rows, k] keep a tile inside its
// expert.
template <int BM, int BN> struct TileCfg {
  static constexpr int kConsumers = BM / 64;
  static constexpr int kThreads = 128 * kConsumers + 32;
  static constexpr int kStage = (BM + BN) * sm90::kStepK;
  static constexpr int kStages = sm90::ring_stages(kStage);
  static constexpr int kSmem = sm90::kAlign + kStages * kStage;
};

// grid (ceil(m / BM), ceil(n / BN), E): the row blocks of one column block
// are neighbours in launch order, so they run together and read each weight
// tile from device memory once (a weight matrix of 64-206 MB does not stay
// in the 50 MB L2 between waves). TileCfg<BM, BN>::kSmem bytes of dynamic
// shared memory. Launched with programmatic dependent launch: the producer
// asks for the first stages' weights before it waits for the pre-pass's
// codes.
template <int BM, int BN>
__global__ void __launch_bounds__(TileCfg<BM, BN>::kThreads, 1)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                 const float* __restrict__ cx, const float* __restrict__ cw,
                 float* __restrict__ out, int m, int n, int k, int relu) {
  using C = TileCfg<BM, BN>;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[S], empty[S];
  uint8_t* tiles = sm90::aligned_smem(smem_raw);   // stage s: X tile, then W tile
  const int e = blockIdx.z, row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int steps = (k + sm90::kStepK - 1) / sm90::kStepK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4 * C::kConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * C::kConsumers) {   // producer
    if (lane == 0) {
      auto x_tile = [&](int s) { return tiles + s * C::kStage; };
      auto w_tile = [&](int s) { return tiles + s * C::kStage + BM * sm90::kStepK; };
      const int pre = min(steps, S);
      for (int i = 0; i < pre; ++i) {   // weights first: they do not wait for the pre-pass
        sm90::mbar_expect_tx(&full[i], C::kStage);
        sm90::tma_load_3d(w_tile(i), &tw, &full[i], i * sm90::kStepK, col0, e);
      }
      grid_dependency_wait();
      for (int i = 0; i < pre; ++i)
        sm90::tma_load_3d(x_tile(i), &tx, &full[i], i * sm90::kStepK, row0, e);
      for (int i = pre; i < steps; ++i) {
        const int s = i % S;
        sm90::mbar_wait(&empty[s], ((i / S) + 1) & 1);   // its previous load was read
        sm90::mbar_expect_tx(&full[s], C::kStage);
        sm90::tma_load_3d(w_tile(s), &tw, &full[s], i * sm90::kStepK, col0, e);
        sm90::tma_load_3d(x_tile(s), &tx, &full[s], i * sm90::kStepK, row0, e);
      }
    }
  } else {
    // consumer warpgroup wg: rows [64 wg, 64 wg + 64) of the block's tile
    const int wg = warp >> 2;
    grid_dependency_wait();   // cx is the pre-pass's
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int i = 0; i < steps; ++i) {
      const int s = i % S;
      sm90::mbar_wait(&full[s], (i / S) & 1);
      const uint8_t* stage = tiles + s * C::kStage;
      const uint64_t da = sm90::desc_sw128(stage + 64 * wg * sm90::kStepK);
      const uint64_t db = sm90::desc_sw128(stage + BM * sm90::kStepK);
      sm90::wgmma_fence();
      sm90::fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_ss(acc, sm90::desc_k32(da, kk), sm90::desc_k32(db, kk), i > 0 || kk > 0);
      sm90::wgmma_commit();
      sm90::fence_regs(acc);
      // one step's products stay in flight; the step before them has read its stage
      sm90::wgmma_wait<1>();
      if (i > 0) {
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[(i - 1) % S]);
      }
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);

    // epilogue: d[4j + q] is (row g + 8 (q >> 1), column 8j + 2t + (q & 1))
    const int g = lane >> 2, t = lane & 3;
    const int r0 = row0 + 64 * wg + 16 * (warp & 3) + g;
    const size_t base = static_cast<size_t>(e) * m;
    const float* cwe = cw + static_cast<size_t>(e) * n;
    float* oute = out + base * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= m) continue;
      const float c = cx[base + r];
      float* orow = oute + static_cast<size_t>(r) * n;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = col0 + 8 * j + 2 * t;
        if (col >= n) continue;
        const float v0 = epilogue(acc[4 * j + 2 * h], c, __ldg(cwe + col), relu);
        if (col + 1 < n) {
          const float v1 = epilogue(acc[4 * j + 2 * h + 1], c, __ldg(cwe + col + 1), relu);
          if (n % 2 == 0)
            *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
          else {
            orow[col] = v0;
            orow[col + 1] = v1;
          }
        } else {
          orow[col] = v0;
        }
      }
    }
  }
}

// The tile kernel's compiled instantiations (rows, columns), as
// ops/cuda/tile_plan.py lists them: its plan names one and its shared memory.
struct TilePlan {
  int bm, bn, smem;
};

// the most experts one launch takes: a grid's y and z stop at 65,535
constexpr int kMaxGridBatches = 65535;

template <int BM, int BN>
cudaError_t launch_tile(const int8_t* xq, const float* cx, const int8_t* wt, const float* cw,
                        float* out, int batches, int m, int n, int k, int relu, cudaStream_t s) {
  using C = TileCfg<BM, BN>;
  cudaError_t e =
      sm90::allow_smem(reinterpret_cast<const void*>(qmm_wgmma_kernel<BM, BN>), C::kSmem);
  if (e != cudaSuccess) return e;
  for (int e0 = 0; e0 < batches; e0 += kMaxGridBatches) {   // one launch per 65,535 experts
    const int nb = min(kMaxGridBatches, batches - e0);
    const size_t b0 = e0;
    CUtensorMap tx, tw;
    if (!sm90::int8_map(&tx, xq + b0 * m * k, k, m, nb, k, sm90::kStepK, BM,
                        CU_TENSOR_MAP_SWIZZLE_128B) ||
        !sm90::int8_map(&tw, wt + b0 * n * k, k, n, nb, k, sm90::kStepK, BN,
                        CU_TENSOR_MAP_SWIZZLE_128B))
      return cudaErrorInvalidValue;
    const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN, nb);
    e = launch_pdl(qmm_wgmma_kernel<BM, BN>, grid, dim3(C::kThreads), C::kSmem, s, tx, tw,
                   cx + b0 * m, cw + b0 * n, out + b0 * m * n, m, n, k, relu);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

#define QG_INT8_TILES(X) X(64, 32) X(64, 64) X(64, 128) X(64, 256) X(128, 128) X(128, 256)

inline cudaError_t launch_tile(const TilePlan& p, const int8_t* xq, const float* cx,
                               const int8_t* wt, const float* cw, float* out, int batches, int m,
                               int n, int k, int relu, cudaStream_t s) {
#define QG_TILE(BM, BN)                                                                   \
  if (p.bm == BM && p.bn == BN)                                                           \
    return p.smem == TileCfg<BM, BN>::kSmem                                               \
               ? launch_tile<BM, BN>(xq, cx, wt, cw, out, batches, m, n, k, relu, s)      \
               : cudaErrorInvalidValue;
  QG_INT8_TILES(QG_TILE)
#undef QG_TILE
  return cudaErrorInvalidValue;
}

// The GEMV's launch plan (ops/cuda/gemv_plan.py): warps per block, K codes
// per warp, dynamic shared memory in bytes.
struct GemvPlan {
  int warps, k_slice, smem;
};

inline bool plan_ok(const GemvPlan& p, int m, int k) {
  const int nr = m <= 8 ? 1 : 2;
  return p.warps >= 1 && p.warps <= kGvMaxWarps && p.k_slice > 0 && p.k_slice % kGvStep == 0 &&
         static_cast<long long>(p.k_slice) * p.warps >= k &&
         static_cast<long long>(p.k_slice) * (p.warps - 1) < k &&
         p.smem == 4 * p.warps * 16 * 8 * nr;
}

template <int NR>
cudaError_t launch_gemv(const int8_t* xq, const float* cx, const int8_t* wt, const float* cw,
                        float* out, int batches, int m, int n, int k, int relu,
                        const GemvPlan& p, cudaStream_t s) {
  for (int e0 = 0; e0 < batches; e0 += kMaxGridBatches) {   // one launch per 65,535 experts
    const size_t b0 = e0;
    const dim3 grid((n + 15) / 16, min(kMaxGridBatches, batches - e0));
    const cudaError_t e = launch_pdl(qmm_gemv_kernel<NR>, grid, dim3(32 * p.warps), p.smem, s,
                                     xq + b0 * m * k, cx + b0 * m, wt + b0 * n * k,
                                     cw + b0 * n, out + b0 * m * n, m, n, k, p.k_slice, relu);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// E batches of [m, k] x [k, n]; xq [E * m, k] and cx [E * m] are scratch for
// the pre-pass's codes and row scales. ``given_cx`` [E * m], where not null,
// holds the caller's row scales: the pre-pass quantizes with them and the
// GEMM reads them in place of cx, which stays unwritten.
template <typename T>
cudaError_t launch(const T* x, const int8_t* wt, const float* cw, int8_t* xq, float* cx,
                   float* out, int batches, int m, int n, int k, int truncate, int relu,
                   const GemvPlan& p, const TilePlan& tp, cudaStream_t s,
                   const float* given_cx) {
  if (m <= 16 && !plan_ok(p, m, k)) return cudaErrorInvalidValue;
  row_quantize_kernel<T><<<batches * m, quant_threads(k), 0, s>>>(x, xq, cx, k, k, k, 1, 1,
                                                                  truncate, 1.f, given_cx);
  if (given_cx != nullptr) cx = const_cast<float*>(given_cx);
  cudaError_t e = cudaSuccess;
  if (m > 16) {
    e = launch_tile(tp, xq, cx, wt, cw, out, batches, m, n, k, relu, s);
  } else if (m <= 8) {
    e = launch_gemv<1>(xq, cx, wt, cw, out, batches, m, n, k, relu, p, s);
  } else {
    e = launch_gemv<2>(xq, cx, wt, cw, out, batches, m, n, k, relu, p, s);
  }
  return e != cudaSuccess ? e : cudaGetLastError();
}

// x_dtype 0 = f32, 1 = bf16; x 16-byte aligned
inline cudaError_t launch_any(const void* x, int x_dtype, const void* wt, const void* cw,
                              void* xq, void* cx, void* out, int batches, int m, int n, int k,
                              int truncate, int relu, const GemvPlan& p, const TilePlan& tp,
                              cudaStream_t s, const void* given_cx = nullptr) {
  if (batches <= 0 || m <= 0 || n <= 0 || k <= 0 || k % 16 != 0 ||
      static_cast<long long>(batches) * m > kMaxGridX)   // the pre-pass: a block a row
    return cudaErrorInvalidValue;
  const auto* w8 = static_cast<const int8_t*>(wt);
  const auto* cwf = static_cast<const float*>(cw);
  auto* x8 = static_cast<int8_t*>(xq);
  auto* cxf = static_cast<float*>(cx);
  auto* of = static_cast<float*>(out);
  const auto* gcx = static_cast<const float*>(given_cx);
  if (x_dtype == 0)
    return launch(static_cast<const float*>(x), w8, cwf, x8, cxf, of, batches, m, n, k,
                  truncate, relu, p, tp, s, gcx);
  if (x_dtype == 1)
    return launch(static_cast<const __nv_bfloat16*>(x), w8, cwf, x8, cxf, of, batches, m, n,
                  k, truncate, relu, p, tp, s, gcx);
  return cudaErrorInvalidValue;
}

}  // namespace gemm
}  // namespace qg
