// Kernel K2: one decode step (Sq = 1) of attention over the dense KV cache
// [B, Hkv, S, d], int8 with per-position f32 scales or float, for Hopper
// (sm_90a).
//
// Replaces _decode_kernel / decode_attention of
// qgemm_tpu/ops/pallas/decode_attention.py. Same math:
//   s_j = (bf16(q) . bf16(k_j)) * (1/sqrt(d)) * (kc_j / 127),   j < len_b,
//   softmax in f32; p_j * (vc_j / 127) rounded to bf16 before the V
//   product; out = acc / max(l, 1e-30).
// A float cache uses its own dtype for the two products (bf16 rounds like
// the int8 cache, f32 does not round) and no scales.
//
// What bounds it on the H100: the cache read. Each step streams K and V of
// every valid position once (2 * d bytes per position and KV head for
// int8, and two f32 scales) against ~4 * d flops per position and query
// head: far under the card's flop:byte balance. So the design is about
// bytes in flight. The first K2 ran one block per (slot, KV head), a lane
// owning a whole K row, each block one long dependent chain over all of
// its slot's positions: at 8 slots and 32 heads, 256 blocks and a few KB in
// flight per SM.
//
// Design, int8 cache (the route every model path launches): flash-decoding
// on K5's split body (split_decode.cuh). One block of 4 warps per (slot *
// KV head, split of 128 positions from position 0, 64 at D 1024); the
// grid (slot * KV head, split; a launch per 65,535 splits) and its split count
// follows the cache extent S, which the host knows, while the lengths stay
// on the device and a block past its slot's length exits at once. A block
// stages its split's K and V code rows and scales in shared memory by
// cp.async (16 KB each at D 128), computes its partial state, and the last
// block of a (slot, KV head) merges the states in split order: one launch.
// The splits depend only on positions, so a slot's result depends neither
// on S nor on the other slots; and since K5 runs the same body over the
// same positions, K2 equals K5 bit for bit on the same int8 rows in pages
// of at most 128. The scale rows of a (slot, KV head) start bh * S * 4 bytes
// in, which is 16-byte aligned only where S is a multiple of 4 (generate
// keeps the exact extent): they are copied 4 bytes a position otherwise,
// and code rows of a width d not a multiple of 16 byte by byte. The launch
// plan (splits, grid, shared memory) comes from qgemm_tpu_torch/ops/cuda/
// decode_plan.py; the entry refuses any other.
//
// The bf16 and f32 caches, which no model path launches, keep the first
// design (decode_kernel below): one block per (slot, KV head) whose 4 warps
// take 32-position tiles in turn, a lane owning a position's K row for the
// scores and 4 columns for P V, the warps' states merged in a fixed order.
//
// Head widths: compiled for D in {32, 64, 128, 256, 512, 1024}, reading a cache of
// true width d <= D (columns past d read as zeros). The wrapper zero-pads
// the per-call q to D and slices the output, and passes the softmax scale
// of the true d; the cache, which persists across steps, is never copied.
// At D 256 a block stages 64 KB of int8 code rows (two blocks an SM), at
// D 512 128 KB and at D 1024, in splits of 64, 128 KB (one block an SM).
//
// GQA groups: any g >= 1. The int8 route runs the split body's row tiles
// (split_decode.cuh: one pass of g rows for g in {1, 2, 4, 8}, else passes
// of 8 rows over the staged split, 4 at D 1024); the float route's block
// takes G = 8 rows of the group (one past D 256, where its static arrays
// hold G rows of D floats), ceil(g / G) blocks per (slot, KV head), each
// block reading the cache itself: no model path launches it.
#include <type_traits>

#include "split_decode.cuh"

namespace {

namespace sd = qg::split_decode;

// the int8 route: one block per (slot * KV head, split of SP positions)
template <int D, int G, bool PASSES>
__global__ void __launch_bounds__(sd::kThreads)
dense_decode_split_kernel(const void* __restrict__ q, const int8_t* __restrict__ k,
                          const float* __restrict__ kc, const int8_t* __restrict__ v,
                          const float* __restrict__ vc, const int* __restrict__ lengths,
                          void* __restrict__ out, float* __restrict__ scratch,
                          int* __restrict__ counters, int q_bf16, int hkv, int S, int dt,
                          int codes16, int scales16, int nsplit, int split0, float scale,
                          int ng) {
  const int bh = blockIdx.x;
  const size_t r0 = static_cast<size_t>(bh) * S;   // this (slot, KV head)'s first row
  const sd::DenseRows<D> rows{k + r0 * dt, kc + r0, v + r0 * dt, vc + r0, dt, codes16 != 0,
                              scales16 != 0};
  sd::decode_split<8, D, G, PASSES>(rows, q, out, scratch, counters, q_bf16, bh,
                                    blockIdx.y + split0,
                                    nsplit, min(lengths[bh / hkv], S), scale, ng);
}

template <int D, int G, bool PASSES>
cudaError_t launch_split(const void* q, const int8_t* k, const float* kc, const int8_t* v,
                         const float* vc, const int* len, void* out, float* scratch,
                         int* counters, int q_bf16, int B, int hkv, int ng, int S, int dt,
                         int codes16, int scales16, int nsplit, float scale, cudaStream_t s) {
  const int smem = sd::smem_bytes(8, D, G, sd::split_positions(D));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(dense_decode_split_kernel<D, G, PASSES>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               smem);
    if (e != cudaSuccess) return e;
  }
  for (int s0 = 0; s0 < nsplit; s0 += sd::kMaxGridSplits) {   // a launch per 65,535 splits
    dense_decode_split_kernel<D, G, PASSES>
        <<<dim3(B * hkv, min(sd::kMaxGridSplits, nsplit - s0)), sd::kThreads, smem, s>>>(
            q, k, kc, v, vc, len, out, scratch, counters, q_bf16, hkv, S, dt, codes16, scales16,
            nsplit, s0, scale, ng);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// the group's row tile: one pass of g rows, or passes of the width's most
// rows (sd::row_tile)
template <int D>
cudaError_t launch_split_g(int G, const void* q, const int8_t* k, const float* kc,
                           const int8_t* v, const float* vc, const int* len, void* out,
                           float* scratch, int* counters, int q_bf16, int B, int hkv, int S,
                           int dt, int codes16, int scales16, int nsplit, float scale,
                           cudaStream_t s) {
#define QG_K2(T, P) launch_split<D, T, P>(q, k, kc, v, vc, len, out, scratch, counters, q_bf16, B, hkv, G, S, dt, codes16, scales16, nsplit, scale, s)
  const int tile = sd::row_tile(G, D);
  if constexpr (sd::max_rows(D) >= 8) {
    if (tile != G) return QG_K2(8, true);
    if (tile == 8) return QG_K2(8, false);
  } else {
    if (tile != G) return QG_K2(sd::max_rows(D), true);
  }
  if (tile == 4) return QG_K2(4, false);
  if (tile == 2) return QG_K2(2, false);
  return QG_K2(1, false);
#undef QG_K2
}

// ---------------------------------------------------- the float caches (the first design)

constexpr int kWarps = 4;
constexpr int kTile = 32;
constexpr float kNegInf = -1e30f;

// rows g0 = (the block's pass) * G .. g0 + G - 1 of the ng query heads of a KV head
template <typename KT, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const float* __restrict__ q, const KT* __restrict__ kcache,
              const KT* __restrict__ vcache, const int* __restrict__ lengths,
              float* __restrict__ out, int hkv, int S, int d, float scale, int ng) {
  constexpr bool kRound = !std::is_same<KT, float>::value;  // bf16 products
  constexpr int VPL = D / 32;                               // columns per lane
  __shared__ __align__(16) float qs[G][D];
  __shared__ float pbuf[kWarps][G][kTile];
  __shared__ float wm[kWarps][G], wl[kWarps][G];
  __shared__ float wacc[kWarps][G][D];

  const qg::FlatIdx blk = qg::flat_block(static_cast<int>(gridDim.x / ((ng + G - 1) / G)));
  const int bh = blk.i;  // slot * hkv + kv head
  const int b = bh / hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g0 = blk.o * G, rows_live = min(G, ng - g0);   // zeros past the group
  const size_t row0 = (static_cast<size_t>(bh) * ng + g0) * D;
  for (int i = threadIdx.x; i < G * D; i += kWarps * 32) {
    const float v = i / D < rows_live ? q[row0 + i] : 0.f;
    qs[i / D][i % D] = kRound ? qg::bf16_round(v) : v;
  }
  __syncthreads();

  const int len = min(lengths[b], S);
  const bool full = d == D;                                 // vector loads
  const KT* kbase = kcache + static_cast<size_t>(bh) * S * d;
  const KT* vbase = vcache + static_cast<size_t>(bh) * S * d;
  float m_run[G], l_run[G], acc[G][VPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_run[g] = kNegInf;
    l_run[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) acc[g][i] = 0.f;
  }

  for (int t0 = warp * kTile; t0 < len; t0 += kWarps * kTile) {
    const int j = t0 + lane;
    const bool valid = j < len;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (valid) {
      const KT* kr = kbase + static_cast<size_t>(j) * d;
#pragma unroll 4
      for (int d0 = 0; d0 < D; d0 += 8) {
        float kv[8];
        if (!full) {
#pragma unroll
          for (int e = 0; e < 8; ++e) kv[e] = d0 + e < d ? qg::to_f32(kr[d0 + e]) : 0.f;
        } else {
          qg::load8(kr + d0, kv);
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e) s[g] = fmaf(qs[g][d0 + e], kv[e], s[g]);
      }
    }
    float alpha[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float sg = valid ? s[g] * scale : kNegInf;
      const float m_new = fmaxf(m_run[g], qg::warp_max(sg));
      const float p = valid ? expf(sg - m_new) : 0.f;
      alpha[g] = expf(m_run[g] - m_new);
      l_run[g] = l_run[g] * alpha[g] + qg::warp_sum(p);
      m_run[g] = m_new;
      pbuf[warp][g][lane] = kRound ? qg::bf16_round(p) : p;
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < VPL; ++i) acc[g][i] *= alpha[g];
    const int nrow = min(kTile, len - t0);
    for (int jj = 0; jj < nrow; ++jj) {
      const KT* vr = vbase + static_cast<size_t>(t0 + jj) * d + lane * VPL;
      float vv[VPL];
#pragma unroll
      for (int i = 0; i < VPL; ++i) vv[i] = lane * VPL + i < d ? qg::to_f32(vr[i]) : 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pj = pbuf[warp][g][jj];
#pragma unroll
        for (int i = 0; i < VPL; ++i) acc[g][i] = fmaf(pj, vv[i], acc[g][i]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      wm[warp][g] = m_run[g];
      wl[warp][g] = l_run[g];
    }
#pragma unroll
    for (int i = 0; i < VPL; ++i) wacc[warp][g][lane * VPL + i] = acc[g][i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += kWarps * 32) {
    const int g = i / D, c = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w][g]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(wm[w][g] - mx);
      l += wl[w][g] * f;
      o += wacc[w][g][c] * f;
    }
    if (g < rows_live) out[row0 + i] = o / fmaxf(l, 1e-30f);
  }
}

// the float route's rows a block: sd::row_tile's up to D 256, one past it
// (qs and wacc hold G rows of D floats in static shared memory)
inline int float_row_tile(int g, int D) { return D > 256 ? 1 : sd::row_tile(g, 256); }

template <typename KT, int D>
cudaError_t launch_d(const float* q, const void* k, const void* v, const int* len, float* out,
                     int B, int hkv, int G, int S, int d, float scale, cudaStream_t s) {
  const KT* kk = static_cast<const KT*>(k);
  const KT* vv = static_cast<const KT*>(v);
  const int tile = float_row_tile(G, D);
  const dim3 grid(B * hkv * ((G + tile - 1) / tile)), block(kWarps * 32);
  if constexpr (D > 256) {
    decode_kernel<KT, D, 1><<<grid, block, 0, s>>>(q, kk, vv, len, out, hkv, S, d, scale, G);
  } else {
    switch (tile) {
      case 1: decode_kernel<KT, D, 1><<<grid, block, 0, s>>>(q, kk, vv, len, out, hkv, S, d, scale, G); break;
      case 2: decode_kernel<KT, D, 2><<<grid, block, 0, s>>>(q, kk, vv, len, out, hkv, S, d, scale, G); break;
      case 4: decode_kernel<KT, D, 4><<<grid, block, 0, s>>>(q, kk, vv, len, out, hkv, S, d, scale, G); break;
      default: decode_kernel<KT, D, 8><<<grid, block, 0, s>>>(q, kk, vv, len, out, hkv, S, d, scale, G); break;
    }
  }
  return cudaGetLastError();
}

template <typename KT>
cudaError_t launch_t(const float* q, const void* k, const void* v, const int* len, float* out,
                     int B, int hkv, int G, int S, int D, int d, float scale, cudaStream_t s) {
  if (d < 1 || d > D || G < 1 ||
      !qg::flat_grid_ok(static_cast<long long>(B) * hkv *
                        ((G + float_row_tile(G, D) - 1) / float_row_tile(G, D))))
    return cudaErrorInvalidValue;
  if (D == 32) return launch_d<KT, 32>(q, k, v, len, out, B, hkv, G, S, d, scale, s);
  if (D == 64) return launch_d<KT, 64>(q, k, v, len, out, B, hkv, G, S, d, scale, s);
  if (D == 128) return launch_d<KT, 128>(q, k, v, len, out, B, hkv, G, S, d, scale, s);
  if (D == 256) return launch_d<KT, 256>(q, k, v, len, out, B, hkv, G, S, d, scale, s);
  if (D == 512) return launch_d<KT, 512>(q, k, v, len, out, B, hkv, G, S, d, scale, s);
  if (D == 1024) return launch_d<KT, 1024>(q, k, v, len, out, B, hkv, G, S, d, scale, s);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* a, const void* b) {
  return (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 == 0;
}

}  // namespace

// The int8 cache. q [B, Hkv*G, D] float32 (dtype 0) or bfloat16 (dtype 1),
// D in {32, 64, 128, 256, 512, 1024}, zero past d, 16-byte aligned; k/v int8 [B, Hkv,
// S, d], d <= D; kc/vc f32 [B, Hkv, S]; lengths int32 [B]; out [B, Hkv*G, D]
// in q's dtype; scratch f32 [B * Hkv * nsplit * G * (D + 2)] (the partial
// states); counters int32 [>= B * Hkv], all 0 (each call leaves them 0).
// Any G >= 1. The plan (``decode_plan.k2_plan``): ``split_positions`` SP
// (128, 64 at D 1024), ``nsplit`` = ceil(S / SP) splits, ``smem`` bytes of dynamic shared
// memory at the group's row tile; any other is refused. Returns
// cudaGetLastError().
extern "C" int qgemm_decode_attention(const void* q, const void* k, const void* v,
                                      const void* kc, const void* vc, const void* lengths,
                                      void* out, void* scratch, void* counters, int dtype,
                                      int B, int hkv, int G, int S, int D, int d, float scale,
                                      int split_positions, int nsplit, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || hkv <= 0 || S <= 0 || d < 1 || d > D || (dtype != 0 && dtype != 1) ||
      (D != 32 && D != 64 && D != 128 && D != 256 && D != 512 && D != 1024) || G < 1 ||
      split_positions != sd::split_positions(D) ||
      nsplit != (S + split_positions - 1) / split_positions ||
      !qg::flat_grid_ok(static_cast<long long>(B) * hkv) ||
      smem != sd::smem_bytes(8, D, sd::row_tile(G, D), split_positions))
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* k8 = static_cast<const int8_t*>(k);
  const int8_t* v8 = static_cast<const int8_t*>(v);
  const float* kcf = static_cast<const float*>(kc);
  const float* vcf = static_cast<const float*>(vc);
  const int* len = static_cast<const int*>(lengths);
  float* sc = static_cast<float*>(scratch);
  int* cnt = static_cast<int*>(counters);
  const int codes16 = d % 16 == 0 && aligned16(k, v);
  const int scales16 = S % 4 == 0 && aligned16(kc, vc);
  cudaError_t e;
  if (D == 32) e = launch_split_g<32>(G, q, k8, kcf, v8, vcf, len, out, sc, cnt, dtype, B, hkv, S, d, codes16, scales16, nsplit, scale, s);
  else if (D == 64) e = launch_split_g<64>(G, q, k8, kcf, v8, vcf, len, out, sc, cnt, dtype, B, hkv, S, d, codes16, scales16, nsplit, scale, s);
  else if (D == 128) e = launch_split_g<128>(G, q, k8, kcf, v8, vcf, len, out, sc, cnt, dtype, B, hkv, S, d, codes16, scales16, nsplit, scale, s);
  else if (D == 256) e = launch_split_g<256>(G, q, k8, kcf, v8, vcf, len, out, sc, cnt, dtype, B, hkv, S, d, codes16, scales16, nsplit, scale, s);
  else if (D == 512) e = launch_split_g<512>(G, q, k8, kcf, v8, vcf, len, out, sc, cnt, dtype, B, hkv, S, d, codes16, scales16, nsplit, scale, s);
  else e = launch_split_g<1024>(G, q, k8, kcf, v8, vcf, len, out, sc, cnt, dtype, B, hkv, S, d, codes16, scales16, nsplit, scale, s);
  return static_cast<int>(e);
}

// The bf16 (kv_dtype 1) and f32 (kv_dtype 2) caches: q f32 [B, Hkv*G, D]
// (D in {32, 64, 128, 256, 512, 1024}, zero past d; any G >= 1); k/v [B, Hkv, S, d]
// with d <= D; lengths int32 [B]; out f32 [B, Hkv*G, D]. Returns
// cudaGetLastError().
extern "C" int qgemm_decode_attention_float(const void* q, const void* k, const void* v,
                                            const void* lengths, void* out, int kv_dtype,
                                            int B, int hkv, int G, int S, int D, int d,
                                            float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || hkv <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const int* len = static_cast<const int*>(lengths);
  float* o = static_cast<float*>(out);
  cudaError_t e;
  if (kv_dtype == 1)
    e = launch_t<__nv_bfloat16>(qf, k, v, len, o, B, hkv, G, S, D, d, scale, s);
  else if (kv_dtype == 2)
    e = launch_t<float>(qf, k, v, len, o, B, hkv, G, S, D, d, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
