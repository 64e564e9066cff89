// Kernel K2: one decode step (Sq = 1) of attention over the KV cache, int8
// with per-position scales or float, for Hopper (sm_90a).
//
// Replaces _decode_kernel / decode_attention of
// qgemm_tpu/ops/pallas/decode_attention.py. Same math:
//   s_j = (bf16(q) . bf16(k_j)) * (1/sqrt(D)) * (kc_j / 127),   j < len_b
//   online softmax in f32; p_j * (vc_j / 127) rounded to bf16 before the
//   V product; out = acc / max(l, 1e-30).
// A float cache uses its own dtype for the two products (bf16 rounds like
// the int8 cache, f32 does not round) and no scales.
//
// What bounds it on the H100: the cache read. Each step streams K and V of
// every valid position once (2 * D bytes per position and KV head for
// int8) against ~4 * D flops per position and query head — far under the
// card's flop:byte balance.
//
// Design: one block per (slot, KV head); its G = Hq / Hkv query rows (GQA)
// share every K/V row the block reads, so the cache is read once however
// many query heads use it. The block's 4 warps take 32-position tiles in
// turn; in a tile each lane owns one position (its whole K row, so the
// q.k dot needs no shuffles), the warp runs the online-softmax update for
// the tile, then lanes switch to owning 4 head-dim columns for the p.V
// product over the tile's rows (coalesced 128-byte row reads). Tiles stop at
// the slot's length, so only valid positions are read. The four warps'
// partial (max, sum, acc) states merge in a fixed order at the end; the
// split depends only on position indices, so a slot's result does not
// depend on the cache extent S or on the other slots.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kTile = 32;
constexpr float kNegInf = -1e30f;

template <typename KT, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const float* __restrict__ q, const KT* __restrict__ kcache,
              const KT* __restrict__ vcache, const float* __restrict__ kc,
              const float* __restrict__ vc, const int* __restrict__ lengths,
              float* __restrict__ out, int hkv, int S, float scale) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr bool kRound = !std::is_same<KT, float>::value;  // bf16 products
  constexpr int VPL = D / 32;                               // columns per lane
  __shared__ __align__(16) float qs[G][D];
  __shared__ float pbuf[kWarps][G][kTile];
  __shared__ float wm[kWarps][G], wl[kWarps][G];
  __shared__ float wacc[kWarps][G][D];

  const int bh = blockIdx.x;  // slot * hkv + kv head
  const int b = bh / hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < G * D; i += kWarps * 32) {
    const float v = q[static_cast<size_t>(bh) * G * D + i];
    qs[i / D][i % D] = kRound ? qg::bf16_round(v) : v;
  }
  __syncthreads();

  const int len = min(lengths[b], S);
  const KT* kbase = kcache + static_cast<size_t>(bh) * S * D;
  const KT* vbase = vcache + static_cast<size_t>(bh) * S * D;
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
      const KT* kr = kbase + static_cast<size_t>(j) * D;
#pragma unroll 4
      for (int d0 = 0; d0 < D; d0 += 8) {
        float kv[8];
        if constexpr (kQuant) {
          const uint2 u = *reinterpret_cast<const uint2*>(kr + d0);
          const uint32_t w[2] = {u.x, u.y};
#pragma unroll
          for (int e = 0; e < 8; ++e)
            kv[e] = static_cast<float>(static_cast<int8_t>((w[e / 4] >> (8 * (e % 4))) & 0xffu));
        } else {
          qg::load8(kr + d0, kv);
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e) s[g] = fmaf(qs[g][d0 + e], kv[e], s[g]);
      }
    }
    float kscale = 1.f, vscale = 1.f;
    if constexpr (kQuant) {
      if (valid) {
        kscale = kc[static_cast<size_t>(bh) * S + j] * (1.f / 127.f);
        vscale = vc[static_cast<size_t>(bh) * S + j] * (1.f / 127.f);
      }
    }
    float alpha[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float sg = s[g] * scale;
      if constexpr (kQuant) sg = sg * kscale;
      sg = valid ? sg : kNegInf;
      const float m_new = fmaxf(m_run[g], qg::warp_max(sg));
      float p = valid ? expf(sg - m_new) : 0.f;
      alpha[g] = expf(m_run[g] - m_new);
      l_run[g] = l_run[g] * alpha[g] + qg::warp_sum(p);
      m_run[g] = m_new;
      if constexpr (kQuant) p = p * vscale;
      pbuf[warp][g][lane] = kRound ? qg::bf16_round(p) : p;
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < VPL; ++i) acc[g][i] *= alpha[g];
    const int nrow = min(kTile, len - t0);
    for (int jj = 0; jj < nrow; ++jj) {
      const KT* vr = vbase + static_cast<size_t>(t0 + jj) * D + lane * VPL;
      float vv[VPL];
#pragma unroll
      for (int i = 0; i < VPL; ++i) vv[i] = qg::to_f32(vr[i]);
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
    const int g = i / D, d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w][g]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(wm[w][g] - mx);
      l += wl[w][g] * f;
      o += wacc[w][g][d] * f;
    }
    out[static_cast<size_t>(bh) * G * D + i] = o / fmaxf(l, 1e-30f);
  }
}

template <typename KT, int D>
cudaError_t launch_d(const float* q, const void* k, const void* v, const float* kc,
                     const float* vc, const int* len, float* out, int B, int hkv, int G,
                     int S, float scale, cudaStream_t s) {
  const KT* kk = static_cast<const KT*>(k);
  const KT* vv = static_cast<const KT*>(v);
  const dim3 grid(B * hkv), block(kWarps * 32);
  switch (G) {
    case 1: decode_kernel<KT, D, 1><<<grid, block, 0, s>>>(q, kk, vv, kc, vc, len, out, hkv, S, scale); break;
    case 2: decode_kernel<KT, D, 2><<<grid, block, 0, s>>>(q, kk, vv, kc, vc, len, out, hkv, S, scale); break;
    case 4: decode_kernel<KT, D, 4><<<grid, block, 0, s>>>(q, kk, vv, kc, vc, len, out, hkv, S, scale); break;
    case 8: decode_kernel<KT, D, 8><<<grid, block, 0, s>>>(q, kk, vv, kc, vc, len, out, hkv, S, scale); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename KT>
cudaError_t launch_t(const float* q, const void* k, const void* v, const float* kc,
                     const float* vc, const int* len, float* out, int B, int hkv, int G,
                     int S, int D, float scale, cudaStream_t s) {
  if (D == 64) return launch_d<KT, 64>(q, k, v, kc, vc, len, out, B, hkv, G, S, scale, s);
  if (D == 128) return launch_d<KT, 128>(q, k, v, kc, vc, len, out, B, hkv, G, S, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q f32 [B, Hkv*G, D]; k/v [B, Hkv, S, D] (kv_dtype 0 = int8 with kc/vc f32
// [B, Hkv, S], 1 = bf16, 2 = f32, kc/vc unused); lengths int32 [B];
// out f32 [B, Hkv*G, D]. Returns cudaGetLastError().
extern "C" int qgemm_decode_attention(const void* q, const void* k, const void* v,
                                      const void* kc, const void* vc, const void* lengths,
                                      void* out, int kv_dtype, int B, int hkv, int G,
                                      int S, int D, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || hkv <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* kcf = static_cast<const float*>(kc);
  const float* vcf = static_cast<const float*>(vc);
  const int* len = static_cast<const int*>(lengths);
  float* o = static_cast<float*>(out);
  cudaError_t e;
  if (kv_dtype == 0)
    e = launch_t<int8_t>(qf, k, v, kcf, vcf, len, o, B, hkv, G, S, D, scale, s);
  else if (kv_dtype == 1)
    e = launch_t<__nv_bfloat16>(qf, k, v, kcf, vcf, len, o, B, hkv, G, S, D, scale, s);
  else if (kv_dtype == 2)
    e = launch_t<float>(qf, k, v, kcf, vcf, len, o, B, hkv, G, S, D, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
