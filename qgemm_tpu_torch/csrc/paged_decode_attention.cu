// Kernel K5: one decode step (Sq = 1) of attention over the PAGED KV cache,
// int8 or int4 pools with per-position scales, for Hopper (sm_90a).
//
// Replaces _paged_kernel / paged_decode_attention and _ragged_kernel /
// paged_decode_attention_ragged of qgemm_tpu/ops/pallas/paged_attention.py.
// Same math: for query head h of slot b (pool head h / G),
//   s_j = (bf16(q) . K_j) * (1/sqrt(D)) * (kc_j / 127),   j < len_b,
// with position j in physical page page_table[b][j / page], row j % page;
// online softmax in f32; p_j * (vc_j / 127) rounded to bf16 before the V
// product; out = acc / max(l, 1e-30). int8 (and int4) codes are exact in
// bf16, so the products are exact and only their f32 sums round.
// int4 pools pair page positions r and r + page/2 in one byte (low and high
// nibble); a lane unpacks its nibble in registers with sign-extending
// integer ops. A slot of length 0 writes zeros.
//
// What bounds it on the H100: the pool read. Each step streams K and V of
// every resident position of every slot once (2 * D bytes per position and
// KV head for int8, D for int4) against ~4 * D flops per position and query
// head: far under the card's flop:byte balance.
//
// Design (a simple first kernel): K2's, with the page indirection added.
// One block per (slot, KV head); its G = Hq / Hkv query rows (GQA) share
// every K/V row the block reads. The block's 4 warps take 32-position tiles
// in turn; in a tile each lane owns one position, resolves its page through
// the slot's page table, and reads its whole K row (the q.k dot needs no
// shuffles); the warp runs the online-softmax update for the tile; then
// lanes switch to owning D/32 head-dim columns for the p.V product over the
// tile's rows, each row's address broadcast from its owning lane. The loop
// over the slot's resident positions takes the place of the TPU kernels'
// sequential page grid, so the step tables of the ragged entry (the TPU
// grid's schedule) are not read. The four warps' partial (max, sum, acc)
// states merge in a fixed order at the end. With an int8 pool this is K2's
// arithmetic in K2's order, so K5 equals K2 bit for bit on the same rows.
// Later performance work: split long slots across blocks by the step
// tables (flash-decoding), and read each int4 byte once for both of its
// positions.
//
// Head widths: compiled for D in {32, 64, 128}; the pools' rows hold the
// true width d <= D (vector loads at d == D, element loads below it, the
// columns past d read as zeros). The wrapper pads the per-call q to D and
// slices the output; the pools are never copied.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kTile = 32;
constexpr float kNegInf = -1e30f;

template <int BITS, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const float* __restrict__ q, const int8_t* __restrict__ kq,
                    const float* __restrict__ kc, const int8_t* __restrict__ vq,
                    const float* __restrict__ vc, const int* __restrict__ page_table,
                    const int* __restrict__ lengths, float* __restrict__ out, int hkv,
                    int page, int pps, int d, float scale) {
  constexpr int VPL = D / 32;                               // columns per lane
  __shared__ __align__(16) float qs[G][D];
  __shared__ float pbuf[kWarps][G][kTile];
  __shared__ float wm[kWarps][G], wl[kWarps][G];
  __shared__ float wacc[kWarps][G][D];

  const int bh = blockIdx.x;  // slot * hkv + kv head
  const int b = bh / hkv, h = bh % hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < G * D; i += kWarps * 32)
    qs[i / D][i % D] = qg::bf16_round(q[static_cast<size_t>(bh) * G * D + i]);
  __syncthreads();

  const int rows = BITS == 8 ? page : page / 2;             // byte rows per page
  const int* pt = page_table + static_cast<size_t>(b) * pps;
  const int len = min(lengths[b], pps * page);              // never past the table
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
    // this lane's position: its page, its byte row, its nibble
    size_t row_off = 0, scale_off = 0;
    bool hi = false;
    if (valid) {
      const int logical = j / page, r = j - logical * page;
      const size_t ph = static_cast<size_t>(pt[logical]) * hkv + h;
      hi = BITS == 4 && r >= rows;
      row_off = (ph * rows + (hi ? r - rows : r)) * d;
      scale_off = ph * page + r;
    }
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (valid) {
      const int8_t* kr = kq + row_off;
#pragma unroll 4
      for (int d0 = 0; d0 < D; d0 += 8) {
        float kv[8];
        if (d == D) {
          const uint2 u = *reinterpret_cast<const uint2*>(kr + d0);
          const uint32_t w[2] = {u.x, u.y};
#pragma unroll
          for (int e = 0; e < 8; ++e) kv[e] = qg::kv_code<BITS>(w[e / 4] >> (8 * (e % 4)), hi);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            kv[e] = d0 + e < d ? qg::kv_code<BITS>(static_cast<uint8_t>(kr[d0 + e]), hi) : 0.f;
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e) s[g] = fmaf(qs[g][d0 + e], kv[e], s[g]);
      }
    }
    float kscale = 1.f, vscale = 1.f;
    if (valid) {
      kscale = kc[scale_off] * (1.f / 127.f);
      vscale = vc[scale_off] * (1.f / 127.f);
    }
    float alpha[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float sg = s[g] * scale;
      sg = sg * kscale;
      sg = valid ? sg : kNegInf;
      const float m_new = fmaxf(m_run[g], qg::warp_max(sg));
      float p = valid ? expf(sg - m_new) : 0.f;
      alpha[g] = expf(m_run[g] - m_new);
      l_run[g] = l_run[g] * alpha[g] + qg::warp_sum(p);
      m_run[g] = m_new;
      p = p * vscale;
      pbuf[warp][g][lane] = qg::bf16_round(p);
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < VPL; ++i) acc[g][i] *= alpha[g];
    const int nrow = min(kTile, len - t0);
    for (int jj = 0; jj < nrow; ++jj) {
      const unsigned long long off = __shfl_sync(0xffffffffu,
                                                 static_cast<unsigned long long>(row_off), jj);
      const bool rhi = __shfl_sync(0xffffffffu, static_cast<int>(hi), jj) != 0;
      const int8_t* vr = vq + off + lane * VPL;
      float vv[VPL];
#pragma unroll
      for (int i = 0; i < VPL; ++i)
        vv[i] = lane * VPL + i < d ? qg::kv_code<BITS>(static_cast<uint8_t>(vr[i]), rhi) : 0.f;
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
    out[static_cast<size_t>(bh) * G * D + i] = o / fmaxf(l, 1e-30f);
  }
}

template <int BITS, int D>
cudaError_t launch_d(const float* q, const int8_t* kq, const float* kc, const int8_t* vq,
                     const float* vc, const int* pt, const int* len, float* out, int B,
                     int hkv, int G, int page, int pps, int d, float scale, cudaStream_t s) {
  const dim3 grid(B * hkv), block(kWarps * 32);
  switch (G) {
    case 1: paged_decode_kernel<BITS, D, 1><<<grid, block, 0, s>>>(q, kq, kc, vq, vc, pt, len, out, hkv, page, pps, d, scale); break;
    case 2: paged_decode_kernel<BITS, D, 2><<<grid, block, 0, s>>>(q, kq, kc, vq, vc, pt, len, out, hkv, page, pps, d, scale); break;
    case 4: paged_decode_kernel<BITS, D, 4><<<grid, block, 0, s>>>(q, kq, kc, vq, vc, pt, len, out, hkv, page, pps, d, scale); break;
    case 8: paged_decode_kernel<BITS, D, 8><<<grid, block, 0, s>>>(q, kq, kc, vq, vc, pt, len, out, hkv, page, pps, d, scale); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_bits(const float* q, const int8_t* kq, const float* kc, const int8_t* vq,
                        const float* vc, const int* pt, const int* len, float* out, int B,
                        int hkv, int G, int D, int page, int pps, int d, float scale,
                        cudaStream_t s) {
  if (d < 1 || d > D) return cudaErrorInvalidValue;
  if (D == 32) return launch_d<BITS, 32>(q, kq, kc, vq, vc, pt, len, out, B, hkv, G, page, pps, d, scale, s);
  if (D == 64) return launch_d<BITS, 64>(q, kq, kc, vq, vc, pt, len, out, B, hkv, G, page, pps, d, scale, s);
  if (D == 128) return launch_d<BITS, 128>(q, kq, kc, vq, vc, pt, len, out, B, hkv, G, page, pps, d, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q f32 [B, Hkv*G, D] (D in {32, 64, 128}, zero past d); kq/vq int8
// [P, Hkv, rows, d], d <= D (rows = page for bits 8, page/2 for bits 4); kc/vc f32 [P, Hkv, 1, page]; page_table int32
// [B, pps]; lengths int32 [B]; out f32 [B, Hkv*G, D]. page a multiple of 16.
// Returns cudaGetLastError().
extern "C" int qgemm_paged_decode_attention(const void* q, const void* kq, const void* kc,
                                            const void* vq, const void* vc,
                                            const void* page_table, const void* lengths,
                                            void* out, int bits, int B, int hkv, int G, int D,
                                            int d, int page, int pps, float scale,
                                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || hkv <= 0 || pps <= 0 || page < 16 || page % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const int8_t* k8 = static_cast<const int8_t*>(kq);
  const int8_t* v8 = static_cast<const int8_t*>(vq);
  const float* kcf = static_cast<const float*>(kc);
  const float* vcf = static_cast<const float*>(vc);
  const int* pt = static_cast<const int*>(page_table);
  const int* len = static_cast<const int*>(lengths);
  float* o = static_cast<float*>(out);
  cudaError_t e;
  if (bits == 8)
    e = launch_bits<8>(qf, k8, kcf, v8, vcf, pt, len, o, B, hkv, G, D, page, pps, d, scale, s);
  else if (bits == 4)
    e = launch_bits<4>(qf, k8, kcf, v8, vcf, pt, len, o, B, hkv, G, D, page, pps, d, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
