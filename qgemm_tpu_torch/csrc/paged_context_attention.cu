// Kernel K6: chunk (multi-row) attention over the PAGED KV cache, causal at
// a per-slot offset, int8 or int4 pools, for Hopper (sm_90a).
//
// Replaces _context_kernel / paged_context_attention of
// qgemm_tpu/ops/pallas/paged_attention.py, the blocked form of
// paged_context_attention_reference. The query heads of a KV head fold into
// the row axis: q [B, Hq, C, D] is read as [B, Hkv, R = G*C, D], row r being
// query head-group r / C at chunk position r % C. Row r attends position k
// iff k <= offset[b] + r % C and k < lengths[b]. Same math as K5:
//   s = (bf16(q) . K_k) * (1/sqrt(D)) * (kc_k / 127); online softmax in f32;
//   p * (vc_k / 127) rounded to bf16 before the V product;
//   out = acc / max(l, 1e-30).
// The TPU kernel asserts int8 pools (the JAX model sends int4 chunks through
// its gather oracle); this kernel unpacks int4 pools as K5 does, so both
// pool types run it.
//
// What bounds it on the H100: at the engine's chunks (C = 256 rows after
// ~1024 resident positions, D = 128) the operations, ~4 * D per (row,
// attended position), against one read of the attended K/V pages. This
// first kernel runs its products on the f32 SIMT units, not the tensor
// cores, so it is far from that bound; mma/wgmma is later work.
//
// Design: K3's, with the page indirection and the scales added. One block
// per (64 folded rows, slot * KV head). The rows are staged once in shared
// memory (bf16-rounded, as f32); K and V stream through shared memory in
// 32-position tiles, each position's page resolved through the slot's page
// table and its int8 (or int4 nibble) codes widened to f32; each thread
// owns a 4 x 2 patch of the score tile and a 4 x (D/16) patch of the
// output. One warp per 8 rows runs the online-softmax update. The block's
// page walk stops at its rows' last causal position (the TPU kernel's
// "tight" bound) and at the slot's length, so later pages are never read.
//
// Head widths: compiled for D in {32, 64, 128}; the pools' rows hold the
// true width d <= D (vector loads at d == D, element loads below it, the
// columns past d staged as zeros). The wrapper pads the per-call q to D
// and slices the output; the pools are never copied.
#include "common.cuh"

namespace {

constexpr int kBQ = 64, kBK = 32, kThreads = 256;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

template <int D> __host__ __device__ constexpr int ld() { return D + 4; }  // f32 row stride, 16 B aligned
template <int D> constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ) * ld<D>() + 2 * kBK * ld<D>() +
                          kBQ * (kBK + 1) + 3 * kBQ + 2 * kBK);
}

template <int BITS, int D>
__global__ void __launch_bounds__(kThreads)
paged_context_kernel(const float* __restrict__ q, const int8_t* __restrict__ kq,
                     const float* __restrict__ kc, const int8_t* __restrict__ vq,
                     const float* __restrict__ vc, const int* __restrict__ page_table,
                     const int* __restrict__ lengths, const int* __restrict__ offsets,
                     float* __restrict__ out, int hkv, int C, int R, int page, int pps,
                     int dt, float scale) {
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
  float* ksc = row_a + kBQ;
  float* vsc = ksc + kBK;

  const int bh = blockIdx.y, b = bh / hkv, h = bh % hkv;
  const int r0 = blockIdx.x * kBQ, tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int rows = BITS == 8 ? page : page / 2;             // byte rows per page
  const int* pt = page_table + static_cast<size_t>(b) * pps;
  const int len = min(lengths[b], pps * page);              // never past the table
  const int off = offsets[b];
  const float* qb = q + static_cast<size_t>(bh) * R * D;

  for (int i = tid; i < kBQ * (D / 8); i += kThreads) {
    const int r = i / (D / 8), d = (i % (D / 8)) * 8;
    float vals[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r0 + r < R) qg::load8(qb + static_cast<size_t>(r0 + r) * D + d, vals);
#pragma unroll
    for (int e = 0; e < 8; ++e) Qs[r * LD + d + e] = qg::bf16_round(vals[e]);
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

  // the block's rows attend positions up to their last causal one: within
  // one head-group, off + (last row) % C; across a group boundary, off + C - 1
  const int r_last = min(r0 + kBQ, R) - 1;
  const int bound = (r0 / C == r_last / C) ? off + r_last % C : off + C - 1;
  const int kv_end = min(bound + 1, len);
  const int nk = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    for (int i = tid; i < kBK * (D / 8); i += kThreads) {
      const int r = i / (D / 8), d = (i % (D / 8)) * 8;
      const int pos = k0 + r;
      float kv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float vv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (pos < kv_end) {
        const int logical = pos / page, w = pos - logical * page;
        const size_t ph = static_cast<size_t>(pt[logical]) * hkv + h;
        const bool hi = BITS == 4 && w >= rows;
        const size_t o = (ph * rows + (hi ? w - rows : w)) * dt + d;
        if (dt == D) {
          const uint2 uk = *reinterpret_cast<const uint2*>(kq + o);
          const uint2 uv = *reinterpret_cast<const uint2*>(vq + o);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int sh = 8 * (e % 4);
            kv[e] = qg::kv_code<BITS>((e < 4 ? uk.x : uk.y) >> sh, hi);
            vv[e] = qg::kv_code<BITS>((e < 4 ? uv.x : uv.y) >> sh, hi);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (d + e < dt) {
              kv[e] = qg::kv_code<BITS>(static_cast<uint8_t>(kq[o + e]), hi);
              vv[e] = qg::kv_code<BITS>(static_cast<uint8_t>(vq[o + e]), hi);
            }
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        Ks[r * LD + d + e] = kv[e];
        Vs[r * LD + d + e] = vv[e];
      }
    }
    if (tid < kBK) {
      const int pos = k0 + tid;
      float ks = 0.f, vs = 0.f;
      if (pos < kv_end) {
        const int logical = pos / page, w = pos - logical * page;
        const size_t so = (static_cast<size_t>(pt[logical]) * hkv + h) * page + w;
        ks = kc[so] * (1.f / 127.f);
        vs = vc[so] * (1.f / 127.f);
      }
      ksc[tid] = ks;
      vsc[tid] = vs;
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
        const int gq = r0 + r, gk = k0 + c;
        const bool ok = gq < R && gk < kv_end && gk <= off + gq % C;
        Ps[r * (kBK + 1) + c] = ok ? (s[i][j] * scale) * ksc[c] : neg_inf();
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
      Ps[r * (kBK + 1) + lane] = qg::bf16_round(p * vsc[lane]);
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
    const int r = ty * 4 + i, gq = r0 + r;
    if (gq < R) {
      const float l = fmaxf(row_l[r], 1e-30f);
      float* orow = out + (static_cast<size_t>(bh) * R + gq) * D;
#pragma unroll
      for (int j = 0; j < CPT; ++j) orow[tx + 16 * j] = acc[i][j] / l;
    }
  }
}

template <int BITS, int D>
cudaError_t launch(const void* q, const void* kq, const void* kc, const void* vq,
                   const void* vc, const void* pt, const void* len, const void* off,
                   void* out, int B, int hkv, int C, int R, int page, int pps, int dt,
                   float scale, cudaStream_t s) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(paged_context_kernel<BITS, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((R + kBQ - 1) / kBQ, B * hkv);
  paged_context_kernel<BITS, D><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(kc), static_cast<const int8_t*>(vq),
      static_cast<const float*>(vc), static_cast<const int*>(pt),
      static_cast<const int*>(len), static_cast<const int*>(off), static_cast<float*>(out),
      hkv, C, R, page, pps, dt, scale);
  return cudaGetLastError();
}

}  // namespace

// q f32 [B, Hkv, R = G*C, D] (query heads folded into rows; D in {32, 64,
// 128}, zero past d); kq/vq int8 [P, Hkv, rows, d], d <= D (rows = page for bits 8, page/2 for bits 4); kc/vc f32
// [P, Hkv, 1, page]; page_table int32 [B, pps]; lengths, offsets int32 [B];
// out f32 [B, Hkv, R, D]. page a multiple of 16. Returns cudaGetLastError().
extern "C" int qgemm_paged_context_attention(const void* q, const void* kq, const void* kc,
                                             const void* vq, const void* vc,
                                             const void* page_table, const void* lengths,
                                             const void* offsets, void* out, int bits, int B,
                                             int hkv, int C, int R, int D, int d, int page,
                                             int pps, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || hkv <= 0 || C <= 0 || R <= 0 || R % C || pps <= 0 || page < 16 ||
      page % 16 || B * hkv > 65535 || d < 1 || d > D)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto go = [&](auto fn) {
    return static_cast<int>(fn(q, kq, kc, vq, vc, page_table, lengths, offsets, out, B, hkv,
                               C, R, page, pps, d, scale, s));
  };
  if (bits == 8 && D == 32) return go(launch<8, 32>);
  if (bits == 8 && D == 64) return go(launch<8, 64>);
  if (bits == 8 && D == 128) return go(launch<8, 128>);
  if (bits == 4 && D == 32) return go(launch<4, 32>);
  if (bits == 4 && D == 64) return go(launch<4, 64>);
  if (bits == 4 && D == 128) return go(launch<4, 128>);
  return static_cast<int>(cudaErrorInvalidValue);
}
