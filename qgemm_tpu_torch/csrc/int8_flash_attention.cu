// Int8 blockwise (flash) attention forward for Hopper (sm_90a): the kernel
// of row 12.
//
// Replaces _int8_flash_kernel of qgemm_tpu/ops/pallas/int8_flash_attention.py.
// Its inputs come from the wrapper's pre-pass, which is JAX's too (K less
// its per-channel mean; Q and K int8 per row, V int8 per channel, /127
// folded into the row scales). Same math per key tile, in f32:
//   s = (q8 . k8)_s32 * (sq * scale) * sk, with s = -1e30 where the key is
//       past Sk or, when causal, kj > qi (top-left aligned);
//   m_new = max(m, max_j s), p = exp(s - m_new) (0 where masked),
//   alpha = exp(m - m_new);
//   int8 P (the default): p8 = rint(p * 127) as int8, l = l * alpha + sum p8,
//       acc = acc * alpha + (p8 . v8)_s32;
//   qk_only: P rounded to bf16 times V in bf16 with f32 sums, l sums the f32 p;
// and at the end o = acc / max(l, 1e-6) (times 1/127 with int8 P), stored in
// the output dtype. Every multiply and add of that update is rounded on its
// own (no fused multiply-add), as the plain version's tensor ops are.
// P is quantized against the running max at the end of each KEY TILE, so
// its codes depend on the tile width: this kernel's tile is 64 keys, the
// TPU kernel's min(1024, Sk rounded up to 128). The plain version takes the
// tile width as an argument.
//
// What bounds it on the H100: at GPT_6_7B's prefill (H 32, S 2048, D 128,
// causal) the operations, 2 * 2 * D int8 ops per attended (query, key)
// pair on the tensor cores (1,979 TOP/s), against ~42 MB of int8 q/k/v and
// the output.
//
// Design: K3's tiling on the tensor cores. One block of 4 warps per (64
// query rows, batch*head); each warp owns 16 query rows and keeps its Q
// fragments in registers. K (and V, transposed so that keys run along a
// row) stream through shared memory in 64-key tiles; S = Q K^T is
// mma.sync m16n8k32 s8 -> s32 into registers, the online-softmax update
// runs on the accumulator fragments (a row's max and sum reduced across its
// 4 lanes with shuffles), P goes through shared memory as the A operand of
// the second product: mma.sync m16n8k32 s8 for int8 P, m16n8k16 bf16 for
// qk_only. The causal walk stops at the tile holding the block's last row.
// Head widths are compiled for D, Dv in {32, 64, 128}; the pre-pass pads
// the codes with zeros, and the output is stored at its true width dv.
#include <cstring>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kBQ = 64, kBK = 64, kThreads = 128;
constexpr int kPad8 = 16;   // bytes of padding per int8 smem row
constexpr int kPadB = 8;    // bf16 elements of padding per bf16 smem row
constexpr float kNegBig = -1e30f;

template <int D, int DV, bool P8> struct Smem {
  static constexpr int LQ = D + kPad8;                   // Q and K rows, bytes
  static constexpr int LV = P8 ? kBK + kPad8 : kBK + kPadB;  // V^T rows, elements
  static constexpr int LP = LV;                          // P rows, elements
  static constexpr size_t q = static_cast<size_t>(kBQ) * LQ;
  static constexpr size_t k = static_cast<size_t>(kBK) * LQ;
  static constexpr size_t v = static_cast<size_t>(DV) * LV * (P8 ? 1 : 2);
  static constexpr size_t p = static_cast<size_t>(kBQ) * LP * (P8 ? 1 : 2);
  static constexpr size_t bytes = q + k + v + p + kBK * sizeof(float);
};

// grid (ceil(Sq / 64), BH). q8 [BH, Sq, D], k8 [BH, Sk, D] int8; v [BH, Sk,
// DV] int8 (P8) or bf16 (qk_only); sq [BH, Sq], sk [BH, Sk] f32 (the /127
// already folded in); out [BH, Sq, dv] in T.
template <typename T, int D, int DV, bool P8>
__global__ void __launch_bounds__(kThreads)
int8_flash_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
                  const void* __restrict__ vin, const float* __restrict__ sqs,
                  const float* __restrict__ sks, T* __restrict__ out, int sq, int sk, int dv,
                  int causal, float scale) {
  using S = Smem<D, DV, P8>;
  using VT = typename std::conditional<P8, int8_t, __nv_bfloat16>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* Qs = reinterpret_cast<int8_t*>(smem);
  int8_t* Ks = Qs + S::q;
  VT* Vt = reinterpret_cast<VT*>(smem + S::q + S::k);           // [DV][LV]
  VT* Ps = reinterpret_cast<VT*>(smem + S::q + S::k + S::v);    // [kBQ][LP]
  float* sks_t = reinterpret_cast<float*>(smem + S::q + S::k + S::v + S::p);

  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int8_t* qb = q8 + static_cast<size_t>(bh) * sq * D;
  const int8_t* kb = k8 + static_cast<size_t>(bh) * sk * D;
  const VT* vb = static_cast<const VT*>(vin) + static_cast<size_t>(bh) * sk * DV;

  for (int i = tid; i < kBQ * (D / 16); i += kThreads) {
    const int r = i / (D / 16), c = (i % (D / 16)) * 16;
    int4 val = make_int4(0, 0, 0, 0);
    if (q0 + r < sq) val = *reinterpret_cast<const int4*>(qb + static_cast<size_t>(q0 + r) * D + c);
    *reinterpret_cast<int4*>(&Qs[r * S::LQ + c]) = val;
  }
  __syncthreads();

  // this warp's rows r0 = 16 * warp + g and r1 = r0 + 8; Q fragments in registers
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const int qi0 = q0 + r0, qi1 = q0 + r1;
  uint32_t qa[D / 32][4];
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) {
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(&Qs[r0 * S::LQ + kk * 32 + t * 4]);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(&Qs[r1 * S::LQ + kk * 32 + t * 4]);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(&Qs[r0 * S::LQ + kk * 32 + 16 + t * 4]);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(&Qs[r1 * S::LQ + kk * 32 + 16 + t * 4]);
  }
  const float qs0 = qi0 < sq ? __fmul_rn(sqs[static_cast<size_t>(bh) * sq + qi0], scale) : 0.f;
  const float qs1 = qi1 < sq ? __fmul_rn(sqs[static_cast<size_t>(bh) * sq + qi1], scale) : 0.f;
  float m0 = kNegBig, m1 = kNegBig, l0 = 0.f, l1 = 0.f;
  float acc[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int nk = (sk + kBK - 1) / kBK;
  if (causal) nk = min(nk, (min(q0 + kBQ, sq) - 1) / kBK + 1);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's K, V and P are no longer read
    for (int i = tid; i < kBK * (D / 16); i += kThreads) {
      const int r = i / (D / 16), c = (i % (D / 16)) * 16;
      int4 val = make_int4(0, 0, 0, 0);
      if (k0 + r < sk) val = *reinterpret_cast<const int4*>(kb + static_cast<size_t>(k0 + r) * D + c);
      *reinterpret_cast<int4*>(&Ks[r * S::LQ + c]) = val;
    }
    // V transposed: Vt[c][key]; 4-byte words of a V row (4 int8 or 2 bf16)
    constexpr int PER = 4 / sizeof(VT);
    for (int i = tid; i < kBK * (DV / PER); i += kThreads) {
      const int r = i / (DV / PER), c = (i % (DV / PER)) * PER;
      VT vals[PER];
      if (k0 + r < sk) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(vb + static_cast<size_t>(k0 + r) * DV + c);
        memcpy(vals, &w, 4);
      } else {
        memset(vals, 0, 4);
      }
#pragma unroll
      for (int e = 0; e < PER; ++e) Vt[(c + e) * S::LV + r] = vals[e];
    }
    if (tid < kBK) sks_t[tid] = k0 + tid < sk ? sks[static_cast<size_t>(bh) * sk + k0 + tid] : 0.f;
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    int s32[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s32[j][0] = s32[j][1] = s32[j][2] = s32[j][3] = 0;
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
        const int8_t* kr = &Ks[(j * 8 + g) * S::LQ + kk * 32];
        const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(kr + t * 4),
                               *reinterpret_cast<const uint32_t*>(kr + 16 + t * 4)};
        qg::mma_s8(s32[j], qa[kk], b);
      }
    }
    // scores, masks and the two rows' maxima
    float sc[kBK / 8][4];
    float mx0 = kNegBig, mx1 = kNegBig;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + t * 2 + (e & 1), kj = k0 + c;
        const int qi = e < 2 ? qi0 : qi1;
        const bool ok = kj < sk && (!causal || kj <= qi);
        const float v = __fmul_rn(__fmul_rn(static_cast<float>(s32[j][e]), e < 2 ? qs0 : qs1),
                                  sks_t[c]);
        sc[j][e] = ok ? v : kNegBig;
        if (e < 2) mx0 = fmaxf(mx0, sc[j][e]); else mx1 = fmaxf(mx1, sc[j][e]);
      }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + t * 2 + (e & 1), kj = k0 + c;
        const int qi = e < 2 ? qi0 : qi1;
        const bool ok = kj < sk && (!causal || kj <= qi);
        const float p = ok ? expf(sc[j][e] - (e < 2 ? mn0 : mn1)) : 0.f;
        const int r = e < 2 ? r0 : r1;
        if constexpr (P8) {
          const int p8 = __float2int_rn(__fmul_rn(p, 127.f));
          Ps[r * S::LP + c] = static_cast<int8_t>(p8);
          if (e < 2) ls0 += static_cast<float>(p8); else ls1 += static_cast<float>(p8);
        } else {
          Ps[r * S::LP + c] = __float2bfloat16_rn(p);
          if (e < 2) ls0 += p; else ls1 += p;
        }
      }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      ls0 += __shfl_xor_sync(0xffffffffu, ls0, o);
      ls1 += __shfl_xor_sync(0xffffffffu, ls1, o);
    }
    l0 = __fadd_rn(__fmul_rn(l0, al0), ls0);
    l1 = __fadd_rn(__fmul_rn(l1, al1), ls1);
    __syncwarp();

    // acc = acc * alpha + P V, one 8-column n-tile at a time
    if constexpr (P8) {
      uint32_t pa[kBK / 32][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) {
        pa[kk][0] = *reinterpret_cast<const uint32_t*>(&Ps[r0 * S::LP + kk * 32 + t * 4]);
        pa[kk][1] = *reinterpret_cast<const uint32_t*>(&Ps[r1 * S::LP + kk * 32 + t * 4]);
        pa[kk][2] = *reinterpret_cast<const uint32_t*>(&Ps[r0 * S::LP + kk * 32 + 16 + t * 4]);
        pa[kk][3] = *reinterpret_cast<const uint32_t*>(&Ps[r1 * S::LP + kk * 32 + 16 + t * 4]);
      }
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        int pv[4] = {0, 0, 0, 0};
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk) {
          const VT* vr = &Vt[(j * 8 + g) * S::LV + kk * 32];
          const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(vr + t * 4),
                                 *reinterpret_cast<const uint32_t*>(vr + 16 + t * 4)};
          qg::mma_s8(pv, pa[kk], b);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] = __fadd_rn(__fmul_rn(acc[j][e], e < 2 ? al0 : al1), static_cast<float>(pv[e]));
      }
    } else {
      uint32_t pa[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        pa[kk][0] = *reinterpret_cast<const uint32_t*>(&Ps[r0 * S::LP + kk * 16 + t * 2]);
        pa[kk][1] = *reinterpret_cast<const uint32_t*>(&Ps[r1 * S::LP + kk * 16 + t * 2]);
        pa[kk][2] = *reinterpret_cast<const uint32_t*>(&Ps[r0 * S::LP + kk * 16 + 8 + t * 2]);
        pa[kk][3] = *reinterpret_cast<const uint32_t*>(&Ps[r1 * S::LP + kk * 16 + 8 + t * 2]);
      }
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const VT* vr = &Vt[(j * 8 + g) * S::LV + kk * 16];
          const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(vr + t * 2),
                                 *reinterpret_cast<const uint32_t*>(vr + 8 + t * 2)};
          qg::mma_bf16(pv, pa[kk], b);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] = __fadd_rn(__fmul_rn(acc[j][e], e < 2 ? al0 : al1), pv[e]);
      }
    }
  }

  const float lm0 = fmaxf(l0, 1e-6f), lm1 = fmaxf(l1, 1e-6f);
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = e < 2 ? qi0 : qi1, c = j * 8 + t * 2 + (e & 1);
      if (qi < sq && c < dv) {
        float o = acc[j][e] / (e < 2 ? lm0 : lm1);
        if constexpr (P8) o = __fmul_rn(o, 1.f / 127.f);
        out[(static_cast<size_t>(bh) * sq + qi) * dv + c] = qg::from_f32<T>(o);
      }
    }
}

template <typename T, int D, int DV, bool P8>
cudaError_t launch(const void* q8, const void* k8, const void* v, const float* sqs,
                   const float* sks, void* out, int bh, int sq, int sk, int dv, int causal,
                   float scale, cudaStream_t s) {
  const size_t smem = Smem<D, DV, P8>::bytes;
  cudaError_t e = cudaFuncSetAttribute(int8_flash_kernel<T, D, DV, P8>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  int8_flash_kernel<T, D, DV, P8><<<grid, kThreads, smem, s>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8), v, sqs, sks,
      static_cast<T*>(out), sq, sk, dv, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D, bool P8>
cudaError_t launch_dv(int DV, const void* q8, const void* k8, const void* v, const float* sqs,
                      const float* sks, void* out, int bh, int sq, int sk, int dv, int causal,
                      float scale, cudaStream_t s) {
  if (DV == 32) return launch<T, D, 32, P8>(q8, k8, v, sqs, sks, out, bh, sq, sk, dv, causal, scale, s);
  if (DV == 64) return launch<T, D, 64, P8>(q8, k8, v, sqs, sks, out, bh, sq, sk, dv, causal, scale, s);
  if (DV == 128) return launch<T, D, 128, P8>(q8, k8, v, sqs, sks, out, bh, sq, sk, dv, causal, scale, s);
  return cudaErrorInvalidValue;
}

template <typename T, bool P8>
cudaError_t launch_d(int D, int DV, const void* q8, const void* k8, const void* v,
                     const float* sqs, const float* sks, void* out, int bh, int sq, int sk,
                     int dv, int causal, float scale, cudaStream_t s) {
  if (D == 32) return launch_dv<T, 32, P8>(DV, q8, k8, v, sqs, sks, out, bh, sq, sk, dv, causal, scale, s);
  if (D == 64) return launch_dv<T, 64, P8>(DV, q8, k8, v, sqs, sks, out, bh, sq, sk, dv, causal, scale, s);
  if (D == 128) return launch_dv<T, 128, P8>(DV, q8, k8, v, sqs, sks, out, bh, sq, sk, dv, causal, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q8 [BH, Sq, D], k8 [BH, Sk, D] int8 codes with D in {32, 64, 128} (zero
// past the true width); v [BH, Sk, DV], DV in {32, 64, 128}: int8 codes
// (p_int8 = 1) or bf16 values (p_int8 = 0, qk_only); sq f32 [BH, Sq], sk
// f32 [BH, Sk] row scales with the 1/127 folded in; out [BH, Sq, dv],
// dv <= DV, out_dtype 0 = f32, 1 = bf16. Returns cudaGetLastError().
extern "C" int qgemm_int8_flash_attention(const void* q8, const void* k8, const void* v,
                                          const void* sq_scale, const void* sk_scale,
                                          void* out, int out_dtype, int p_int8, int bh,
                                          int sq, int sk, int D, int DV, int dv, int causal,
                                          float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || sq <= 0 || sk <= 0 || bh > 65535 || dv < 1 || dv > DV)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sqs = static_cast<const float*>(sq_scale);
  const float* sks = static_cast<const float*>(sk_scale);
  cudaError_t e = cudaErrorInvalidValue;
  if (out_dtype == 0 && p_int8)
    e = launch_d<float, true>(D, DV, q8, k8, v, sqs, sks, out, bh, sq, sk, dv, causal, scale, s);
  else if (out_dtype == 0)
    e = launch_d<float, false>(D, DV, q8, k8, v, sqs, sks, out, bh, sq, sk, dv, causal, scale, s);
  else if (out_dtype == 1 && p_int8)
    e = launch_d<__nv_bfloat16, true>(D, DV, q8, k8, v, sqs, sks, out, bh, sq, sk, dv, causal, scale, s);
  else if (out_dtype == 1)
    e = launch_d<__nv_bfloat16, false>(D, DV, q8, k8, v, sqs, sks, out, bh, sq, sk, dv, causal, scale, s);
  return static_cast<int>(e);
}
