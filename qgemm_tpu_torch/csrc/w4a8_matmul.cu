// Kernel K4: W4A8 GEMM — int4 group-quantized weights x int8 activations —
// for Hopper (sm_90a).
//
// Replaces the TPU kernel _w4a8_kernel of qgemm_tpu/ops/pallas/w4a8_matmul.py,
// behind w4a8_matmul_pallas.
//
//   out[m, n] = sum_s (sum_{g in s} float(isum_g[m, n]) * cw[g, n]) * (cx[m, s] / (127 * 7)),
//   isum_g = sum_{k in group g} q(x[m, k]) * w4[k, n]   (exact, int32),
//   q(x) = clip(rint(x * (127 / cx[m, s])), -127, 127),  cx[m, s] = max |x[m, slab s]|,
//
// with groups of 128 rows of K, slabs of bk = min(2048, kp) rows, and kp = k
// rounded up to 128 (the weights' pad rows are zeros).
//
// What bounds it on the H100: at decode (m <= 16 rows) the weight stream —
// k * n / 2 bytes of codes plus (k / 128) * n * 4 bytes of scales, half of
// K1's bytes — at about 4 int8 operations per weight byte, far under the
// card's 1979 TOP/s : 3.35 TB/s balance; at prefill the int8 tensor-core rate.
// Half the bytes make the latency of a decode call's two launches (pre-pass,
// GEMV) and of the GEMV's one ordered fold per block a larger share: measured
// on an H100 80GB HBM3 at 700 W at m 8 (PERF.md), ~0.2 of the byte bound at
// k = n = 4096, ~0.5 at the FFN shapes, ~0.6 at the lm_head, and faster than
// K1 at every decode shape.
//
// Design:
//   * a pre-pass (row_quantize.cuh), one block per (row, slab), takes the
//     slab's absmax and writes the int8 codes xq [m, kp] (zeros past k) and
//     ds = cx / 889, with the same f32 operations as the plain version
//     (scale 127 / cx, x * scale, round half to even), so the codes match it
//     bit for bit;
//   * weights are packed K-major ([n, kp / 2]): one column's group is 64
//     contiguous bytes, the low nibble of byte j holding row j of the group and
//     the high nibble row 64 + j. Nibbles are sign-extended in registers
//     (mask, then OR in 0xF0 where bit 3 is set: no carries between bytes);
//   * every f32 step is an explicit __fmul_rn / __fadd_rn in the plain
//     version's order — groups in order inside a slab, then the slab's sum
//     times ds, slabs in order — so both kernels below give the plain
//     version's bits, and a row's result does not depend on m;
//   * m <= 16, the decode GEMV (w4a8_gemv_kernel): per group, four mma.sync
//     m16n8k32 with W as the A operand (16 output columns) and X^T as B (8
//     rows; two n8 tiles for m 9-16). A lane loads 16 packed bytes of a
//     column's group straight from device memory; sign-extended, its low
//     nibbles are the group's rows 16t..16t+15 and its high nibbles rows
//     64+16t..79+16t, and the B fragments are the 16-byte loads of the same
//     codes of X (exact int32 sums do not depend on the order of K), so W
//     needs no shared-memory staging and no shuffles. Each warp owns whole
//     groups of K (a power of two up to one slab, so no slice crosses a
//     slab), keeps X's codes for 4 groups in registers and streams the
//     block's 1, 2 or 4 column tiles over them; each group's product
//     float(isum) * cw goes to shared memory, and after one barrier a thread
//     per (column, row) folds them in the plain order, slab by slab, each
//     slab's activation scale loaded before its adds (read inside the chain
//     it cost K4 12-14 % at the FFN shapes). A K longer than the products
//     that fit in shared memory is walked in rounds, the fold carried
//     between them. Launched with programmatic dependent launch, its first
//     weights and group scales prefetched into L2 while the pre-pass runs.
//     The plan comes from ops/cuda/gemv_plan.py;
//   * m > 16: 64 x 128 block tiles, one group (K = 128) per step unpacked into
//     shared memory, mma.sync m16n8k32 s8 -> s32 per group, folded into f32;
//   * ragged m, n and k are masked in the kernels; W is never padded per call.
#include "mma.cuh"
#include "row_quantize.cuh"

namespace {

constexpr float kW4Range = 7.f;
constexpr int kGroup = 128;

// sign-extend the four nibbles held in the low halves of a word's bytes
__device__ __forceinline__ int sext4(uint32_t nib) {
  return static_cast<int>(nib | ((nib & 0x08080808u) * 0x1Eu));
}

// 16 packed bytes -> the 16 low-nibble codes (lo) and the 16 high-nibble
// codes (hi), byte j of word i holding the code of packed byte 4i + j
__device__ __forceinline__ void unpack16(const int4 v, uint32_t lo[4], uint32_t hi[4]) {
  const uint32_t w[4] = {static_cast<uint32_t>(v.x), static_cast<uint32_t>(v.y),
                         static_cast<uint32_t>(v.z), static_cast<uint32_t>(v.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo[i] = static_cast<uint32_t>(sext4(w[i] & 0x0F0F0F0Fu));
    hi[i] = static_cast<uint32_t>(sext4((w[i] >> 4) & 0x0F0F0F0Fu));
  }
}

// ------------------------------------------------------- m <= 16 rows: GEMV
constexpr int kGvBatch = 4;        // groups whose X fragments a warp holds (512 codes)
constexpr int kGvMaxWarps = 8;
constexpr int kSmemLimit = 232448;

// grid (ceil(n / (16 * CT))), 32 * warps threads. The block walks K in
// rounds of warps * gs groups, warp w taking groups [w * gs, (w + 1) * gs)
// of each round. Dynamic shared memory: the round's f32 group products
// [warps * gs][16 * CT columns][8 * NR rows], then each (column, row)'s
// slab sum and total [2][16 * CT][8 * NR], kept between rounds.
template <int NR, int CT>
__global__ void __launch_bounds__(32 * kGvMaxWarps)
w4a8_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ ds,
                 const int8_t* __restrict__ wp, const float* __restrict__ cw,
                 float* __restrict__ out, int m, int n, int kp, int bk, int ns, int gs) {
  constexpr int R = 8 * NR, C = 16 * CT;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = (blockDim.x >> 5) * gs;
  float* prod = smem;
  float* state = smem + static_cast<size_t>(rg) * C * R;
  const int ng = kp / kGroup, gps = bk / kGroup;
  const int col0 = blockIdx.x * C;
  const size_t wstride = static_cast<size_t>(kp) / 2;

  // while the pre-pass may still run: the warp's first batch of its first
  // tile's packed weights and group scales into L2 (scale rows are 16-byte
  // aligned when n % 4 == 0)
  const int pb = warp * gs, pe = min(ng, pb + min(gs, kGvBatch));
  if (lane < 16 && col0 + lane < n && pb < pe)
    qg::prefetch_l2(wp + (col0 + lane) * wstride + pb * (kGroup / 2), (pe - pb) * (kGroup / 2));
  if (n % 4 == 0 && lane >= 16 && pb + lane - 16 < pe)
    qg::prefetch_l2(cw + static_cast<size_t>(pb + lane - 16) * n + col0, 4 * min(16, n - col0));
  qg::grid_dependency_wait();   // the pre-pass's codes and slab scales are written

  for (int r0 = 0; r0 < ng; r0 += rg) {
    const int gb = r0 + warp * gs, ge = min(ng, gb + gs);
    for (int g0 = gb; g0 < ge; g0 += kGvBatch) {
      // B fragments: codes [16t, 16t + 16) and [64 + 16t, 80 + 16t) of each
      // group of rows g and g + 8 (the rows the packed bytes' nibbles hold)
      int4 xf[NR][kGvBatch][2];
#pragma unroll
      for (int s = 0; s < kGvBatch; ++s)
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const int8_t* p = xq + static_cast<size_t>(g + 8 * r) * kp + (g0 + s) * kGroup + 16 * t;
          const bool ok = g + 8 * r < m && g0 + s < ge;
          xf[r][s][0] = qg::load16(p, ok);
          xf[r][s][1] = qg::load16(p + 64, ok);
        }
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        // A fragments: packed bytes [16t, 16t + 16) of each group of columns
        // g and g + 8 of tile c, and the groups' scales
        const int col = col0 + 16 * c + g;
        const int8_t* wa = wp + static_cast<size_t>(col) * wstride + 16 * t;
        const int8_t* wb = wa + 8 * wstride;
        int4 va[kGvBatch], vb[kGvBatch];
        float ca[kGvBatch], cb[kGvBatch];
#pragma unroll
        for (int s = 0; s < kGvBatch; ++s) {
          const int gi = g0 + s;
          const bool in = gi < ge;
          va[s] = qg::load16(wa + gi * (kGroup / 2), in && col < n);
          vb[s] = qg::load16(wb + gi * (kGroup / 2), in && col + 8 < n);
          ca[s] = in && col < n ? __ldg(cw + static_cast<size_t>(gi) * n + col) : 0.f;
          cb[s] = in && col + 8 < n ? __ldg(cw + static_cast<size_t>(gi) * n + col + 8) : 0.f;
        }
#pragma unroll
        for (int s = 0; s < kGvBatch; ++s) {
          if (g0 + s >= ge) break;
          uint32_t la[4], ha[4], lb[4], hb[4];
          unpack16(va[s], la, ha);
          unpack16(vb[s], lb, hb);
          const uint32_t a[4][4] = {{la[0], lb[0], la[1], lb[1]}, {la[2], lb[2], la[3], lb[3]},
                                    {ha[0], hb[0], ha[1], hb[1]}, {ha[2], hb[2], ha[3], hb[3]}};
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            const uint32_t b[4][2] = {
                {static_cast<uint32_t>(xf[r][s][0].x), static_cast<uint32_t>(xf[r][s][0].y)},
                {static_cast<uint32_t>(xf[r][s][0].z), static_cast<uint32_t>(xf[r][s][0].w)},
                {static_cast<uint32_t>(xf[r][s][1].x), static_cast<uint32_t>(xf[r][s][1].y)},
                {static_cast<uint32_t>(xf[r][s][1].z), static_cast<uint32_t>(xf[r][s][1].w)}};
            int acc[4] = {0, 0, 0, 0};
#pragma unroll
            for (int j = 0; j < 4; ++j) qg::mma_s8(acc, a[j], b[j]);
            // (column g, rows 2t, 2t + 1) and (column g + 8, the same rows)
            float* p = prod + (static_cast<size_t>(g0 + s - r0) * C + 16 * c + g) * R + 8 * r + 2 * t;
            *reinterpret_cast<float2*>(p) = make_float2(__fmul_rn(__int2float_rn(acc[0]), ca[s]),
                                                        __fmul_rn(__int2float_rn(acc[1]), ca[s]));
            *reinterpret_cast<float2*>(p + 8 * R) =
                make_float2(__fmul_rn(__int2float_rn(acc[2]), cb[s]),
                            __fmul_rn(__int2float_rn(acc[3]), cb[s]));
          }
        }
      }
    }
    __syncthreads();
    // one thread per (column, row) folds the round's groups in order, slab
    // by slab: the slab's scale is loaded before its adds
    const int re = min(ng, r0 + rg);
    for (int i = threadIdx.x; i < C * m; i += blockDim.x) {
      const int cl = i / m, row = i % m;
      float sacc = r0 ? state[cl * R + row] : 0.f;
      float tot = r0 ? state[(C + cl) * R + row] : 0.f;
      for (int s = r0 / gps; s * gps < re; ++s) {
        const int glo = max(r0, s * gps), ghi = min(re, (s + 1) * gps);
        const float d = ds[static_cast<size_t>(row) * ns + s];
        for (int gi = glo; gi < ghi; ++gi)
          sacc = __fadd_rn(sacc, prod[(static_cast<size_t>(gi - r0) * C + cl) * R + row]);
        if (ghi == (s + 1) * gps || ghi == ng) {   // the slab ends in this round
          tot = __fadd_rn(tot, __fmul_rn(sacc, d));
          sacc = 0.f;
        }
      }
      if (re < ng) {
        state[cl * R + row] = sacc;
        state[(C + cl) * R + row] = tot;
      } else if (col0 + cl < n) {
        out[static_cast<size_t>(row) * n + col0 + cl] = tot;
      }
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------ m > 16 rows
constexpr int kTM = 64, kTN = 128, kTPad = 16;
constexpr int kTThreads = 256;   // 8 warps as 2 x 4, each a 32 x 32 tile

__global__ void __launch_bounds__(kTThreads)
w4a8_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ ds,
                const int8_t* __restrict__ wp, const float* __restrict__ cw,
                float* __restrict__ out, int m, int n, int kp, int bk, int ns) {
  __shared__ __align__(16) int8_t As[kTM][kGroup + kTPad];
  __shared__ __align__(16) int8_t Bs[kTN][kGroup + kTPad];
  __shared__ float cws[kTN];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g8 = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kTM, col0 = blockIdx.x * kTN;
  const size_t wstride = static_cast<size_t>(kp) / 2;
  const int ng = kp / kGroup;
  float sacc[2][4][4], tot[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[i][j][e] = tot[i][j][e] = 0.f;

  for (int g = 0; g < ng; ++g) {
    // A: 64 rows x 128 codes
    for (int i = tid; i < kTM * (kGroup / 16); i += kTThreads) {
      const int r = i / (kGroup / 16), kv = (i % (kGroup / 16)) * 16;
      const int gr = row0 + r;
      int4 v = make_int4(0, 0, 0, 0);
      if (gr < m)
        v = *reinterpret_cast<const int4*>(xq + static_cast<size_t>(gr) * kp + g * kGroup + kv);
      *reinterpret_cast<int4*>(&As[r][kv]) = v;
    }
    // B: 128 columns x 64 packed bytes, each 16-byte vector unpacked to the
    // group's rows [q*16, q*16+16) (low nibbles) and [64+q*16, 64+q*16+16)
    for (int i = tid; i < kTN * 4; i += kTThreads) {
      const int c = i / 4, q = i % 4;
      const int gn = col0 + c;
      int4 v = make_int4(0, 0, 0, 0);
      if (gn < n)
        v = __ldg(reinterpret_cast<const int4*>(wp + gn * wstride + g * (kGroup / 2) + q * 16));
      const uint32_t w[4] = {static_cast<uint32_t>(v.x), static_cast<uint32_t>(v.y),
                             static_cast<uint32_t>(v.z), static_cast<uint32_t>(v.w)};
      int lo[4], hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo[j] = sext4(w[j] & 0x0F0F0F0Fu);
        hi[j] = sext4((w[j] >> 4) & 0x0F0F0F0Fu);
      }
      *reinterpret_cast<int4*>(&Bs[c][q * 16]) = make_int4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<int4*>(&Bs[c][64 + q * 16]) = make_int4(hi[0], hi[1], hi[2], hi[3]);
    }
    if (tid < kTN) cws[tid] = col0 + tid < n ? cw[static_cast<size_t>(g) * n + col0 + tid] : 0.f;
    __syncthreads();

    int acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
#pragma unroll
    for (int kk = 0; kk < kGroup; kk += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16 + g8;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + t * 4]);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + t * 4]);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 16 + t * 4]);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 16 + t * 4]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = wn * 32 + nt * 8 + g8;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(&Bs[c][kk + t * 4]);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(&Bs[c][kk + 16 + t * 4]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) qg::mma_s8(acc[mt][nt], a[mt], b[nt]);
    }
    // fold the group's exact sums into the slab's f32 sum
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sacc[mt][nt][e] = __fadd_rn(sacc[mt][nt][e],
                                      __fmul_rn(__int2float_rn(acc[mt][nt][e]),
                                                cws[wn * 32 + nt * 8 + t * 2 + (e & 1)]));
    if ((g + 1) * kGroup % bk == 0 || g + 1 == ng) {
      const int s = g * kGroup / bk;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row0 + wm * 32 + mt * 16 + g8 + (e >= 2 ? 8 : 0);
          const float d = r < m ? ds[static_cast<size_t>(r) * ns + s] : 0.f;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            tot[mt][nt][e] = __fadd_rn(tot[mt][nt][e], __fmul_rn(sacc[mt][nt][e], d));
            sacc[mt][nt][e] = 0.f;
          }
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + wm * 32 + mt * 16 + g8 + (e >= 2 ? 8 : 0);
        const int c = col0 + wn * 32 + nt * 8 + t * 2 + (e & 1);
        if (r < m && c < n) out[static_cast<size_t>(r) * n + c] = tot[mt][nt][e];
      }
}

// The GEMV's launch plan (ops/cuda/gemv_plan.py): warps per block, groups
// per warp and round, column tiles per block, dynamic shared memory in bytes.
struct GemvPlan {
  int warps, gs, ct, smem;
};

bool plan_ok(const GemvPlan& p, int m, int kp) {
  const int nr = m <= 8 ? 1 : 2, ng = kp / kGroup;
  return p.warps >= 1 && p.warps <= kGvMaxWarps && p.gs >= 1 && p.gs <= 16 &&
         (p.gs & (p.gs - 1)) == 0 && (p.warps - 1) * p.gs < ng &&
         (p.ct == 1 || p.ct == 2 || p.ct == 4) && p.smem <= kSmemLimit &&
         p.smem == 4 * (p.warps * p.gs + 2) * 16 * p.ct * 8 * nr;
}

template <int NR, int CT>
cudaError_t launch_gemv(const int8_t* xq, const float* ds, const int8_t* wp, const float* cw,
                        float* out, int m, int n, int kp, int bk, int ns, const GemvPlan& p,
                        cudaStream_t s) {
  if (p.smem > 48 * 1024) {   // once per device: allow this kernel the block's limit
    static unsigned long long allowed = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess && !(allowed >> dev & 1ull)) {
      e = cudaFuncSetAttribute(w4a8_gemv_kernel<NR, CT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
      if (e == cudaSuccess) allowed |= 1ull << dev;
    }
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((n + 16 * CT - 1) / (16 * CT));
  return qg::launch_pdl(w4a8_gemv_kernel<NR, CT>, grid, dim3(32 * p.warps), p.smem, s, xq, ds,
                        wp, cw, out, m, n, kp, bk, ns, p.gs);
}

template <typename T>
cudaError_t launch(const T* x, const int8_t* wp, const float* cw, int8_t* xq, float* ds,
                   float* out, int m, int n, int k, int kp, int bk, const GemvPlan& p,
                   cudaStream_t s) {
  if (m <= 16 && !plan_ok(p, m, kp)) return cudaErrorInvalidValue;
  const int ns = (kp + bk - 1) / bk;
  const int vec = k % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  qg::row_quantize_kernel<T><<<m * ns, qg::quant_threads(bk), 0, s>>>(
      x, xq, ds, k, kp, bk, ns, vec, 0, qg::kQRange * kW4Range);
  cudaError_t e = cudaSuccess;
  if (m > 16) {
    const dim3 grid((n + kTN - 1) / kTN, (m + kTM - 1) / kTM);
    w4a8_mma_kernel<<<grid, kTThreads, 0, s>>>(xq, ds, wp, cw, out, m, n, kp, bk, ns);
  } else {
#define QG_GEMV(NR, CT) e = launch_gemv<NR, CT>(xq, ds, wp, cw, out, m, n, kp, bk, ns, p, s)
    if (m <= 8) {
      if (p.ct == 1) QG_GEMV(1, 1);
      else if (p.ct == 2) QG_GEMV(1, 2);
      else QG_GEMV(1, 4);
    } else {
      if (p.ct == 1) QG_GEMV(2, 1);
      else if (p.ct == 2) QG_GEMV(2, 2);
      else QG_GEMV(2, 4);
    }
#undef QG_GEMV
  }
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// x [m, k] (x_dtype 0 = f32, 1 = bf16), wp int8 [n, kp/2] packed K-major,
// cw f32 [kp/128, n], xq int8 [m, kp] and ds f32 [m, ceil(kp/bk)] scratch,
// out f32 [m, n]; kp = k rounded up to 128, bk the slab width (a multiple of
// 128); for m <= 16 the GEMV's plan (warps, gs, ct, smem:
// ops/cuda/gemv_plan.py), refused unless it matches a compiled
// instantiation. Returns cudaGetLastError().
extern "C" int qgemm_w4a8_matmul(const void* x, int x_dtype, const void* wp, const void* cw,
                                 void* xq, void* ds, void* out, int m, int n, int k, int kp,
                                 int bk, int warps, int gs, int ct, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0 || kp % kGroup != 0 || kp < k || kp - k >= kGroup ||
      bk <= 0 || bk % kGroup != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const GemvPlan p{warps, gs, ct, smem};
  cudaError_t e;
  if (x_dtype == 0)
    e = launch(static_cast<const float*>(x), static_cast<const int8_t*>(wp),
               static_cast<const float*>(cw), static_cast<int8_t*>(xq), static_cast<float*>(ds),
               static_cast<float*>(out), m, n, k, kp, bk, p, s);
  else if (x_dtype == 1)
    e = launch(static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wp),
               static_cast<const float*>(cw), static_cast<int8_t*>(xq), static_cast<float*>(ds),
               static_cast<float*>(out), m, n, k, kp, bk, p, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
