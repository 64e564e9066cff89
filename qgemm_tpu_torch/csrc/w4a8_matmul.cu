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
//
// Design:
//   * a pre-pass, one warp per (row, slab), takes the slab's absmax and writes
//     the int8 codes xq [m, kp] (zeros past k) and ds = cx / 889, with the same
//     f32 operations as the plain version (scale 127 / cx, x * scale, round
//     half to even), so the codes match it bit for bit;
//   * weights are packed K-major ([n, kp / 2]): one column's group is 64
//     contiguous bytes, the low nibble of byte j holding row j of the group and
//     the high nibble row 64 + j. Nibbles are sign-extended in registers
//     (mask, then OR in 0xF0 where bit 3 is set: no carries between bytes);
//   * every f32 step is an explicit __fmul_rn / __fadd_rn in the plain
//     version's order — groups in order inside a slab, then the slab's sum
//     times ds, slabs in order — so both kernels below give the plain
//     version's bits, and a row's result does not depend on m;
//   * m <= 16: a GEMV-shaped kernel — a warp reads 8 groups (512 bytes) of a
//     column per 16-byte load, 4 lanes per group, __dp4a against the codes in
//     shared memory, the 4 lanes' int32 sums joined by shuffles, and one lane
//     per (row, column) folds the groups in order;
//   * m > 16: 64 x 128 block tiles, one group (K = 128) per step unpacked into
//     shared memory, mma.sync m16n8k32 s8 -> s32 per group, folded into f32;
//   * ragged m, n and k are masked in the kernels; W is never padded per call.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr float kQRange = 127.f;
constexpr float kW4Range = 7.f;
constexpr float kEps = 1e-12f;
constexpr int kGroup = 128;

__device__ __forceinline__ uint2 quant8(const float v[8], float s) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = max(-127, min(127, __float2int_rn(v[i] * s)));
    w[i / 4] |= (static_cast<uint32_t>(q) & 0xffu) << (8 * (i % 4));
  }
  return make_uint2(w[0], w[1]);
}

// 8 elements of a row from column i on, zeros at and past column k
template <typename T>
__device__ __forceinline__ void load8_masked(const T* row, int i, int k, bool vec, float v[8]) {
  if (vec && i + 8 <= k) {
    qg::load8(row + i, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = i + j < k ? qg::to_f32(row[i + j]) : 0.f;
}

// sign-extend the four nibbles held in the low halves of a word's bytes
__device__ __forceinline__ int sext4(uint32_t nib) {
  return static_cast<int>(nib | ((nib & 0x08080808u) * 0x1Eu));
}

template <typename T>
__global__ void slab_quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                                     float* __restrict__ ds, int m, int k, int kp, int bk,
                                     int ns, int vec) {
  const int w = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= m * ns) return;
  const int row = w / ns, s = w % ns;
  const int k0 = s * bk, k1 = min(k0 + bk, kp);
  const T* xr = x + static_cast<size_t>(row) * k;
  float mx = 0.f;
  for (int i = k0 + lane * 8; i < min(k1, k); i += 32 * 8) {
    float v[8];
    load8_masked(xr, i, k, vec, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fabsf(v[j]));
  }
  mx = qg::warp_max(mx);
  const float c = fmaxf(mx, kEps);
  const float sc = kQRange / c;
  if (lane == 0) ds[w] = c / (kQRange * kW4Range);
  for (int i = k0 + lane * 8; i < k1; i += 32 * 8) {
    float v[8];
    load8_masked(xr, i, k, vec, v);
    *reinterpret_cast<uint2*>(xq + static_cast<size_t>(row) * kp + i) = quant8(v, sc);
  }
}

// ----------------------------------------------------------- m <= 16 rows
constexpr int kGvThreads = 256;                       // 8 warps
constexpr int kGvWarps = kGvThreads / 32;
constexpr int kGvColsPerWarp = 2;
constexpr int kGvCols = kGvWarps * kGvColsPerWarp;    // 16 per block
constexpr int kGvGroups = 8;                          // groups per K chunk
constexpr int kGvKc = kGvGroups * kGroup;             // 1024 codes per row

template <int MR>
__global__ void __launch_bounds__(kGvThreads)
w4a8_small_m_kernel(const int8_t* __restrict__ xq, const float* __restrict__ ds,
                    const int8_t* __restrict__ wp, const float* __restrict__ cw,
                    float* __restrict__ out, int m, int n, int kp, int bk, int ns) {
  __shared__ __align__(16) int8_t xs[MR][kGvKc];
  __shared__ float gp[kGvWarps][kGvColsPerWarp][MR][kGvGroups];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = lane >> 2, qd = lane & 3;     // load role: group of the chunk, 16-byte quarter
  const int fc = lane >> 4, fr = lane & 15;    // fold role: column of the warp, row
  const int col0 = blockIdx.x * kGvCols + warp * kGvColsPerWarp;
  const size_t wstride = static_cast<size_t>(kp) / 2;
  float sacc = 0.f, tot = 0.f;

  for (int k0 = 0; k0 < kp; k0 += kGvKc) {
    const int kc = min(kGvKc, kp - k0), ng = kc / kGroup, s = k0 / bk;
    for (int i = threadIdx.x; i < MR * (kGvKc / 16); i += kGvThreads) {
      const int r = i / (kGvKc / 16), kk = (i % (kGvKc / 16)) * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (r < m && kk < kc)
        v = *reinterpret_cast<const int4*>(xq + static_cast<size_t>(r) * kp + k0 + kk);
      *reinterpret_cast<int4*>(&xs[r][kk]) = v;
    }
    int4 wv[kGvColsPerWarp];
#pragma unroll
    for (int c = 0; c < kGvColsPerWarp; ++c) {
      const int col = col0 + c;
      wv[c] = make_int4(0, 0, 0, 0);
      if (col < n && gi < ng)
        wv[c] = __ldg(reinterpret_cast<const int4*>(wp + col * wstride + k0 / 2 + gi * 64 + qd * 16));
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kGvColsPerWarp; ++c) {
      const uint32_t w[4] = {static_cast<uint32_t>(wv[c].x), static_cast<uint32_t>(wv[c].y),
                             static_cast<uint32_t>(wv[c].z), static_cast<uint32_t>(wv[c].w)};
      int lo[4], hi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo[i] = sext4(w[i] & 0x0F0F0F0Fu);
        hi[i] = sext4((w[i] >> 4) & 0x0F0F0F0Fu);
      }
      int acc[MR];
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        const int4 xl = *reinterpret_cast<const int4*>(&xs[r][gi * kGroup + qd * 16]);
        const int4 xh = *reinterpret_cast<const int4*>(&xs[r][gi * kGroup + 64 + qd * 16]);
        int a = 0;
        a = __dp4a(xl.x, lo[0], a);
        a = __dp4a(xl.y, lo[1], a);
        a = __dp4a(xl.z, lo[2], a);
        a = __dp4a(xl.w, lo[3], a);
        a = __dp4a(xh.x, hi[0], a);
        a = __dp4a(xh.y, hi[1], a);
        a = __dp4a(xh.z, hi[2], a);
        a = __dp4a(xh.w, hi[3], a);
        a += __shfl_xor_sync(0xffffffffu, a, 1);
        a += __shfl_xor_sync(0xffffffffu, a, 2);
        acc[r] = a;
      }
      const int col = col0 + c;
      if (qd == 0 && gi < ng && col < n) {
        const float cwv = cw[static_cast<size_t>(k0 / kGroup + gi) * n + col];
#pragma unroll
        for (int r = 0; r < MR; ++r) gp[warp][c][r][gi] = __fmul_rn(__int2float_rn(acc[r]), cwv);
      }
    }
    __syncwarp();
    if (fr < MR && col0 + fc < n) {
      for (int g = 0; g < ng; ++g) sacc = __fadd_rn(sacc, gp[warp][fc][fr][g]);
      if (k0 + kc == kp || (k0 + kc) % bk == 0) {
        if (fr < m) tot = __fadd_rn(tot, __fmul_rn(sacc, ds[fr * ns + s]));
        sacc = 0.f;
      }
    }
    __syncthreads();
  }
  if (fr < MR && fr < m && col0 + fc < n) out[static_cast<size_t>(fr) * n + col0 + fc] = tot;
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

template <typename T>
cudaError_t launch(const T* x, const int8_t* wp, const float* cw, int8_t* xq, float* ds,
                   float* out, int m, int n, int k, int kp, int bk, cudaStream_t s) {
  const int ns = (kp + bk - 1) / bk;
  const int vec = k % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  slab_quantize_kernel<T><<<(m * ns + 7) / 8, 256, 0, s>>>(x, xq, ds, m, k, kp, bk, ns, vec);
  if (m <= 16) {
    const dim3 grid((n + kGvCols - 1) / kGvCols);
#define QG_SMALL(MR) \
  w4a8_small_m_kernel<MR><<<grid, kGvThreads, 0, s>>>(xq, ds, wp, cw, out, m, n, kp, bk, ns)
    if (m <= 1) QG_SMALL(1);
    else if (m <= 2) QG_SMALL(2);
    else if (m <= 4) QG_SMALL(4);
    else if (m <= 8) QG_SMALL(8);
    else QG_SMALL(16);
#undef QG_SMALL
  } else {
    const dim3 grid((n + kTN - 1) / kTN, (m + kTM - 1) / kTM);
    w4a8_mma_kernel<<<grid, kTThreads, 0, s>>>(xq, ds, wp, cw, out, m, n, kp, bk, ns);
  }
  return cudaGetLastError();
}

}  // namespace

// x [m, k] (x_dtype 0 = f32, 1 = bf16), wp int8 [n, kp/2] packed K-major,
// cw f32 [kp/128, n], xq int8 [m, kp] and ds f32 [m, ceil(kp/bk)] scratch,
// out f32 [m, n]; kp = k rounded up to 128, bk the slab width (a multiple of
// 128). Returns cudaGetLastError().
extern "C" int qgemm_w4a8_matmul(const void* x, int x_dtype, const void* wp, const void* cw,
                                 void* xq, void* ds, void* out, int m, int n, int k, int kp,
                                 int bk, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0 || kp % kGroup != 0 || kp < k || kp - k >= kGroup ||
      bk <= 0 || bk % kGroup != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (x_dtype == 0)
    e = launch(static_cast<const float*>(x), static_cast<const int8_t*>(wp),
               static_cast<const float*>(cw), static_cast<int8_t*>(xq), static_cast<float*>(ds),
               static_cast<float*>(out), m, n, k, kp, bk, s);
  else if (x_dtype == 1)
    e = launch(static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wp),
               static_cast<const float*>(cw), static_cast<int8_t*>(xq), static_cast<float*>(ds),
               static_cast<float*>(out), m, n, k, kp, bk, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
