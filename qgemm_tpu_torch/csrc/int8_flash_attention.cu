// Int8 blockwise (flash) attention forward for Hopper (sm_90a): the kernel
// of row 12, and its pre-pass.
//
// Replaces _int8_flash_kernel of qgemm_tpu/ops/pallas/int8_flash_attention.py
// and the XLA pre-pass of its flash_attention_int8 (K less its per-channel
// mean over the sequence; Q and K int8 per row, V int8 per channel, /127
// folded into the row scales; qk_only leaves V in bf16). Same math per key
// tile, in f32:
//   s = (q8 . k8)_s32 * (sq * scale) * sk, with s = -1e30 where the key is
//       past Sk or, when causal, kj > qi (top-left aligned);
//   m_new = max(m, max_j s), p = exp(s - m_new) (0 where masked),
//   alpha = exp(m - m_new);
//   int8 P (the default): p8 = rint(p * 127) as int8, l = l * alpha + sum p8,
//       acc = acc * alpha + (p8 . v8)_s32;
//   qk_only: P rounded to bf16 times V in bf16 with f32 sums, l sums the f32 p;
// and at the end o = acc / max(l, 1e-6) (times 1/127 with int8 P), stored in
// the output dtype. Every multiply and add of that update is rounded on its
// own (no fused multiply-add), as the plain version's tensor ops are. Every
// max keeps a NaN, as torch's amax and JAX's max do: a NaN in q, k or v
// reaches the output as it does in the plain version.
// P is quantized against the running max at the end of each KEY TILE, so
// its codes depend on the tile width: this kernel's tile is 128 keys, the
// TPU kernel's min(1024, Sk rounded up to 128). The plain version takes the
// tile width as an argument.
//
// What bounds it on the H100: at GPT_6_7B's prefill (H 32, S 2048, D 128,
// causal) the operations, 2 * 2 * D int8 ops per attended (query, key)
// pair on the tensor cores (1,979 TOP/s), against ~42 MB of int8 q/k/v and
// the output. The pre-pass is bound by bytes: one read of Q, K and V and one
// write of the codes (with qk_only, of Q's and K's only: V stays bf16).
//
// Design (the plan is ops/cuda/int8_flash_plan.py's):
// * pre-pass, two launches. prepass_col_kernel: one block per (64-key
//   chunk, batch*head), a thread per channel sums K over the chunk in row
//   order and takes V's absmax. prepass_row_kernel: Q and K rows, one warp
//   a row (the chunks' sums added in chunk order, then / Sk, give the mean;
//   the codes follow torch's op order: f32 x / c, then * 127, round half to
//   even), written as 128-byte code rows; V in tiles of 128 keys, its codes
//   written transposed [BH, DV, Skp] with each group of 32 keys permuted so
//   that P's accumulator fragments are the P V product's A operand as they
//   lie (no shuffles, no shared-memory pass for P). qk_only reads V as it
//   is where it is bf16 with rows of a multiple of 8 channels; else the V
//   blocks cast it to bf16 rows of dv rounded up to 8 (zero past dv).
// * main kernel, int8_flash_wgmma_kernel: one block per (64 query rows,
//   batch*head), one consumer warpgroup and one producer warp. The
//   producer's lane 0 loads the Q tile once and keeps a ring of 2 stages
//   full by TMA (128-byte swizzle, full and empty mbarriers): K's code tile
//   [128 keys x 128 bytes] and V's transposed tile [DV x 128 keys] (qk_only:
//   V's bf16 tile [128 keys x 64 channels] per 64 channels, MN-major). The
//   consumers run S = Q K^T as wgmma m64n128k32 s8 -> s32 from shared
//   memory over the D / 32 k32 slices of the code rows that hold D, the
//   online softmax on the accumulator fragments (a row's max and sum across
//   the 4 lanes of a quad), then P V as wgmma m64nNk32 s8 in chunks of N =
//   64 channels (DV 32: one of 32) with P's codes in registers (qk_only:
//   m64n64k16 bf16 with V's tile as the MN-major B operand). The mask runs
//   only on tiles that pass Sk or, causal, the tile's first row; causal
//   grids take their longest query tiles first.
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

namespace sm90 = qg::sm90;

constexpr int kBQ = 64, kBK = 128, kRow = 128;
constexpr int kMaxRow = 1024;   // the widest code row (D 1024): 8 boxes of kRow bytes
constexpr int kConsumers = 128, kThreads = kConsumers + 32;
constexpr int kChunkRows = 64, kColThreads = 128;
constexpr int kRowsPerBlock = 32, kRowThreads = 256;
constexpr float kNegBig = -1e30f;
constexpr float kEps = 1e-6f;

// CR: bytes of a Q or K code row (128, or the padded head width past it),
// loaded and laid out as CR / 128 swizzled boxes of 128-byte rows
template <int DV, bool P8, int CR = kRow> struct FlashCfg {
  static constexpr int kHalves = CR / kRow;                 // boxes of a code row
  static constexpr int kQBox = kBQ * kRow;                   // one box of the Q tile
  static constexpr int kKBox = kBK * kRow;                   // one box of a K tile
  static constexpr int kQBytes = kBQ * CR;
  static constexpr int kKBytes = kBK * CR;
  static constexpr int kVBoxes = (DV + 63) / 64;            // bf16: 64-channel boxes
  static constexpr int kVBox = kBK * kRow;                   // bf16: 128 keys x 64 channels
  static constexpr int kVBytes = P8 ? DV * kBK : kVBoxes * kVBox;
  static constexpr int kStage = kKBytes + kVBytes;
  static constexpr int kSkBytes = kBK * 4;                // a tile's K row scales, after the ring
  static constexpr int kStages = CR <= 512 ? 2 : 1;      // D 1024: one stage fits
  static constexpr int kSmem = sm90::kAlign + kQBytes + kStages * (kStage + kSkBytes);
};

// An integer of magnitude below 2^22 added to 1.5 * 2^23 lands in the
// float's low mantissa bits: exact conversions at full rate (the
// converting instructions run at a quarter of it).
constexpr int kMagicBits = 0x4B400000;
constexpr float kMagic = 12582912.f;
__device__ __forceinline__ float exact_f32(int x) {   // |x| < 2^22
  return __fsub_rn(__int_as_float(kMagicBits + x), kMagic);
}
__device__ __forceinline__ int rint_small(float y) {   // 0 <= y < 2^22, half to even
  return __float_as_int(__fadd_rn(y, kMagic)) - kMagicBits;
}

// max that keeps a NaN, as torch's amax does (fmaxf drops it)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// ------------------------------------------------------------- the pre-pass
__device__ __forceinline__ int code_of(float x, float c) {
  return __float2int_rn(__fmul_rn(__fdiv_rn(x, c), 127.f));
}

// grid (nchunk, BH), kColThreads threads: thread c sums K's channel c over
// the chunk's rows in row order and takes V's absmax of channel c
template <typename T>
__global__ void __launch_bounds__(kColThreads)
prepass_col_kernel(const T* __restrict__ k, const T* __restrict__ v, float* __restrict__ ksum,
                   float* __restrict__ vmax, int sk, int d, int dv, int nchunk, int qk_only) {
  const int bh = blockIdx.y, ch = blockIdx.x, c = threadIdx.x;
  const int r0 = ch * kChunkRows, r1 = min(sk, r0 + kChunkRows);
  if (c < d) {
    const T* kp = k + static_cast<size_t>(bh) * sk * d + c;
    float s = 0.f;
#pragma unroll 16
    for (int r = r0; r < r1; ++r) s = __fadd_rn(s, qg::to_f32(kp[static_cast<size_t>(r) * d]));
    ksum[(static_cast<size_t>(bh) * nchunk + ch) * d + c] = s;
  }
  if (!qk_only && c < dv) {
    const T* vp = v + static_cast<size_t>(bh) * sk * dv + c;
    float m = 0.f;
#pragma unroll 16
    for (int r = r0; r < r1; ++r) m = max_nan(m, fabsf(qg::to_f32(vp[static_cast<size_t>(r) * dv])));
    vmax[(static_cast<size_t>(bh) * nchunk + ch) * dv + c] = m;
  }
}


// The wide route's column pass (d or dv past 128): grid (nchunk, BH),
// kColThreads threads: thread t sums K's channels t,
// t + 128, ... over the chunk's rows in row order and takes V's absmax of
// those channels
template <typename T>
__global__ void __launch_bounds__(kColThreads)
prepass_col_wide_kernel(const T* __restrict__ k, const T* __restrict__ v, float* __restrict__ ksum,
                   float* __restrict__ vmax, int sk, int d, int dv, int nchunk, int qk_only) {
  const int bh = blockIdx.y, ch = blockIdx.x;
  const int r0 = ch * kChunkRows, r1 = min(sk, r0 + kChunkRows);
  for (int c = threadIdx.x; c < d; c += kColThreads) {
    const T* kp = k + static_cast<size_t>(bh) * sk * d + c;
    float s = 0.f;
#pragma unroll 16
    for (int r = r0; r < r1; ++r) s = __fadd_rn(s, qg::to_f32(kp[static_cast<size_t>(r) * d]));
    ksum[(static_cast<size_t>(bh) * nchunk + ch) * d + c] = s;
  }
  for (int c = threadIdx.x; c < dv && !qk_only; c += kColThreads) {
    const T* vp = v + static_cast<size_t>(bh) * sk * dv + c;
    float m = 0.f;
#pragma unroll 16
    for (int r = r0; r < r1; ++r) m = max_nan(m, fabsf(qg::to_f32(vp[static_cast<size_t>(r) * dv])));
    vmax[(static_cast<size_t>(bh) * nchunk + ch) * dv + c] = m;
  }
}

// Lane l's channels 4l..4l+3 of a row x of width d (zero past d): one 8- or
// 16-byte load where d is a multiple of 4, else one element at a time.
__device__ __forceinline__ void load4(const float* x, int d, int lane, float (&f)[4]) {
  const int c0 = 4 * lane;
  if (d % 4 == 0) {
    const float4 u = c0 < d ? __ldg(reinterpret_cast<const float4*>(x + c0))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = c0 + j < d ? x[c0 + j] : 0.f;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* x, int d, int lane, float (&f)[4]) {
  const int c0 = 4 * lane;
  if (d % 4 == 0) {
    const uint2 u = c0 < d ? __ldg(reinterpret_cast<const uint2*>(x + c0)) : make_uint2(0, 0);
    f[0] = __uint_as_float(u.x << 16); f[1] = __uint_as_float(u.x & 0xffff0000u);
    f[2] = __uint_as_float(u.y << 16); f[3] = __uint_as_float(u.y & 0xffff0000u);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = c0 + j < d ? __bfloat162float(x[c0 + j]) : 0.f;
}

// One Q or K row by one warp, lane l holding channels 4l..4l+3 in ``vals``
// (zero past d; K's already less the mean): the row's codes into a
// 128-byte row, its scale (with 1/127) into ``sc``.
__device__ __forceinline__ void code_row(const float (&vals)[4], int d, int8_t* row, float* sc,
                                         int lane) {
  float mx = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) mx = max_nan(mx, fabsf(vals[j]));
#pragma unroll
  for (int o = 16; o; o >>= 1) mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  const float cs = max_nan(mx, kEps);   // a NaN scale gives codes 0
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = 4 * lane + j < d ? code_of(vals[j], cs) : 0;
    word |= (static_cast<uint32_t>(q) & 0xffu) << (8 * j);
  }
  reinterpret_cast<uint32_t*>(row)[lane] = word;
  if (lane == 0) *sc = __fmul_rn(cs, 1.f / 127.f);
}


// One Q or K row by one warp, lane l holding channels 128 v + 4l..4l+3 of
// each box v < NV in ``vals[v]`` (zero past d; K's already less the mean):
// the row's codes into a row of NV * 128 bytes, its scale (with 1/127)
// into ``sc``.
template <int NV>
__device__ __forceinline__ void code_row_wide(const float (&vals)[NV][4], int d, int8_t* row,
                                         float* sc, int lane) {
  float mx = 0.f;
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int j = 0; j < 4; ++j) mx = max_nan(mx, fabsf(vals[v][j]));
#pragma unroll
  for (int o = 16; o; o >>= 1) mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  const float cs = max_nan(mx, kEps);   // a NaN scale gives codes 0
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = kRow * v + 4 * lane + j < d ? code_of(vals[v][j], cs) : 0;
      word |= (static_cast<uint32_t>(q) & 0xffu) << (8 * j);
    }
    reinterpret_cast<uint32_t*>(row)[32 * v + lane] = word;
  }
  if (lane == 0) *sc = __fmul_rn(cs, 1.f / 127.f);
}

// key (within its group of 32) at position p of V's transposed codes
__device__ __forceinline__ int key_of_position(int p) {
  return 16 * (p >> 4) + 8 * ((p & 3) >> 1) + 2 * ((p >> 2) & 3) + (p & 1);
}

// grid (nq + nk + nv, BH), kRowThreads threads: Q row blocks, K row blocks,
// then V tiles of kBK keys (none with qk_only where V is read as it is).
// vw: V's rows, DV (int8) or the bf16 copy's width (qk_only).
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
prepass_row_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   int8_t* __restrict__ q8, int8_t* __restrict__ k8, void* __restrict__ vt,
                   float* __restrict__ sqs, float* __restrict__ sks, float* __restrict__ vc,
                   const float* __restrict__ ksum, const float* __restrict__ vmax, int sq, int sk,
                   int d, int dv, int vw, int skp, int nchunk, int nq, int nk, int qk_only) {
  __shared__ float mean[128];
  __shared__ int8_t tile[kBK * 129];   // V's codes of a tile
  const int bh = blockIdx.y, x = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (x < nq + nk) {
    const bool is_k = x >= nq;
    const int n = is_k ? sk : sq;
    const int r0 = (is_k ? x - nq : x) * kRowsPerBlock;
    if (is_k) {
      if (tid < d) {   // the chunks' sums in chunk order, then the mean
        float s = 0.f;
#pragma unroll 8
        for (int ch = 0; ch < nchunk; ++ch)   // loads in flight together, sums in order
          s = __fadd_rn(s, ksum[(static_cast<size_t>(bh) * nchunk + ch) * d + tid]);
        mean[tid] = __fdiv_rn(s, static_cast<float>(sk));
      }
      __syncthreads();
    }
    const T* src = (is_k ? k : q) + static_cast<size_t>(bh) * n * d;
    int8_t* dst = (is_k ? k8 : q8) + static_cast<size_t>(bh) * n * kRow;
    float* sc = is_k ? sks + static_cast<size_t>(bh) * skp : sqs + static_cast<size_t>(bh) * n;
    if (is_k && x - nq == nk - 1 && tid < skp - sk) sc[sk + tid] = 0.f;   // K's scales past sk
    constexpr int R = kRowsPerBlock / 8;   // rows a warp: all loads first
    const int rw = r0 + warp * R;
    float vals[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (rw + i < n) load4(src + static_cast<size_t>(rw + i) * d, d, lane, vals[i]);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (rw + i >= n) continue;
      if (is_k) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (4 * lane + j < d) vals[i][j] = __fsub_rn(vals[i][j], mean[4 * lane + j]);
      }
      code_row(vals[i], d, dst + static_cast<size_t>(rw + i) * kRow, sc + rw + i, lane);
    }
    return;
  }
  // V: keys [t0, t0 + kBK)
  const int t0 = (x - nq - nk) * kBK;
  const T* vb = v + static_cast<size_t>(bh) * sk * dv;
  if (qk_only) {   // bf16 rows of vw channels in key order, zero past dv
    auto* out = static_cast<__nv_bfloat16*>(vt) + static_cast<size_t>(bh) * sk * vw;
    const int rows = min(kBK, sk - t0);
    for (int i = tid; i < rows * vw; i += kRowThreads) {
      const int r = t0 + i / vw, c = i % vw;
      out[static_cast<size_t>(r) * vw + c] =
          __float2bfloat16_rn(c < dv ? qg::to_f32(vb[static_cast<size_t>(r) * dv + c]) : 0.f);
    }
    return;
  }
  if (tid < dv) {
    float m = 0.f;
#pragma unroll 8
    for (int ch = 0; ch < nchunk; ++ch)
      m = max_nan(m, vmax[(static_cast<size_t>(bh) * nchunk + ch) * dv + tid]);
    mean[tid] = max_nan(m, kEps);   // V's channel scale
    if (t0 == 0) vc[static_cast<size_t>(bh) * dv + tid] = mean[tid];
  }
  __syncthreads();
  int8_t* vs = tile;   // codes [kBK][129]
  const int c = tid & 127;   // a thread a channel, every other row
  if (c < dv) {
#pragma unroll 8
    for (int r = tid >> 7; r < kBK; r += kRowThreads / 128)
      vs[r * 129 + c] = static_cast<int8_t>(
          t0 + r < sk ? code_of(qg::to_f32(vb[static_cast<size_t>(t0 + r) * dv + c]), mean[c])
                      : 0);
  }
  __syncthreads();
  int8_t* out = static_cast<int8_t*>(vt) + static_cast<size_t>(bh) * vw * skp;
  for (int i = tid; i < vw * (kBK / 4); i += kRowThreads) {
    const int c = i / (kBK / 4), p = 4 * (i % (kBK / 4));
    uint32_t word = 0;
    if (c < dv) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int key = ((p + b) & ~31) + key_of_position((p + b) & 31);
        word |= (static_cast<uint32_t>(vs[key * 129 + c]) & 0xffu) << (8 * b);
      }
    }
    *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(c) * skp + t0 + p) = word;
  }
}


// The wide route's row pass (d or dv past 128): grid (nq + nk + nv, BH),
// kRowThreads threads: Q row blocks, K row blocks,
// then V tiles of kBK keys (none with qk_only where V is read as it is).
// vw: V's rows, DV (int8) or the bf16 copy's width (qk_only). Q and K code
// rows are NV * 128 bytes.
template <typename T, int NV>
__global__ void __launch_bounds__(kRowThreads)
prepass_row_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   int8_t* __restrict__ q8, int8_t* __restrict__ k8, void* __restrict__ vt,
                   float* __restrict__ sqs, float* __restrict__ sks, float* __restrict__ vc,
                   const float* __restrict__ ksum, const float* __restrict__ vmax, int sq, int sk,
                   int d, int dv, int vw, int skp, int nchunk, int nq, int nk, int qk_only) {
  constexpr int CR = NV * kRow;        // bytes of a code row
  __shared__ float mean[kMaxRow];      // K's channel means, then V's channel scales
  __shared__ int8_t tile[kBK * 129];   // V's codes of a tile, 128 channels at a time
  const int bh = blockIdx.y, x = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (x < nq + nk) {
    const bool is_k = x >= nq;
    const int n = is_k ? sk : sq;
    const int r0 = (is_k ? x - nq : x) * kRowsPerBlock;
    if (is_k) {
      for (int c = tid; c < d; c += kRowThreads) {   // the chunks' sums in chunk order, then the mean
        float s = 0.f;
#pragma unroll 8
        for (int ch = 0; ch < nchunk; ++ch)   // loads in flight together, sums in order
          s = __fadd_rn(s, ksum[(static_cast<size_t>(bh) * nchunk + ch) * d + c]);
        mean[c] = __fdiv_rn(s, static_cast<float>(sk));
      }
      __syncthreads();
    }
    const T* src = (is_k ? k : q) + static_cast<size_t>(bh) * n * d;
    int8_t* dst = (is_k ? k8 : q8) + static_cast<size_t>(bh) * n * CR;
    float* sc = is_k ? sks + static_cast<size_t>(bh) * skp : sqs + static_cast<size_t>(bh) * n;
    if (is_k && x - nq == nk - 1 && tid < skp - sk) sc[sk + tid] = 0.f;   // K's scales past sk
    constexpr int R = kRowsPerBlock / 8;   // rows a warp: all loads first
    const int rw = r0 + warp * R;
    float vals[R][NV][4];
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int b = 0; b < NV; ++b)
        if (rw + i < n) load4(src + static_cast<size_t>(rw + i) * d + kRow * b, d - kRow * b, lane, vals[i][b]);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (rw + i >= n) continue;
      if (is_k) {
#pragma unroll
        for (int b = 0; b < NV; ++b)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = kRow * b + 4 * lane + j;
            if (c < d) vals[i][b][j] = __fsub_rn(vals[i][b][j], mean[c]);
          }
      }
      code_row_wide<NV>(vals[i], d, dst + static_cast<size_t>(rw + i) * CR, sc + rw + i, lane);
    }
    return;
  }
  // V: keys [t0, t0 + kBK)
  const int t0 = (x - nq - nk) * kBK;
  const T* vb = v + static_cast<size_t>(bh) * sk * dv;
  if (qk_only) {   // bf16 rows of vw channels in key order, zero past dv
    auto* out = static_cast<__nv_bfloat16*>(vt) + static_cast<size_t>(bh) * sk * vw;
    const int rows = min(kBK, sk - t0);
    for (int i = tid; i < rows * vw; i += kRowThreads) {
      const int r = t0 + i / vw, c = i % vw;
      out[static_cast<size_t>(r) * vw + c] =
          __float2bfloat16_rn(c < dv ? qg::to_f32(vb[static_cast<size_t>(r) * dv + c]) : 0.f);
    }
    return;
  }
  for (int c = tid; c < dv; c += kRowThreads) {
    float m = 0.f;
#pragma unroll 8
    for (int ch = 0; ch < nchunk; ++ch)
      m = max_nan(m, vmax[(static_cast<size_t>(bh) * nchunk + ch) * dv + c]);
    mean[c] = max_nan(m, kEps);   // V's channel scale
    if (t0 == 0) vc[static_cast<size_t>(bh) * dv + c] = mean[c];
  }
  __syncthreads();
  int8_t* vs = tile;   // codes [kBK][129] of channels c0 .. c0 + 127
  int8_t* out = static_cast<int8_t*>(vt) + static_cast<size_t>(bh) * vw * skp;
  for (int c0 = 0; c0 < vw; c0 += 128) {
    const int c = c0 + (tid & 127);   // a thread a channel, every other row
    if (c < dv) {
#pragma unroll 8
      for (int r = tid >> 7; r < kBK; r += kRowThreads / 128)
        vs[r * 129 + (tid & 127)] = static_cast<int8_t>(
            t0 + r < sk ? code_of(qg::to_f32(vb[static_cast<size_t>(t0 + r) * dv + c]), mean[c])
                        : 0);
    }
    __syncthreads();
    const int nrow = min(128, vw - c0);
    for (int i = tid; i < nrow * (kBK / 4); i += kRowThreads) {
      const int cc = i / (kBK / 4), p = 4 * (i % (kBK / 4));
      uint32_t word = 0;
      if (c0 + cc < dv) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int key = ((p + b) & ~31) + key_of_position((p + b) & 31);
          word |= (static_cast<uint32_t>(vs[key * 129 + cc]) & 0xffu) << (8 * b);
        }
      }
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(c0 + cc) * skp + t0 + p) = word;
    }
    __syncthreads();
  }
}

// ------------------------------------------------------- the wgmma products
// m64nNk32 s8 with A from registers, N = 32 (wgmma.cuh has 64)
__device__ __forceinline__ void wgmma_rs(int (&d)[16], const uint32_t (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
__device__ __forceinline__ void wgmma_rs(int (&d)[32], const uint32_t (&a)[4], uint64_t b, int acc) {
  sm90::wgmma_rs(d, a, b, acc);
}

// m64n64k16 bf16 -> f32 with A (P) from registers and B (V) MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
// the descriptor of an MN-major B tile in the 128-byte swizzle: rows of 64
// bf16 channels (128 bytes) a key, 8-key groups 1024 bytes apart; the
// stride between 64-channel blocks is unused at N = 64
__device__ __forceinline__ uint64_t desc_mn_sw128(const void* tile) {
  return static_cast<uint64_t>((qg::smem_addr(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ float pv_f32(int v) { return exact_f32(v); }   // |v| <= 128 * 127^2
__device__ __forceinline__ float pv_f32(float v) { return v; }

// 1-D bulk copy of ``bytes`` (a multiple of 16, both ends 16-byte aligned)
// into shared memory, completing on ``bar``
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(qg::smem_addr(dst)), "l"(src), "r"(bytes), "r"(qg::smem_addr(bar))
      : "memory");
}

template <typename A, int R> __device__ __forceinline__ void fence_acc(A (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if constexpr (std::is_same<A, float>::value)
      asm volatile("" : "+f"(d[i])::"memory");
    else
      asm volatile("" : "+r"(d[i])::"memory");
  }
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) | (static_cast<uint32_t>(d) << 24);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ----------------------------------------------------------- the main kernel
// grid (ceil(Sq / 64) * ceil(dv / DV) * BH) (flattened: query tile, V
// chunk, then batch*head), kThreads threads, FlashCfg<DV, P8, CR>::kSmem
// bytes of dynamic shared memory. tq: q8 [BH, Sq, CR] int8, tk: k8 [BH,
// Sk, CR] (CR = max(128, 32 KS) bytes a code row), tv: V^T [BH, vw, Skp]
// int8 permuted (vw rows, DV a block), or (qk_only) V [BH, Sk, vw] bf16;
// sqs [BH, Sq], sks [BH, Skp] f32 (1/127 folded in; zero past Sk); out
// [BH, Sq, dv] in T, a block writing its chunk's DV columns. KS: the k32
// slices of the code rows that hold D (a compile-time count: products
// under a runtime condition cost ptxas injected warpgroup waits and
// spills).
template <typename T, int DV, bool P8, int KS>
__global__ void __launch_bounds__(kThreads, 2)
int8_flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const float* __restrict__ sqs,
                        const float* __restrict__ sks, T* __restrict__ out, int sq, int sk,
                        int skp, int dv, int causal, float scale) {
  constexpr int CR = KS * 32 > kRow ? KS * 32 : kRow;   // bytes of a code row
  using C = FlashCfg<DV, P8, CR>;
  constexpr int kStages = C::kStages;
  using PV = typename std::conditional<P8, int, float>::type;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kStages], empty[kStages], qbar;
  uint8_t* base = sm90::aligned_smem(smem_raw);
  uint8_t* qs = base;
  auto k_tile = [&](int s) { return base + C::kQBytes + s * C::kStage; };
  auto v_tile = [&](int s) { return base + C::kQBytes + s * C::kStage + C::kKBytes; };
  float* sk_tiles = reinterpret_cast<float*>(base + C::kQBytes + kStages * C::kStage);
  const int nqt = (sq + kBQ - 1) / kBQ, nvc = (dv + DV - 1) / DV;
  const qg::FlatIdx blk = qg::flat_block(nqt * nvc);   // (query tile, V chunk; batch*head)
  const int bh = blk.o, c0 = (blk.i / nqt) * DV;     // the chunk's first channel
  const int qt = causal ? nqt - 1 - blk.i % nqt : blk.i % nqt;   // causal: longest first
  const int q0 = qt * kBQ;
  int nk = (sk + kBK - 1) / kBK;
  if (causal) nk = min(nk, (min(q0 + kBQ, sq) - 1) / kBK + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers / 32);
    }
    sm90::mbar_init(&qbar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {   // producer
    if (lane == 0) {
      sm90::mbar_expect_tx(&qbar, C::kQBytes);
#pragma unroll
      for (int h = 0; h < C::kHalves; ++h)
        sm90::tma_load_3d(qs + h * C::kQBox, &tq, &qbar, kRow * h, q0, bh);
      for (int i = 0; i < nk; ++i) {
        const int s = i % kStages;
        if (i >= kStages) sm90::mbar_wait(&empty[s], ((i / kStages) + 1) & 1);
        sm90::mbar_expect_tx(&full[s], C::kStage + C::kSkBytes);
#pragma unroll
        for (int h = 0; h < C::kHalves; ++h)
          sm90::tma_load_3d(k_tile(s) + h * C::kKBox, &tk, &full[s], kRow * h, i * kBK, bh);
        bulk_load(sk_tiles + s * kBK, sks + static_cast<size_t>(bh) * skp + i * kBK, C::kSkBytes,
                  &full[s]);
        if constexpr (P8) {
          sm90::tma_load_3d(v_tile(s), &tv, &full[s], i * kBK, c0, bh);
        } else {
#pragma unroll
          for (int bx = 0; bx < C::kVBoxes; ++bx)
            sm90::tma_load_3d(v_tile(s) + bx * C::kVBox, &tv, &full[s], c0 + 64 * bx, i * kBK, bh);
        }
      }
    }
    return;
  }

  // consumer warpgroup: rows r0 = q0 + 16 warp + g and r1 = r0 + 8
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;
  const float qs0 = r0 < sq ? __fmul_rn(sqs[static_cast<size_t>(bh) * sq + r0], scale) : 0.f;
  const float qs1 = r1 < sq ? __fmul_rn(sqs[static_cast<size_t>(bh) * sq + r1], scale) : 0.f;
  float m0 = kNegBig, m1 = kNegBig, l0 = 0.f, l1 = 0.f;
  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  sm90::mbar_wait(&qbar, 0);
  const uint64_t dq = sm90::desc_sw128(qs);

  for (int it = 0; it < nk; ++it) {
    const int s = it % kStages, k0 = it * kBK;
    const float* skt = sk_tiles + s * kBK;   // the tile's key scales (zero past sk)
    sm90::mbar_wait(&full[s], (it / kStages) & 1);

    // S = Q K^T: d[4j + q] is (row g + 8 (q >> 1), key 8j + 2t + (q & 1))
    int sacc[kBK / 2];
    sm90::wgmma_fence();
    fence_acc(sacc);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {   // box kk / 4 of the code rows, its k32 slice kk % 4
      const uint64_t dqh = kk < 4 ? dq : sm90::desc_sw128(qs + (kk / 4) * C::kQBox);
      const uint64_t dkh = sm90::desc_sw128(k_tile(s) + (kk / 4) * C::kKBox);
      sm90::wgmma_ss(sacc, sm90::desc_k32(dqh, kk % 4), sm90::desc_k32(dkh, kk % 4), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_acc(sacc);

    const bool edge = k0 + kBK > sk || (causal && k0 + kBK - 1 > q0);
    float sc[kBK / 2];
    float mx0 = kNegBig, mx1 = kNegBig;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const float2 skj = *reinterpret_cast<const float2*>(skt + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // |S| < 2^22 up to D 256 (256 * 127^2): the biased convert; past it an
        // exact one (|S| < 2^24 up to D 1024)
        const float sf = KS <= 8 ? exact_f32(sacc[4 * j + e]) : __int2float_rn(sacc[4 * j + e]);
        float v = __fmul_rn(__fmul_rn(sf, e < 2 ? qs0 : qs1), (e & 1) ? skj.y : skj.x);
        if (edge) {
          const int kj = k0 + 8 * j + 2 * t + (e & 1);
          if (kj >= sk || (causal && kj > (e < 2 ? r0 : r1))) v = kNegBig;
        }
        sc[4 * j + e] = v;
        if (e < 2) mx0 = max_nan(mx0, v); else mx1 = max_nan(mx1, v);
      }
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      mx0 = max_nan(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
      mx1 = max_nan(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
    }
    const float mn0 = max_nan(m0, mx0), mn1 = max_nan(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P: int8 codes (or bf16) packed straight into the A fragments
    constexpr int PS = P8 ? kBK / 32 : kBK / 16;   // k slices of P V
    uint32_t pa[PS][4];
    float ls0 = 0.f, ls1 = 0.f;
    int li0 = 0, li1 = 0;   // int8 P: the codes' sums, exact
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = sc[4 * j + e];
        p[e] = v == kNegBig ? 0.f : expf(v - (e < 2 ? mn0 : mn1));
      }
      if constexpr (P8) {
        int c8[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) c8[e] = rint_small(__fmul_rn(p[e], 127.f));
        li0 += c8[0] + c8[1];
        li1 += c8[2] + c8[3];
        // slice j / 4; j' = j % 4: j' 0, 1 fill registers 0 (row g) and 1
        // (row g + 8), j' 2, 3 registers 2 and 3; j' odd the high half-words
        const int kk = j / 4, jp = j % 4, sh = 16 * (jp & 1);
        const uint32_t lo = pack4(c8[0], c8[1], 0, 0) << sh, hi = pack4(c8[2], c8[3], 0, 0) << sh;
        if ((jp & 1) == 0) {
          pa[kk][2 * (jp >> 1)] = lo;
          pa[kk][2 * (jp >> 1) + 1] = hi;
        } else {
          pa[kk][2 * (jp >> 1)] |= lo;
          pa[kk][2 * (jp >> 1) + 1] |= hi;
        }
      } else {
        ls0 += p[0] + p[1];
        ls1 += p[2] + p[3];
        // k16 slice j / 2: j even registers 0, 1, j odd registers 2, 3
        pa[j / 2][2 * (j & 1)] = pack_bf16(p[0], p[1]);
        pa[j / 2][2 * (j & 1) + 1] = pack_bf16(p[2], p[3]);
      }
    }
    if constexpr (P8) {
      ls0 = exact_f32(li0);
      ls1 = exact_f32(li1);
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      ls0 += __shfl_xor_sync(0xffffffffu, ls0, o2);
      ls1 += __shfl_xor_sync(0xffffffffu, ls1, o2);
    }
    l0 = __fadd_rn(__fmul_rn(l0, al0), ls0);
    l1 = __fadd_rn(__fmul_rn(l1, al1), ls1);

    // P V: d[4j + q] is (row g + 8 (q >> 1), channel 8j + 2t + (q & 1))
    // in chunks of NC channels (N of the wgmma), so that only NC / 2
    // product registers live beside O's (bf16 DV 32: N 64, half of it kept)
    constexpr int NC = P8 && DV < 64 ? DV : 64;
#pragma unroll
    for (int h = 0; h < (DV + NC - 1) / NC; ++h) {
      PV pacc[NC / 2];
      sm90::wgmma_fence();
      fence_acc(pacc);
      if constexpr (P8) {
        const uint64_t dvd = sm90::desc_sw128(v_tile(s) + h * NC * kRow);
#pragma unroll
        for (int kk = 0; kk < PS; ++kk) wgmma_rs(pacc, pa[kk], sm90::desc_k32(dvd, kk), kk > 0);
      } else {
#pragma unroll
        for (int kk = 0; kk < PS; ++kk)   // keys 16 kk.. of the 64-channel box h
          wgmma_rs(pacc, pa[kk], desc_mn_sw128(v_tile(s) + h * C::kVBox + kk * 16 * kRow), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      fence_acc(pacc);
      if (h == (DV + NC - 1) / NC - 1) {
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[s]);   // this warp has read the stage
      }
#pragma unroll
      for (int i = 0; i < NC / 2; ++i) {
        if (h * (NC / 2) + i >= DV / 2) break;
        float& oi = o[h * (NC / 2) + i];
        oi = __fadd_rn(__fmul_rn(oi, (i & 2) ? al1 : al0), pv_f32(pacc[i]));
      }
    }
  }

  const float lm0 = max_nan(l0, kEps), lm1 = max_nan(l1, kEps);
  T* ob = out + static_cast<size_t>(bh) * sq * dv + c0;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) {
    const int row = (i & 2) ? r1 : r0, c = 8 * (i / 4) + 2 * t + (i & 1);
    if (row < sq && c < dv - c0) {
      float v = o[i] / ((i & 2) ? lm1 : lm0);
      if constexpr (P8) v = __fmul_rn(v, 1.f / 127.f);
      ob[static_cast<size_t>(row) * dv + c] = qg::from_f32<T>(v);
    }
  }
}

// a 3-D map over V bf16 [bh, sk, vw] (vw innermost), boxes [1, kBK keys, 64
// channels]: 128-byte key rows, zero past vw and sk
inline bool bf16_map(CUtensorMap* map, const void* base, uint64_t vw, uint64_t sk, uint64_t bh) {
  const sm90::EncodeTiled fn = sm90::encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0 || (vw * 2) % 16 != 0)
    return false;
  const cuuint64_t dims[3] = {vw, sk, bh};
  const cuuint64_t strides[2] = {vw * 2, vw * 2 * sk};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(kBK), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int DV, bool P8, int KS>
cudaError_t launch_main(const void* q8, const void* k8, const void* vt, const float* sqs,
                        const float* sks, void* out, int bh, int sq, int sk, int skp, int dv,
                        int vw, int causal, float scale, int smem, cudaStream_t s) {
  constexpr int CR = KS * 32 > kRow ? KS * 32 : kRow;
  using C = FlashCfg<DV, P8, CR>;
  if (smem != C::kSmem) return cudaErrorInvalidValue;
  cudaError_t e = sm90::allow_smem(
      reinterpret_cast<const void*>(int8_flash_wgmma_kernel<T, DV, P8, KS>), C::kSmem);
  if (e != cudaSuccess) return e;
  CUtensorMap tq, tk, tv;
  const bool ok =
      sm90::int8_map(&tq, q8, CR, sq, bh, CR, kRow, kBQ, CU_TENSOR_MAP_SWIZZLE_128B) &&
      sm90::int8_map(&tk, k8, CR, sk, bh, CR, kRow, kBK, CU_TENSOR_MAP_SWIZZLE_128B) &&
      (P8 ? sm90::int8_map(&tv, vt, skp, vw, bh, skp, kBK, DV, CU_TENSOR_MAP_SWIZZLE_128B)
          : bf16_map(&tv, vt, vw, sk, bh));
  if (!ok) return cudaErrorInvalidValue;
  const dim3 grid(((sq + kBQ - 1) / kBQ) * ((dv + DV - 1) / DV) * bh);
  int8_flash_wgmma_kernel<T, DV, P8, KS><<<grid, kThreads, C::kSmem, s>>>(
      tq, tk, tv, sqs, sks, static_cast<T*>(out), sq, sk, skp, dv, causal, scale);
  return cudaGetLastError();
}

// DV, the compiled chunk of V's channels: 32, 64 or 128 up to D 128; 128
// past it (fewer instantiations: V's rows past dv are zeros)
template <typename T, bool P8, int KS>
cudaError_t launch_dv(int DV, const void* q8, const void* k8, const void* vt, const float* sqs,
                      const float* sks, void* out, int bh, int sq, int sk, int skp, int dv,
                      int vw, int causal, float scale, int smem, cudaStream_t s) {
  if constexpr (KS <= 4) {
    if (DV == 32)
      return launch_main<T, 32, P8, KS>(q8, k8, vt, sqs, sks, out, bh, sq, sk, skp, dv, vw,
                                        causal, scale, smem, s);
    if (DV == 64)
      return launch_main<T, 64, P8, KS>(q8, k8, vt, sqs, sks, out, bh, sq, sk, skp, dv, vw,
                                        causal, scale, smem, s);
  }
  if (DV == 128)
    return launch_main<T, 128, P8, KS>(q8, k8, vt, sqs, sks, out, bh, sq, sk, skp, dv, vw,
                                       causal, scale, smem, s);
  return cudaErrorInvalidValue;
}

// D (32 to 1024) -> the products' k32 slices
template <typename T, bool P8>
cudaError_t launch_d(int D, int DV, const void* q8, const void* k8, const void* vt,
                     const float* sqs, const float* sks, void* out, int bh, int sq, int sk,
                     int skp, int dv, int vw, int causal, float scale, int smem, cudaStream_t s) {
#define QG_R12(KS) return launch_dv<T, P8, KS>(DV, q8, k8, vt, sqs, sks, out, bh, sq, sk, skp, dv, vw, causal, scale, smem, s)
  if (D == 32) QG_R12(1);
  if (D == 64) QG_R12(2);
  if (D == 128) QG_R12(4);
  if (D == 256) QG_R12(8);
  if (D == 512) QG_R12(16);
  if (D == 1024) QG_R12(32);
#undef QG_R12
  return cudaErrorInvalidValue;
}

// bytes of a Q or K code row at head width d: 128, or d padded to 256,
// 512 or 1024
inline int code_row_bytes(int d) { return d <= 128 ? 128 : d <= 256 ? 256 : d <= 512 ? 512 : 1024; }

// the most batch*heads one pre-pass launch takes: a grid's y stops at 65,535
constexpr int kMaxGridBH = 65535;

// Two launches per 65,535 batch*heads, the operands' pointers advanced to
// the chunk's first batch*head (every array is [BH, ...]): the column pass,
// then the row pass. d and dv up to 128 take the narrow kernels (code rows
// of 128 bytes, V in one tile of channels), past it the wide ones.
template <typename T>
cudaError_t launch_prepass(const T* q, const T* k, const T* v, int8_t* q8, int8_t* k8, void* vt,
                           float* sqs, float* sks, float* vc, float* ksum, float* vmax, int bh,
                           int sq, int sk, int d, int dv, int vw, int skp, int nchunk,
                           int qk_only, cudaStream_t s) {
  const int nq = (sq + kRowsPerBlock - 1) / kRowsPerBlock;
  const int nk = (sk + kRowsPerBlock - 1) / kRowsPerBlock;
  const int nv = vw > 0 ? skp / kBK : 0;
  const int cr = code_row_bytes(d);
  const bool wide = d > kRow || dv > kRow;
  for (int h0 = 0; h0 < bh; h0 += kMaxGridBH) {
    const int nb = min(kMaxGridBH, bh - h0);
    const size_t b0 = h0;
    const T* qc = q + b0 * sq * d;
    const T* kcp = k + b0 * sk * d;
    const T* vcp = v + b0 * sk * dv;
    int8_t* q8c = q8 + b0 * sq * cr;
    int8_t* k8c = k8 + b0 * sk * cr;
    void* vtc = vw == 0 ? vt
                : qk_only ? static_cast<void*>(static_cast<__nv_bfloat16*>(vt) + b0 * sk * vw)
                          : static_cast<void*>(static_cast<int8_t*>(vt) + b0 * vw * skp);
    float* sqc = sqs + b0 * sq;
    float* skc = sks + b0 * skp;
    float* vcc = qk_only ? vc : vc + b0 * dv;
    float* ksc = ksum + b0 * nchunk * d;
    float* vmc = qk_only ? vmax : vmax + b0 * nchunk * dv;
    if (!wide) {
      prepass_col_kernel<T><<<dim3(nchunk, nb), kColThreads, 0, s>>>(kcp, vcp, ksc, vmc, sk, d,
                                                                     dv, nchunk, qk_only);
      prepass_row_kernel<T><<<dim3(nq + nk + nv, nb), kRowThreads, 0, s>>>(
          qc, kcp, vcp, q8c, k8c, vtc, sqc, skc, vcc, ksc, vmc, sq, sk, d, dv, vw, skp, nchunk,
          nq, nk, qk_only);
    } else {
      prepass_col_wide_kernel<T><<<dim3(nchunk, nb), kColThreads, 0, s>>>(
          kcp, vcp, ksc, vmc, sk, d, dv, nchunk, qk_only);
      const dim3 grid(nq + nk + nv, nb);
#define QG_ROW(NV)                                                                       \
  prepass_row_wide_kernel<T, NV><<<grid, kRowThreads, 0, s>>>(qc, kcp, vcp, q8c, k8c, vtc, \
                                                              sqc, skc, vcc, ksc, vmc, sq, \
                                                              sk, d, dv, vw, skp, nchunk, nq, \
                                                              nk, qk_only)
      switch (cr / kRow) {
        case 1: QG_ROW(1); break;
        case 2: QG_ROW(2); break;
        case 4: QG_ROW(4); break;
        default: QG_ROW(8); break;
      }
#undef QG_ROW
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

inline int padded(int d) { return d <= 32 ? 32 : d <= 64 ? 64 : 128; }

// V's rows as the pre-pass writes them: DV (int8 codes transposed: 32, 64
// or 128 up to d and dv 128, else dv rounded up to 128); with qk_only, 0
// where the main kernel reads the caller's bf16 V (dv a multiple of 8),
// else the bf16 copy's width, dv rounded up to 8
inline int v_width(int in_dtype, int d, int dv, int qk_only) {
  if (!qk_only) return d <= 128 && dv <= 128 ? padded(dv) : (dv + 127) / 128 * 128;
  return in_dtype == 1 && dv % 8 == 0 ? 0 : (dv + 7) / 8 * 8;
}

}  // namespace

// The pre-pass: q [BH, Sq, d], k [BH, Sk, d], v [BH, Sk, dv] (in_dtype 0 =
// f32, 1 = bf16; d, dv 1 to 1024) -> q8 [BH, Sq, CR], k8 [BH, Sk, CR] int8
// code rows of CR = code_row_bytes(d) bytes (zero past d), sq [BH, Sq] and
// sk [BH, skp] f32 row scales with
// 1/127 folded in (sk zero past Sk); V^T [BH, vw, skp] int8 codes in the
// permuted key order and vc [BH, dv] f32 (or, qk_only, V [BH, Sk, vw] in
// bf16, zero past dv, where vw > 0, and no vc); ksum [BH, nchunk, d] and
// vmax [BH, nchunk, dv] f32 scratch. vw (v_width), skp and nchunk are the
// plan's (int8_flash_plan.py); refused otherwise. Two launches per 65,535
// batch*heads.
extern "C" int qgemm_int8_flash_prepass(const void* q, const void* k, const void* v,
                                        int in_dtype, void* q8, void* k8, void* vt, void* sqs,
                                        void* sks, void* vc, void* ksum, void* vmax, int bh,
                                        int sq, int sk, int d, int dv, int vw, int skp,
                                        int nchunk, int qk_only, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || sq <= 0 || sk <= 0 || d < 1 || d > kMaxRow || dv < 1 || dv > kMaxRow ||
      (in_dtype != 0 && in_dtype != 1) || vw != v_width(in_dtype, d, dv, qk_only) ||
      skp != (sk + kBK - 1) / kBK * kBK ||
      nchunk != (sk + kChunkRows - 1) / kChunkRows ||
      (sq + kRowsPerBlock - 1) / kRowsPerBlock + (sk + kRowsPerBlock - 1) / kRowsPerBlock +
              skp / kBK > qg::kMaxGridX)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* q8p = static_cast<int8_t*>(q8);
  auto* k8p = static_cast<int8_t*>(k8);
  auto* sqp = static_cast<float*>(sqs);
  auto* skp_ = static_cast<float*>(sks);
  auto* vcp = static_cast<float*>(vc);
  auto* ks = static_cast<float*>(ksum);
  auto* vm = static_cast<float*>(vmax);
  cudaError_t e = cudaErrorInvalidValue;
  if (in_dtype == 0)
    e = launch_prepass(static_cast<const float*>(q), static_cast<const float*>(k),
                       static_cast<const float*>(v), q8p, k8p, vt, sqp, skp_, vcp, ks, vm, bh,
                       sq, sk, d, dv, vw, skp, nchunk, qk_only, s);
  else if (in_dtype == 1)
    e = launch_prepass(static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                       static_cast<const __nv_bfloat16*>(v), q8p, k8p, vt, sqp, skp_, vcp, ks, vm,
                       bh, sq, sk, d, dv, vw, skp, nchunk, qk_only, s);
  return static_cast<int>(e);
}

// The main kernel on the pre-pass's layout: q8 [BH, Sq, CR], k8 [BH, Sk,
// CR] (CR = max(128, D) bytes), v: V^T [BH, vw, skp] int8 with p_int8 = 1
// (vw = DV, or a multiple of DV = 128), or V [BH, Sk, vw] bf16 with p_int8 =
// 0 (qk_only; vw a multiple of 8, dv <= vw, 16-byte aligned), sq [BH, Sq],
// sk [BH, skp]; D (32 to 1024, a power of two) the padded head width (S
// runs the code rows' D / 32 k32 slices), DV (32, 64 or 128; 128 past D
// 128) the compiled chunk of V's channels, a block per chunk; out [BH, Sq,
// dv], out_dtype 0 = f32, 1 = bf16; smem the plan's (refused otherwise).
// Returns cudaGetLastError().
extern "C" int qgemm_int8_flash_attention(const void* q8, const void* k8, const void* vt,
                                          const void* sq_scale, const void* sk_scale,
                                          void* out, int out_dtype, int p_int8, int bh,
                                          int sq, int sk, int skp, int D, int DV, int dv,
                                          int vw, int causal, float scale, int smem,
                                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || sq <= 0 || sk <= 0 || dv < 1 || (DV != 32 && DV != 64 && DV != 128) ||
      (dv > DV && DV != 128) ||
      !qg::flat_grid_ok(static_cast<long long>((sq + kBQ - 1) / kBQ) * ((dv + DV - 1) / DV) * bh) ||
      (D != 32 && D != 64 && D != 128 && D != 256 && D != 512 && D != 1024) ||
      (D > 128 && DV != 128) || skp != (sk + kBK - 1) / kBK * kBK ||
      (p_int8 ? vw % DV != 0 || vw < dv || (vw != DV && DV != 128) : vw % 8 != 0 || vw < dv))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sqs = static_cast<const float*>(sq_scale);
  const float* sks = static_cast<const float*>(sk_scale);
  cudaError_t e = cudaErrorInvalidValue;
  if (out_dtype == 0 && p_int8)
    e = launch_d<float, true>(D, DV, q8, k8, vt, sqs, sks, out, bh, sq, sk, skp, dv, vw, causal, scale, smem, s);
  else if (out_dtype == 0)
    e = launch_d<float, false>(D, DV, q8, k8, vt, sqs, sks, out, bh, sq, sk, skp, dv, vw, causal, scale, smem, s);
  else if (out_dtype == 1 && p_int8)
    e = launch_d<__nv_bfloat16, true>(D, DV, q8, k8, vt, sqs, sks, out, bh, sq, sk, skp, dv, vw, causal, scale, smem, s);
  else if (out_dtype == 1)
    e = launch_d<__nv_bfloat16, false>(D, DV, q8, k8, vt, sqs, sks, out, bh, sq, sk, skp, dv, vw, causal, scale, smem, s);
  return static_cast<int>(e);
}
