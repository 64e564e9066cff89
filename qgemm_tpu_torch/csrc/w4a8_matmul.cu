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
// card's 1979 TOP/s : 3.35 TB/s balance; at prefill the int8 tensor-core rate,
// and with it the f32 fold of every group's sums: per output element and
// group it issues as many instructions (convert, multiply, add) as the
// tensor cores take clocks for the group's 128 products, so the fold, not
// the products, sets the prefill time. Half the bytes make the latency of a
// decode call's two launches (pre-pass, GEMV) and of the GEMV's one ordered
// fold per block a larger share: measured on an H100 80GB HBM3 at 700 W at m
// 8 (PERF.md), ~0.2 of the byte bound at k = n = 4096, ~0.5 at the FFN
// shapes, ~0.6 at the lm_head, and faster than K1 at every decode shape; at
// m 512 the tile kernel alone runs at ~530 TOP/s and a call reaches ~0.21-
// 0.28 of the operations bound, 1.3-1.8x K1's time (without the fold the
// same kernel ran 1.5x faster).
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
//   * m > 16, the tile kernel (w4a8_wgmma_kernel<WGS, XR>, below): wgmma with
//     W as the A operand from registers, unpacked straight from the packed
//     tile that TMA brought into shared memory, X's codes as B, one group a
//     ring stage; its note gives the fold's order and the exact scaling by
//     16 that lets a nibble be unpacked with one mask. The plan comes from
//     ops/cuda/tile_plan.py;
//   * ragged m, n and k are masked in the GEMV and zero-filled by TMA in the
//     tile kernel; W is never padded per call.
#include "mma.cuh"
#include "row_quantize.cuh"
#include "wgmma.cuh"

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
// The tile kernel computes out^T = W X^T group by group: W is wgmma's A
// operand from registers, X's codes its B operand from shared memory, so a
// group's column scale is one value per accumulator row and a slab's
// activation scale one per accumulator column. A block holds XR x rows (64
// or 128: the wgmma N) and 64 WGS output columns: WGS consumer warpgroups
// (warps 0 .. 4 WGS - 1, each 64 columns of W as the m64 side of wgmma
// m64nXRk32) and one producer warp (the last). A ring stage is one group:
// the X codes' tile [XR rows x 128 codes] in the 128-byte swizzle and the
// packed weights' tile [64 WGS columns x 64 bytes] in the 64-byte swizzle,
// both by TMA (zeros outside the tensors). A thread reads its A fragments'
// packed words straight from the stage: byte j of a column's group holds k
// j (low nibble) and 64 + j (high nibble), so the four words at bytes 16c +
// 4t (c = 0..3) are the fragments of all four k32 slices. A nibble goes to
// the high half of its byte ((w << 4) & 0xF0F0F0F0 for k < 64, w &
// 0xF0F0F0F0 above): the code times 16, exact in int8, and so is the int32
// sum, 16 isum with |16 isum| < 2^21, exact in f32. The fold then takes the plain version's f32 steps
// on values 16 times larger, which scales every rounded result by exactly
// 16 (no f32 step comes near the subnormal range: |cw| >= 5e-13), and the
// slab scale is taken as ds / 16 (exact), so the bits are the plain
// version's. A group's int32 sums can be read only after wgmma.wait_group.
// At 64 x rows two accumulator sets take turns, so the tensor cores compute
// group g + 1 while a warpgroup folds group g. At 128 x rows (half the
// shared-memory reads of X per product: at 64 the products of two
// warpgroups read ~128 bytes a clock, all the SM has) one set fits, and the
// other warpgroup's products fill the tensor cores while one folds. A
// consumer thread keeps its accumulators, slab sums and A fragments in
// registers; its f32 totals (read and written once a slab) and its rows'
// slab scales (brought by cp.async a slab ahead) wait in shared memory, so
// that two consumer warpgroups fit the 168 registers a thread of such a
// block may have.
template <int WGS, int XR> struct W4TileCfg {
  static constexpr int kRows = XR;               // x rows: the wgmma N
  static constexpr int kCols = 64 * WGS;         // output columns: W rows
  static constexpr int kSets = XR == 64 ? 2 : 1; // accumulator sets a thread holds
  static constexpr int kAcc = XR / 2;            // int32 accumulators a set
  static constexpr int kConsumerThreads = 128 * WGS;
  static constexpr int kThreads = kConsumerThreads + 32;
  static constexpr int kXBytes = kRows * kGroup;
  static constexpr int kStage = kXBytes + kCols * (kGroup / 2);
  static constexpr int kFold = kConsumerThreads * (kAcc + XR / 4) * 4;   // totals, slab scales
  static constexpr int kStages = qg::sm90::ring_stages(kStage, kFold);
  static constexpr int kSmem = qg::sm90::kAlign + kStages * kStage + kFold;
};

// grid (ceil(m / XR), ceil(n / (64 WGS))): the row blocks of one column
// block run together and read its weights from device memory once.
// W4TileCfg<WGS, XR>::kSmem bytes of dynamic shared memory; launched with
// programmatic dependent launch.
template <int WGS, int XR>
__global__ void __launch_bounds__(W4TileCfg<WGS, XR>::kThreads, 1)
w4a8_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                  const float* __restrict__ ds, const float* __restrict__ cw,
                  float* __restrict__ out, int m, int n, int kp, int bk, int ns) {
  namespace h = qg::sm90;
  using C = W4TileCfg<WGS, XR>;
  constexpr int S = C::kStages, A = C::kAcc;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[S], empty[S];
  uint8_t* tiles = h::aligned_smem(smem_raw);   // stage s: X tile, then W tile
  const int ng = kp / kGroup, gps = bk / kGroup;
  const int row0 = blockIdx.x * C::kRows, col0 = blockIdx.y * C::kCols;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      h::mbar_init(&full[s], 1);
      h::mbar_init(&empty[s], 4 * WGS);
    }
    h::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * WGS) {   // producer
    if (lane == 0) {
      const int pre = min(ng, S);
      for (int i = 0; i < pre; ++i) {   // weights first: they do not wait for the pre-pass
        h::mbar_expect_tx(&full[i], C::kStage);
        h::tma_load_3d(tiles + i * C::kStage + C::kXBytes, &tw, &full[i], i * (kGroup / 2), col0, 0);
      }
      qg::grid_dependency_wait();
      for (int i = 0; i < pre; ++i)
        h::tma_load_3d(tiles + i * C::kStage, &tx, &full[i], i * kGroup, row0, 0);
      for (int i = pre; i < ng; ++i) {
        const int s = i % S;
        h::mbar_wait(&empty[s], ((i / S) + 1) & 1);   // its previous group was read
        h::mbar_expect_tx(&full[s], C::kStage);
        h::tma_load_3d(tiles + s * C::kStage + C::kXBytes, &tw, &full[s], i * (kGroup / 2), col0, 0);
        h::tma_load_3d(tiles + s * C::kStage, &tx, &full[s], i * kGroup, row0, 0);
      }
    }
    return;
  }

  // consumer: W rows (output columns) wl and wl + 8 of the block's tile
  const int g8 = lane >> 2, t = lane & 3;
  const int wl = 64 * (warp >> 2) + 16 * (warp & 3) + g8;
  const int col = col0 + wl;
  // the thread's totals fold[i][tid] (i < A) and its x rows' slab scales
  // fold[A + i][tid] (i < XR / 4, row 8 (i >> 1) + 2t + (i & 1))
  float* fold_s = reinterpret_cast<float*>(tiles + S * C::kStage) + threadIdx.x;
  constexpr int CT = C::kConsumerThreads;
#pragma unroll
  for (int i = 0; i < A; ++i) fold_s[i * CT] = 0.f;
  qg::grid_dependency_wait();   // ds is the pre-pass's

  auto load_ds = [&](int slab) {
#pragma unroll
    for (int i = 0; i < XR / 4; ++i) {
      const int r = row0 + 8 * (i >> 1) + 2 * t + (i & 1);
      qg::cp_async4(qg::smem_addr(fold_s + (A + i) * CT),
                    ds + static_cast<size_t>(min(r, m - 1)) * ns + slab, r < m ? 4 : 0);
    }
    qg::cp_async_commit();
  };
  auto issue = [&](int gi, int (&acc)[A], uint32_t (&a)[4][4], float (&cwv)[2]) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)   // read ahead of the fold that needs them
      cwv[hh] = col + 8 * hh < n ? __ldg(cw + static_cast<size_t>(gi) * n + col + 8 * hh) : 0.f;
    const int s = gi % S;
    h::mbar_wait(&full[s], (gi / S) & 1);
    const uint8_t* stage = tiles + s * C::kStage;
    const uint8_t* wtile = stage + C::kXBytes;
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = wl + 8 * hh;
        const uint32_t w = *reinterpret_cast<const uint32_t*>(
            wtile + r * (kGroup / 2) + ((c ^ ((r >> 1) & 3)) << 4) + 4 * t);
        a[c >> 1][2 * (c & 1) + hh] = (w << 4) & 0xF0F0F0F0u;
        a[2 + (c >> 1)][2 * (c & 1) + hh] = w & 0xF0F0F0F0u;
      }
    const uint64_t db = h::desc_sw128(stage);
    h::wgmma_fence();
    h::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) h::wgmma_rs(acc, a[kk], h::desc_k32(db, kk), kk > 0);
    h::wgmma_commit();
    h::fence_regs(acc);
  };
  auto release = [&](int gi) {
    __syncwarp();
    if (lane == 0) h::mbar_arrive(&empty[gi % S]);
  };
  float sacc[A];
#pragma unroll
  for (int i = 0; i < A; ++i) sacc[i] = 0.f;
  // acc[4j + q]: W row wl + 8 (q >> 1), x row 8j + 2t + (q & 1)
  auto fold = [&](int gi, int (&acc)[A], const float (&cwv)[2]) {
    h::fence_regs(acc);
#pragma unroll
    for (int i = 0; i < A; ++i)
      sacc[i] = __fadd_rn(sacc[i], __fmul_rn(__int2float_rn(acc[i]), cwv[(i >> 1) & 1]));
    if ((gi + 1) % gps == 0 || gi + 1 == ng) {   // the slab ends
      qg::cp_async_wait<0>();
#pragma unroll
      for (int i = 0; i < A; ++i) {
        const float d = fold_s[(A + 2 * (i >> 2) + (i & 1)) * CT] * 0.0625f;
        fold_s[i * CT] = __fadd_rn(fold_s[i * CT], __fmul_rn(sacc[i], d));
        sacc[i] = 0.f;
      }
      if (gi + 1 < ng) load_ds((gi + 1) / gps);
    }
  };

  int acc0[A];
  uint32_t a0[4][4];
  float cw0[2];
#pragma unroll
  for (int i = 0; i < A; ++i) acc0[i] = 0;
  load_ds(0);
  if constexpr (C::kSets == 1) {
    for (int gi = 0; gi < ng; ++gi) {
      issue(gi, acc0, a0, cw0);
      h::wgmma_wait<0>();
      release(gi);
      fold(gi, acc0, cw0);
    }
  } else {
    int acc1[A];
    uint32_t a1[4][4];
    float cw1[2];
#pragma unroll
    for (int i = 0; i < A; ++i) acc1[i] = 0;
    issue(0, acc0, a0, cw0);
    for (int gi = 1;; gi += 2) {   // group gi - 1 is in flight in acc0
      if (gi >= ng) {
        h::wgmma_wait<0>();
        release(gi - 1);
        fold(gi - 1, acc0, cw0);
        break;
      }
      issue(gi, acc1, a1, cw1);
      h::wgmma_wait<1>();
      release(gi - 1);
      fold(gi - 1, acc0, cw0);
      if (gi + 1 >= ng) {
        h::wgmma_wait<0>();
        release(gi);
        fold(gi, acc1, cw1);
        break;
      }
      issue(gi + 1, acc0, a0, cw0);
      h::wgmma_wait<1>();
      release(gi);
      fold(gi, acc1, cw1);
    }
  }

#pragma unroll
  for (int i = 0; i < A; ++i) {
    const int r = row0 + 8 * (i >> 2) + 2 * t + (i & 1), c = col + 8 * ((i >> 1) & 1);
    if (r < m && c < n) out[static_cast<size_t>(r) * n + c] = fold_s[i * CT];
  }
}

// The tile kernel's plan (ops/cuda/tile_plan.py): x rows and output columns
// of a block, and its dynamic shared memory.
struct TilePlan {
  int bm, bn, smem;
};

template <int WGS, int XR>
cudaError_t launch_tile(const int8_t* xq, const float* ds, const int8_t* wp, const float* cw,
                        float* out, int m, int n, int kp, int bk, int ns, cudaStream_t s) {
  using C = W4TileCfg<WGS, XR>;
  cudaError_t e =
      qg::sm90::allow_smem(reinterpret_cast<const void*>(w4a8_wgmma_kernel<WGS, XR>), C::kSmem);
  if (e != cudaSuccess) return e;
  CUtensorMap tx, tw;
  if (!qg::sm90::int8_map(&tx, xq, kp, m, 1, kp, kGroup, C::kRows, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !qg::sm90::int8_map(&tw, wp, kp / 2, n, 1, kp / 2, kGroup / 2, C::kCols,
                          CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  const dim3 grid((m + C::kRows - 1) / C::kRows, (n + C::kCols - 1) / C::kCols);
  return qg::launch_pdl(w4a8_wgmma_kernel<WGS, XR>, grid, dim3(C::kThreads), C::kSmem, s, tx, tw,
                        ds, cw, out, m, n, kp, bk, ns);
}

// the compiled tiles (x rows, output columns), as ops/cuda/tile_plan.py lists them
cudaError_t launch_tile(const TilePlan& p, const int8_t* xq, const float* ds, const int8_t* wp,
                        const float* cw, float* out, int m, int n, int kp, int bk, int ns,
                        cudaStream_t s) {
#define QG_TILE(WGS, XR)                                                                 \
  if (p.bm == W4TileCfg<WGS, XR>::kRows && p.bn == W4TileCfg<WGS, XR>::kCols)            \
    return p.smem == W4TileCfg<WGS, XR>::kSmem                                           \
               ? launch_tile<WGS, XR>(xq, ds, wp, cw, out, m, n, kp, bk, ns, s)           \
               : cudaErrorInvalidValue;
  QG_TILE(1, 64)
  QG_TILE(2, 64)
  QG_TILE(1, 128)
  QG_TILE(2, 128)
#undef QG_TILE
  return cudaErrorInvalidValue;
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
  if (p.smem > 48 * 1024) {   // allow this kernel the block's limit
    const cudaError_t e = qg::sm90::allow_smem(
        reinterpret_cast<const void*>(w4a8_gemv_kernel<NR, CT>), kSmemLimit);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((n + 16 * CT - 1) / (16 * CT));
  return qg::launch_pdl(w4a8_gemv_kernel<NR, CT>, grid, dim3(32 * p.warps), p.smem, s, xq, ds,
                        wp, cw, out, m, n, kp, bk, ns, p.gs);
}

template <typename T>
cudaError_t launch(const T* x, const int8_t* wp, const float* cw, int8_t* xq, float* ds,
                   float* out, int m, int n, int k, int kp, int bk, const GemvPlan& p,
                   const TilePlan& tp, cudaStream_t s) {
  if (m <= 16 && !plan_ok(p, m, kp)) return cudaErrorInvalidValue;
  const int ns = (kp + bk - 1) / bk;
  const int vec = k % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  qg::row_quantize_kernel<T><<<m * ns, qg::quant_threads(bk), 0, s>>>(
      x, xq, ds, k, kp, bk, ns, vec, 0, qg::kQRange * kW4Range);
  cudaError_t e = cudaSuccess;
  if (m > 16) {
    e = launch_tile(tp, xq, ds, wp, cw, out, m, n, kp, bk, ns, s);
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
// ops/cuda/gemv_plan.py), for more rows the tile kernel's (tile_bm x rows,
// tile_bn columns, tile_smem: ops/cuda/tile_plan.py), each refused unless it
// matches a compiled instantiation. Returns cudaGetLastError().
extern "C" int qgemm_w4a8_matmul(const void* x, int x_dtype, const void* wp, const void* cw,
                                 void* xq, void* ds, void* out, int m, int n, int k, int kp,
                                 int bk, int warps, int gs, int ct, int smem, int tile_bm,
                                 int tile_bn, int tile_smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0 || kp % kGroup != 0 || kp < k || kp - k >= kGroup ||
      bk <= 0 || bk % kGroup != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const GemvPlan p{warps, gs, ct, smem};
  const TilePlan tp{tile_bm, tile_bn, tile_smem};
  cudaError_t e;
  if (x_dtype == 0)
    e = launch(static_cast<const float*>(x), static_cast<const int8_t*>(wp),
               static_cast<const float*>(cw), static_cast<int8_t*>(xq), static_cast<float*>(ds),
               static_cast<float*>(out), m, n, k, kp, bk, p, tp, s);
  else if (x_dtype == 1)
    e = launch(static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wp),
               static_cast<const float*>(cw), static_cast<int8_t*>(xq), static_cast<float*>(ds),
               static_cast<float*>(out), m, n, k, kp, bk, p, tp, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
