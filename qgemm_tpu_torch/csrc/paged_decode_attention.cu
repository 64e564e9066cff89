// Kernel K5: one decode step (Sq = 1) of attention over the PAGED KV cache,
// int8 or int4 pools with per-position scales, for Hopper (sm_90a).
//
// Replaces _paged_kernel / paged_decode_attention and _ragged_kernel /
// paged_decode_attention_ragged of qgemm_tpu/ops/pallas/paged_attention.py.
// Same math: for query head h of slot b (pool head h / G),
//   s_j = (bf16(q) . K_j) * (1/sqrt(d)) * (kc_j / 127),   j < len_b,
// with position j in physical page page_table[b][j / page], row j % page;
// online softmax in f32; p_j * (vc_j / 127) rounded to bf16 before the V
// product; out = acc / max(l, 1e-30), written once in q's dtype. int8 (and
// int4) codes are exact in bf16, so the products are exact and only their
// f32 sums round, here in another order than K2's: K5 no longer equals K2
// bit for bit on the same rows. A slot of length 0 writes zeros.
//
// What bounds it on the H100: the pool read. Each step streams K and V of
// every resident position of every slot once (2 * d bytes per position and
// KV head for int8, d for int4, and two f32 scales) against ~4 * d flops
// per position and query head: far under the card's flop:byte balance. So
// the design is about bytes in flight: at 8 slots of ~300 positions, one
// block per (slot, KV head) walking its pages in turn kept ~2 KB in flight
// per SM, a tenth of what HBM's latency needs.
//
// Design (flash-decoding): one block of 4 warps per (slot * KV head, split),
// a split being one page, or max(1, 128 / page) pages where pages are small,
// so that every block holds ~128 positions; the grid's split count follows
// the page table's width, which the host knows, while the lengths stay on
// the device and a block past its slot's length exits at once. A block
// copies its pages' contiguous K and V code rows and both scale rows into
// shared memory with 16-byte cp.async (32 KB at page 128 and d 128 int8;
// several blocks resident per SM), then:
//   - scores: lanes take 16-byte column slices of a code row (d / 16 lanes
//     per row), hold their slices of the G <= 8 query rows in registers,
//     and sum over the row's lanes with shuffles; an int4 byte row is read
//     once for both of its positions (w: low nibbles, w + page/2: high);
//   - the split's softmax in f32 (a warp per query row): its max m, its sum
//     l of exp(s - m), and p * vc/127 rounded to bf16;
//   - P V: each thread takes 4 columns of a set of rows, then the row sets
//     are summed in a fixed order: the split's partial state (m, l, O[G, D]).
// A slot of one split writes its output at once. Otherwise each block
// writes its partial state to a scratch tensor and, after a __threadfence,
// counts itself done on the (slot, KV head)'s counter; the last block to
// finish merges the states IN SPLIT ORDER (deterministic, whatever order
// the blocks finished in), writes out = O / max(L, 1e-30), and resets the
// counter to 0 for the next call: one launch per call. Codes become f32 by a
// byte permute into an f32's mantissa (exact; no int-to-float convert). The
// step tables of the ragged entry (the TPU grid's schedule) are not read.
//
// Head widths: compiled for D in {32, 64, 128}; the pools' rows hold the
// true width d <= D (16-byte cp.async when d is a multiple of 16, byte loads
// otherwise; columns past d staged as zeros). The wrapper pads the per-call
// q to D and slices the output; the pools are never copied. The launch plan
// (split, grid, shared memory) comes from qgemm_tpu_torch/ops/cuda/
// paged_plan.py; the entry refuses any other.
#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4, kThreads = 128;
constexpr int kSplitPositions = 128;   // a split holds max(1, 128 / page) pages

__host__ __device__ constexpr int split_pages(int page) {
  return page < kSplitPositions ? kSplitPositions / page : 1;
}
__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// the dynamic shared memory of one block, region by region (see the kernel)
__host__ __device__ constexpr int smem_bytes(int bits, int D, int G, int page) {
  return 2 * split_pages(page) * (bits == 8 ? page : page / 2) * D   // K, V code rows
         + 2 * split_pages(page) * page * 4                          // kc, vc
         + G * split_pages(page) * page * 4                          // scores, then p
         + round16(2 * G * 4)                                        // m, l
         + (512 / D) * G * D * 4                                     // P V partial sums
         + 16;                                                       // the last-block flag
}

template <int BITS, int D, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const void* __restrict__ q, const int8_t* __restrict__ kq,
                          const float* __restrict__ kc, const int8_t* __restrict__ vq,
                          const float* __restrict__ vc, const int* __restrict__ page_table,
                          const int* __restrict__ lengths, void* __restrict__ out,
                          float* __restrict__ scratch, int* __restrict__ counters, int q_bf16,
                          int hkv, int page, int pps, int dt, int nsplit, float scale) {
  constexpr int LPR = D / 16;           // lanes per code row in the score pass
  constexpr int RPW = 32 / LPR;         // code rows a warp takes at once
  constexpr int TPR = D / 4;            // threads per code row in the P V pass
  constexpr int NRG = kThreads / TPR;   // row sets of the P V pass
  constexpr int CH = D / 16;            // 16-byte chunks of a code row
  const int bh = blockIdx.x, b = bh / hkv, h = bh % hkv, split = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(lengths[b], pps * page);   // never past the table
  const size_t orow = static_cast<size_t>(bh) * G * D;   // this (slot, KV head)'s outputs
  const auto store = [&](int i, float v) {
    if (q_bf16) static_cast<bf16*>(out)[orow + i] = __float2bfloat16_rn(v);
    else static_cast<float*>(out)[orow + i] = v;
  };
  if (len == 0) {
    if (split == 0)
      for (int i = tid; i < G * D; i += kThreads) store(i, 0.f);
    return;
  }
  const int sp = split_pages(page), np = sp * page;   // pages, positions per split
  const int p0 = split * np;
  if (p0 >= len) return;
  const int n_live = min(np, len - p0);              // the split's positions
  const int nsplit_live = (len + np - 1) / np;
  const int rows = BITS == 8 ? page : page / 2;      // byte rows per page

  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* Kc = reinterpret_cast<int8_t*>(smem_raw);                // [sp * rows][D]
  int8_t* Vc = Kc + sp * rows * D;                                 // [sp * rows][D]
  float* ksc = reinterpret_cast<float*>(Vc + sp * rows * D);       // [np]
  float* vsc = ksc + np;                                           // [np]
  float* S = vsc + np;                                             // [G][np]
  float* mrow = S + G * np;                                        // [G]
  float* lrow = mrow + G;                                          // [G]
  float* part = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(mrow) +
                                         round16(2 * G * 4));      // [NRG][G][D]
  int* flag = reinterpret_cast<int*>(part + NRG * G * D);

  // the split's code rows and scales -> shared memory
  const int* pt = page_table + static_cast<size_t>(b) * pps + split * sp;
  const bool fast = dt % 16 == 0;
  for (int j = 0; j < sp; ++j) {
    const int pj = j * page;
    if (pj >= n_live) break;
    const int n_pos = min(page, n_live - pj);
    const int n_rows = BITS == 8 ? n_pos : min(n_pos, rows);
    const size_t ph = static_cast<size_t>(pt[j]) * hkv + h;
    const size_t src0 = ph * rows * dt;
    for (int i = tid; i < 2 * n_rows * CH; i += kThreads) {
      const int which = i >= n_rows * CH, rem = which ? i - n_rows * CH : i;
      const int r = rem / CH, c = (rem % CH) * 16;
      const int8_t* src = (which ? vq : kq) + src0 + static_cast<size_t>(r) * dt + c;
      int8_t* dst = (which ? Vc : Kc) + (j * rows + r) * D + c;
      if (fast) {
        qg::cp_async16(qg::smem_addr(dst), c < dt ? src : kq, c < dt ? 16 : 0);
      } else {
        uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (c + e < dt) wd[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(src[e])) << (8 * (e % 4));
        *reinterpret_cast<uint4*>(dst) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
      }
    }
    // 4 positions a copy; the last one's positions past n_pos are never used
    const int nch = (n_pos + 3) / 4;
    for (int i = tid; i < 2 * nch; i += kThreads) {
      const int which = i >= nch, c = (which ? i - nch : i) * 4;
      qg::cp_async16(qg::smem_addr((which ? vsc : ksc) + pj + c),
                     (which ? vc : kc) + ph * page + c, 16);
    }
  }
  qg::cp_async_commit();

  // meanwhile this lane's 16-column slice of the G query rows, as bf16
  const int lsub = lane % LPR, rsub = lane / LPR;
  float qr[G][16];
  const size_t qrow = static_cast<size_t>(bh) * G * D + lsub * 16;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (q_bf16) {
      qg::load8(static_cast<const bf16*>(q) + qrow + g * D, qr[g]);
      qg::load8(static_cast<const bf16*>(q) + qrow + g * D + 8, qr[g] + 8);
    } else {
      qg::load8(static_cast<const float*>(q) + qrow + g * D, qr[g]);
      qg::load8(static_cast<const float*>(q) + qrow + g * D + 8, qr[g] + 8);
#pragma unroll
      for (int e = 0; e < 16; ++e) qr[g][e] = qg::bf16_round(qr[g][e]);
    }
  }
  qg::cp_async_wait<0>();
  __syncthreads();

  // the split's byte rows: every row below n_rows_all holds a live position
  // (int4: its low nibble's; its high nibble's is live if below n_live)
  const int last = (n_live - 1) / page;
  const int n_rows_all = BITS == 8 ? n_live : last * rows + min(rows, n_live - last * page);
  const auto pos_of = [&](int i) { return BITS == 8 || sp == 1 ? i : (i / rows) * page + i % rows; };

  // scores: s = (q . K) * scale * kc/127, lanes on 16-byte slices of a row
  for (int i0 = warp * RPW; i0 < n_rows_all; i0 += kWarps * RPW) {
    const int i = i0 + rsub;
    const bool ok = i < n_rows_all;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (ok) u = *reinterpret_cast<const uint4*>(Kc + i * D + lsub * 16);
    const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int half = 0; half < (BITS == 8 ? 1 : 2); ++half) {
      float kv[16];
#pragma unroll
      for (int k = 0; k < 4; ++k) qg::kv_codes4<BITS>(wd[k], half == 1, kv + 4 * k);
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < 16; ++e) a = fmaf(qr[g][e], kv[e], a);
#pragma unroll
        for (int o = LPR / 2; o; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        s[g] = a;
      }
      const int pos = ok ? pos_of(i) + half * rows : n_live;
      if (lsub == 0 && pos < n_live) {
        const float ks = ksc[pos] * (1.f / 127.f);
#pragma unroll
        for (int g = 0; g < G; ++g) S[g * np + pos] = (s[g] * scale) * ks;
      }
    }
  }
  __syncthreads();

  // the split's softmax, a warp per query row: m, l, and p * vc/127 in bf16
  for (int g = warp; g < G; g += kWarps) {
    float* sg = S + g * np;
    float mx = -1e30f;
    for (int j = lane; j < n_live; j += 32) mx = fmaxf(mx, sg[j]);
    mx = qg::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n_live; j += 32) {
      const float p = expf(sg[j] - mx);
      sum += p;
      sg[j] = qg::bf16_round(p * (vsc[j] * (1.f / 127.f)));
    }
    sum = qg::warp_sum(sum);
    if (lane == 0) {
      mrow[g] = mx;
      lrow[g] = sum;
    }
  }
  __syncthreads();

  // P V: thread (row set rs, 4 columns c4) over rows rs, rs + NRG, ...
  const int c4 = (tid % TPR) * 4, rs = tid / TPR;
  float acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
  for (int i = rs; i < n_rows_all; i += NRG) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(Vc + i * D + c4);
    const int pos = pos_of(i);
#pragma unroll
    for (int half = 0; half < (BITS == 8 ? 1 : 2); ++half) {
      const int pp = pos + half * rows;
      if (pp >= n_live) break;
      float v[4];
      qg::kv_codes4<BITS>(w, half == 1, v);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = S[g * np + pp];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(p, v[e], acc[g][e]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
    *reinterpret_cast<float4*>(part + (rs * G + g) * D + c4) =
        make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  __syncthreads();

  float* state = scratch + (static_cast<size_t>(bh) * nsplit + split) * G * (D + 2);
  for (int i = tid; i < G * D; i += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int r = 0; r < NRG; ++r) o += part[r * G * D + i];
    if (nsplit_live == 1) store(i, o / fmaxf(lrow[i / D], 1e-30f));
    else state[i] = o;
  }
  if (nsplit_live == 1) return;
  if (tid < G) {
    state[G * D + tid] = mrow[tid];
    state[G * D + G + tid] = lrow[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(counters + bh, 1) == nsplit_live - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();

  // the last block: merge the live splits' states in split order
  const float* st0 = scratch + static_cast<size_t>(bh) * nsplit * G * (D + 2);
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    float mx = -1e30f;
    for (int s = 0; s < nsplit_live; ++s) mx = fmaxf(mx, __ldcg(st0 + s * G * (D + 2) + G * D + g));
    float l = 0.f, o = 0.f;
    for (int s = 0; s < nsplit_live; ++s) {
      const float* ss = st0 + s * G * (D + 2);
      const float f = expf(__ldcg(ss + G * D + g) - mx);
      l += __ldcg(ss + G * D + G + g) * f;
      o += __ldcg(ss + i) * f;
    }
    store(i, o / fmaxf(l, 1e-30f));
  }
  if (tid == 0) counters[bh] = 0;
}

template <int BITS, int D, int G>
cudaError_t launch(const void* q, const int8_t* kq, const float* kc, const int8_t* vq,
                   const float* vc, const int* pt, const int* len, void* out, float* scratch,
                   int* counters, int q_bf16, int B, int hkv, int page, int pps, int dt,
                   int nsplit, float scale, cudaStream_t s) {
  const int smem = smem_bytes(BITS, D, G, page);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(paged_decode_split_kernel<BITS, D, G>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               smem);
    if (e != cudaSuccess) return e;
  }
  paged_decode_split_kernel<BITS, D, G><<<dim3(B * hkv, nsplit), kThreads, smem, s>>>(
      q, kq, kc, vq, vc, pt, len, out, scratch, counters, q_bf16, hkv, page, pps, dt, nsplit,
      scale);
  return cudaGetLastError();
}

template <int BITS, int D>
cudaError_t launch_g(int G, const void* q, const int8_t* kq, const float* kc, const int8_t* vq,
                     const float* vc, const int* pt, const int* len, void* out, float* scratch,
                     int* counters, int q_bf16, int B, int hkv, int page, int pps, int dt,
                     int nsplit, float scale, cudaStream_t s) {
  switch (G) {
    case 1: return launch<BITS, D, 1>(q, kq, kc, vq, vc, pt, len, out, scratch, counters, q_bf16, B, hkv, page, pps, dt, nsplit, scale, s);
    case 2: return launch<BITS, D, 2>(q, kq, kc, vq, vc, pt, len, out, scratch, counters, q_bf16, B, hkv, page, pps, dt, nsplit, scale, s);
    case 4: return launch<BITS, D, 4>(q, kq, kc, vq, vc, pt, len, out, scratch, counters, q_bf16, B, hkv, page, pps, dt, nsplit, scale, s);
    case 8: return launch<BITS, D, 8>(q, kq, kc, vq, vc, pt, len, out, scratch, counters, q_bf16, B, hkv, page, pps, dt, nsplit, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, Hkv*G, D] float32 (dtype 0) or bfloat16 (dtype 1), D in {32, 64,
// 128}, zero past d; kq/vq int8 [P, Hkv, rows, d], d <= D (rows = page for
// bits 8, page/2 for bits 4), 16-byte aligned; kc/vc f32 [P, Hkv, 1, page];
// page_table int32 [B, pps]; lengths int32 [B]; out [B, Hkv*G, D] in q's
// dtype; scratch f32 [B * Hkv * nsplit * G * (D + 2)] (the partial states);
// counters int32 [>= B * Hkv], all 0 (each call leaves them 0). page a
// multiple of 16 from 16 to 256; G in {1, 2, 4, 8}. The plan
// (``paged_plan.k5_plan``): ``split_pages`` pages a split, ``nsplit`` =
// ceil(pps / split_pages) splits, ``smem`` bytes of dynamic shared memory;
// any other is refused. Returns cudaGetLastError().
extern "C" int qgemm_paged_decode_attention(const void* q, const void* kq, const void* kc,
                                            const void* vq, const void* vc,
                                            const void* page_table, const void* lengths,
                                            void* out, void* scratch, void* counters,
                                            int dtype, int bits, int B, int hkv, int G, int D,
                                            int d, int page, int pps, float scale,
                                            int split_pages_, int nsplit, int smem,
                                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || hkv <= 0 || pps <= 0 || page < 16 || page > 256 || page % 16 || d < 1 ||
      d > D || (dtype != 0 && dtype != 1) || (bits != 8 && bits != 4) ||
      (D != 32 && D != 64 && D != 128) || (G != 1 && G != 2 && G != 4 && G != 8) ||
      split_pages_ != split_pages(page) || nsplit != (pps + split_pages_ - 1) / split_pages_ ||
      nsplit > 65535 || smem != smem_bytes(bits, D, G, page))
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* k8 = static_cast<const int8_t*>(kq);
  const int8_t* v8 = static_cast<const int8_t*>(vq);
  const float* kcf = static_cast<const float*>(kc);
  const float* vcf = static_cast<const float*>(vc);
  const int* pt = static_cast<const int*>(page_table);
  const int* len = static_cast<const int*>(lengths);
  float* sc = static_cast<float*>(scratch);
  int* cnt = static_cast<int*>(counters);
  cudaError_t e;
  if (bits == 8 && D == 32) e = launch_g<8, 32>(G, q, k8, kcf, v8, vcf, pt, len, out, sc, cnt, dtype, B, hkv, page, pps, d, nsplit, scale, s);
  else if (bits == 8 && D == 64) e = launch_g<8, 64>(G, q, k8, kcf, v8, vcf, pt, len, out, sc, cnt, dtype, B, hkv, page, pps, d, nsplit, scale, s);
  else if (bits == 8) e = launch_g<8, 128>(G, q, k8, kcf, v8, vcf, pt, len, out, sc, cnt, dtype, B, hkv, page, pps, d, nsplit, scale, s);
  else if (D == 32) e = launch_g<4, 32>(G, q, k8, kcf, v8, vcf, pt, len, out, sc, cnt, dtype, B, hkv, page, pps, d, nsplit, scale, s);
  else if (D == 64) e = launch_g<4, 64>(G, q, k8, kcf, v8, vcf, pt, len, out, sc, cnt, dtype, B, hkv, page, pps, d, nsplit, scale, s);
  else e = launch_g<4, 128>(G, q, k8, kcf, v8, vcf, pt, len, out, sc, cnt, dtype, B, hkv, page, pps, d, nsplit, scale, s);
  return static_cast<int>(e);
}
