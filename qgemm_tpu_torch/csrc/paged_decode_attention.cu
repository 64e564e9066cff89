// Kernel K5: one decode step (Sq = 1) of attention over the PAGED KV cache,
// int8 or int4 pools with per-position scales, for Hopper (sm_90a).
//
// Replaces _paged_kernel / paged_decode_attention and _ragged_kernel /
// paged_decode_attention_ragged of qgemm_tpu/ops/pallas/paged_attention.py.
// Same math: for query head h of slot b (pool head h / G),
//   s_j = (bf16(q) . K_j) * (1/sqrt(d)) * (kc_j / 127),   j < len_b,
// with position j in physical page page_table[b][j / page], row j % page;
// softmax in f32; p_j * (vc_j / 127) rounded to bf16 before the V product;
// out = acc / max(l, 1e-30), written once in q's dtype. int8 (and int4)
// codes are exact in bf16, so the products are exact and only their f32
// sums round, in K2's order (the same split body): on the same int8 rows,
// in pages of at most 128, K5 equals K2 bit for bit. A slot of length 0
// writes zeros.
//
// What bounds it on the H100: the pool read. Each step streams K and V of
// every resident position of every slot once (2 * d bytes per position and
// KV head for int8, d for int4, and two f32 scales) against ~4 * d flops
// per position and query head: far under the card's flop:byte balance. So
// the design is about bytes in flight: at 8 slots of ~300 positions, one
// block per (slot, KV head) walking its pages in turn kept ~2 KB in flight
// per SM, a tenth of what HBM's latency needs.
//
// Design (flash-decoding, the body shared with K2 in split_decode.cuh): one
// block of 4 warps per (slot * KV head, split), a split being K2's 128
// positions on int8 pools (but for pages that are multiples of 8 up to 256,
// which keep 128 / page whole pages, or one page past 128), and on int4
// pools whole pages, or a chunk of 128 positions of a page past 256
// (split_decode.cuh says how; at D 1024, 64), so that every block holds
// ~128 positions; the grid (slot * KV head, split; a launch per 65,535
// splits) follows the page table's width,
// which the host knows, while the lengths stay on the device and a block
// past its slot's length exits at once. A block copies its pages'
// contiguous K and V code rows and both scale rows into shared memory with
// 16-byte cp.async (32 KB at page 128 and d 128 int8; several blocks
// resident per SM), computes the split's partial state, and the last block
// of a (slot, KV head) merges the states in split order (split_decode.cuh
// says how). The step tables of the ragged entry (the TPU grid's schedule)
// are not read.
//
// Head widths: compiled for D in {32, 64, 128, 256, 512, 1024}; the pools' rows hold
// the true width d <= D (16-byte cp.async when d is a multiple of 16, byte
// loads otherwise; columns past d staged as zeros). The wrapper pads the
// per-call q to D and slices the output; the pools are never copied. GQA
// groups: any g >= 1, in the split body's row tiles (one pass of g rows
// for g in {1, 2, 4, 8}, else passes of 8 over the staged split). Pages:
// any size (int4: even); a split of small pages stages each page on its own
// (its scale row by 16-byte copies where the page is a multiple of 4
// positions, else by 4-byte ones). The launch plan (split, grid,
// shared memory) comes from qgemm_tpu_torch/ops/cuda/paged_plan.py; the
// entry refuses any other.
#include "split_decode.cuh"

namespace {

namespace sd = qg::split_decode;

template <int BITS, int D, int G, bool PASSES>
__global__ void __launch_bounds__(sd::kThreads)
paged_decode_split_kernel(const void* __restrict__ q, const int8_t* __restrict__ kq,
                          const float* __restrict__ kc, const int8_t* __restrict__ vq,
                          const float* __restrict__ vc, const int* __restrict__ page_table,
                          const int* __restrict__ lengths, void* __restrict__ out,
                          float* __restrict__ scratch, int* __restrict__ counters, int q_bf16,
                          int hkv, int page, int pps, int dt, int nsplit, int split0,
                          float scale, int ng) {
  const int bh = blockIdx.x, b = bh / hkv;
  const sd::PagedRows<BITS, D> rows{kq, kc, vq, vc, page_table + static_cast<size_t>(b) * pps,
                                    hkv, bh % hkv, page, dt};
  sd::decode_split<BITS, D, G, PASSES>(rows, q, out, scratch, counters, q_bf16, bh,
                                       blockIdx.y + split0,
                                       nsplit, min(lengths[b], pps * page), scale,
                                       ng);   // never past the table
}

template <int BITS, int D, int G, bool PASSES>
cudaError_t launch(const void* q, const int8_t* kq, const float* kc, const int8_t* vq,
                   const float* vc, const int* pt, const int* len, void* out, float* scratch,
                   int* counters, int q_bf16, int B, int hkv, int ng, int page, int pps, int dt,
                   int nsplit, float scale, cudaStream_t s) {
  const int smem = sd::smem_bytes(BITS, D, G, page);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(paged_decode_split_kernel<BITS, D, G, PASSES>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               smem);
    if (e != cudaSuccess) return e;
  }
  for (int s0 = 0; s0 < nsplit; s0 += sd::kMaxGridSplits) {   // a launch per 65,535 splits
    paged_decode_split_kernel<BITS, D, G, PASSES>
        <<<dim3(B * hkv, min(sd::kMaxGridSplits, nsplit - s0)), sd::kThreads, smem, s>>>(
            q, kq, kc, vq, vc, pt, len, out, scratch, counters, q_bf16, hkv, page, pps, dt,
            nsplit, s0, scale, ng);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// the group's row tile: one pass of g rows, or passes of the width's most
// rows (sd::row_tile)
template <int BITS, int D>
cudaError_t launch_g(int G, const void* q, const int8_t* kq, const float* kc, const int8_t* vq,
                     const float* vc, const int* pt, const int* len, void* out, float* scratch,
                     int* counters, int q_bf16, int B, int hkv, int page, int pps, int dt,
                     int nsplit, float scale, cudaStream_t s) {
#define QG_K5(T, P) launch<BITS, D, T, P>(q, kq, kc, vq, vc, pt, len, out, scratch, counters, q_bf16, B, hkv, G, page, pps, dt, nsplit, scale, s)
  const int tile = sd::row_tile(G, D);
  if constexpr (sd::max_rows(D) >= 8) {
    if (tile != G) return QG_K5(8, true);
    if (tile == 8) return QG_K5(8, false);
  } else {
    if (tile != G) return QG_K5(sd::max_rows(D), true);
  }
  if (tile == 4) return QG_K5(4, false);
  if (tile == 2) return QG_K5(2, false);
  return QG_K5(1, false);
#undef QG_K5
}

}  // namespace

// q [B, Hkv*G, D] float32 (dtype 0) or bfloat16 (dtype 1), D in {32, 64,
// 128, 256, 512, 1024}, zero past d; kq/vq int8 [P, Hkv, rows, d], d <= D
// (rows = page for bits 8, page/2 for bits 4), 16-byte aligned; kc/vc f32
// [P, Hkv, 1, page]; page_table int32 [B, pps]; lengths int32 [B]; out [B,
// Hkv*G, D] in q's dtype; scratch f32 [B * Hkv * nsplit * G * (D + 2)] (the
// partial states); counters int32 [>= B * Hkv], all 0 (each call leaves
// them 0). Any page >= 1 (int4: even); any G >= 1. The plan
// (``paged_plan.k5_plan``): ``split_pages`` pages a split (1 where a split
// is K2's positions or a chunk of a page), ``nsplit`` splits a slot
// (sd::paged_splits; a launch per 65,535 of them, grid (B * Hkv, splits)),
// ``smem`` bytes of dynamic shared memory at the group's row tile; any
// other is refused. Returns cudaGetLastError().
extern "C" int qgemm_paged_decode_attention(const void* q, const void* kq, const void* kc,
                                            const void* vq, const void* vc,
                                            const void* page_table, const void* lengths,
                                            void* out, void* scratch, void* counters,
                                            int dtype, int bits, int B, int hkv, int G, int D,
                                            int d, int page, int pps, float scale,
                                            int split_pages_, int nsplit, int smem,
                                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || hkv <= 0 || pps <= 0 || page < 1 || (bits == 4 && page % 2) || d < 1 ||
      d > D || (dtype != 0 && dtype != 1) || (bits != 8 && bits != 4) ||
      (D != 32 && D != 64 && D != 128 && D != 256 && D != 512 && D != 1024) || G < 1 ||
      split_pages_ != sd::paged_split_pages(bits, D, page) ||
      nsplit != sd::paged_splits(bits, D, page, pps) ||
      !qg::flat_grid_ok(static_cast<long long>(B) * hkv) ||
      smem != sd::smem_bytes(bits, D, sd::row_tile(G, D), page))
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* k8 = static_cast<const int8_t*>(kq);
  const int8_t* v8 = static_cast<const int8_t*>(vq);
  const float* kcf = static_cast<const float*>(kc);
  const float* vcf = static_cast<const float*>(vc);
  const int* pt = static_cast<const int*>(page_table);
  const int* len = static_cast<const int*>(lengths);
  float* sc = static_cast<float*>(scratch);
  int* cnt = static_cast<int*>(counters);
#define QG_K5(BB, DD) return static_cast<int>(launch_g<BB, DD>(G, q, k8, kcf, v8, vcf, pt, len, out, sc, cnt, dtype, B, hkv, page, pps, d, nsplit, scale, s))
  if (bits == 8) {
    if (D == 32) QG_K5(8, 32);
    if (D == 64) QG_K5(8, 64);
    if (D == 128) QG_K5(8, 128);
    if (D == 256) QG_K5(8, 256);
    if (D == 512) QG_K5(8, 512);
    QG_K5(8, 1024);
  }
  if (D == 32) QG_K5(4, 32);
  if (D == 64) QG_K5(4, 64);
  if (D == 128) QG_K5(4, 128);
  if (D == 256) QG_K5(4, 256);
  if (D == 512) QG_K5(4, 512);
  QG_K5(4, 1024);
#undef QG_K5
}
