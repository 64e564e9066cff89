"""int8_gemm_roofline.ttft: per cent of K1's roofline reached: the
traced steps' linears at the rows their tokens need, each at the larger of
2 m K N / 1,979 TOP/s and its bytes / 3.35 TB/s, over the device time of
the kernels named below (K1's decode GEMV, its wgmma tile kernel, its row
pre-pass)."""

from portbench import readers

FAMILY = ("qmm_gemv_kernel", "qmm_wgmma_kernel", "row_quantize_kernel")


def read(run):
    return readers.gemm_roofline(run, FAMILY)
