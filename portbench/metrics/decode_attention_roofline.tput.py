"""decode_attention_roofline.tput: per cent of the decode attention's
roofline reached: the KV bytes the traced steps' decoded tokens need (each
KV head's int8 K and V codes and f32 scales of every attended position, q
and the output) over 3.35 TB/s, or their bf16 operations over 989 TFLOP/s
where larger, over the device time of the kernels named below (K2's and
K5's split-decode kernels)."""

from portbench import readers

FAMILY = ("dense_decode_split_kernel", "paged_decode_split_kernel")


def read(run):
    return readers.attention_roofline(run, FAMILY)
