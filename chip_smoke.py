"""End-to-end check of the PyTorch/CUDA port (qgemm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from qgemm_tpu_torch/csrc, holds each one
against its plain PyTorch version at the shapes the port once raised on
(``shape_limits``: K1, K8 and the dynamic GEMM at K not a multiple of 16,
the attention kernels at head_dim 32 and 2 and Dv != D, and the last
shapes the JAX kernels take: row 12 past head width 128, the attention
kernels past 256, pages of any size on K5 and K6, and batch * heads,
splits, slots x KV heads and experts past 65,535), K3 and K7 on
their bf16 tensor-core route at the tile edges (``flash_edges``: Sq, Sk in
{1, 63, 64, 65, 129}, D 32, 64, 128, causal and not) and every kernel at
GPT_6_7B shapes (K8 and K9 at the MoE model's, bit for bit; K6's first
causal rows on seeded q draws also against a float64 result), times them
(K3 and K7 with their launch plans, SDPA beside them and K7 split into
its three kernels: ``timing_flash``), drives the
op layer's three kernels (row softmax, fused residual LayerNorm, int8
flash attention) at GPT_6_7B's widths with their launch counts
(``ops_layer``), times them beside their bounds and library calls, runs
bench.py's GEMM protocol at 2048^3 (the dynamic path through K9 and K1),
and serves 16 greedy requests through
ContinuousBatchingEngine on the full-width, full-depth GPT_6_7B (random
weights from a seed) five times. Three runs use the int8 KV cache: int8
weights, int4 (W4A8) weights, and int8 weights with the LLM.int8() outlier
split (outlier feature dims planted in the LayerNorm gains). Two use the
paged KV tier with int8 weights, a 256-token prefix shared by half the
requests and chunked admission: int8 pools, then int4 pools in an
undersized pool with over-commit and overlapped admission. ``serve_moe``
serves the same 16-request mix on the MoE GPT of scripts/bench_moe.py
(top-2 of 8 experts, 24 layers, d_model 2048, int8 weights quantized by
kernel K9, every expert FFN through kernel K8). Each serving run checks
that it went through its kernels. Then it compares a 2-layer full-width
model's prefill logits between the CPU (float32, plain versions) and the
GPU (bf16, kernels), the same for a 2-layer MoE model (float32 on both
sides, with greedy tokens), and the logits' quantization error with and
without the outlier split. Then the training path: kernel K7 (the
flash backward) was held against its plain version and timed with the
other kernels; ``train`` takes Adam steps on GPT_6_7B's widths at 4 layers
(bf16, 4 x 2048 tokens) through K3 and K7; ``train_induction`` trains the
example's small GPT on the copy task to convergence, its default head_dim
32 among the widths; ``train_serve``
quantizes the trained model to int8 and serves held-out copy prompts
through the engine; ``long_copy`` trains a copy model at 384 positions,
whose decode spans three of the decode kernels' 128-position splits, and
serves it in int8 through the dense engine (K2) and the paged one on int8
and int4 pools (K6, K5), each held to its teacher-forced accuracy and the
int8 runs to ``generate``'s transcripts. Every serving engine decodes by
replaying a captured CUDA graph of its decode step
(``serving/decode_graph.py``); ``decode_graph`` holds that route, and the
route with ``multi_step=4``, to the eager one bit for bit on GPT_6_7B's
dense and paged int8 engines, traces a replayed step, counts the host's
calls per step and recovers from a replay fault; the long copy model is
also served in blocks of four and with dense chunked admission. ``spec``
serves GPT_6_7B (int8, at 8 of its 32 layers) with its W4A8 self-draft
through speculative rounds (gamma 4) on the dense int8 and paged int8
engines: eager, graph and ``multi_step=4`` rounds must give equal
transcripts and the launches per round K4 (gamma + 1) x 49, K1 49, K6 8
(paged); ``spec_tv`` holds the sampled round's draws to the target's
distribution, and ``long_copy`` adds seven speculative engines (two
drafts each). ``seq2seq`` serves S2S_1_5B (int8, at 6 + 6 of its 12 + 12
layers) through Seq2SeqEngine
dense, paged (int8 and int4 pages), with ``multi_step=4`` and
speculatively, routes held equal, launches per step K1 49 and K2 or K5
6, and runs beam search and the transformer demo; ``s2s_reverse``
trains a reverse model and serves it through seven seq2seq engines, each
held to its teacher-forced accuracy and the int8 ones to ``generate``'s
transcripts. ``k1_given_cx`` holds K1's route on caller-given row scales
(the row-parallel int8 layer's) at GPT_6_7B's W_O and FFN-down shard
shapes for p 1, 2 and 4, m 8 and 512: bit for bit to its plain version and
to the fused route on the shard's own absmax, the p shards summed by hand
against the unsharded K1, each timed beside its bound. ``tp_serving``
(after ``decode_graph``, on its model) serves GPT_6_7B through the
tensor-parallel route on an NCCL group of world 1: the dense int8-KV graph
engine, the paged int8 graph engine and the speculative dense engine, 8
greedy requests each, with and without the mesh, transcripts, launches and
stats equal bit for bit, 129 collectives a decode step with the analytic
all-reduce bytes, 64 K1 launches a step on the given-cx route.
``parallel`` (after ``serve_moe``, world 1 over NCCL) serves the MoE GPT
with its experts sharded over the model axis through the dense and paged
graph engines against the un-meshed ones bit for bit (one more SUM a
layer a decode step), runs all-to-all expert parallelism on one layer,
ring attention's block loops over four shards of an S 8192 sequence on
the card against K3 and K7 over the whole sequence (K3 and K7 once per
visible block), the data x model Adam step of the ``train`` model bit for
bit to the un-meshed step, and GPipe at one stage. ``surface`` (after
``decode_graph``) holds the names the port gained for the JAX package's
surface: ``backend=`` of the four public int8 matmuls at 2048^3 ("kernel"
and "auto" equal bits through K1, or K9 and K1; "plain" no counted launch,
within 1e-6 of the largest output), ``matmul_fn`` on the outlier route,
and ``utils.profiling.trace`` around 4 steady graph decode steps of
``decode_graph``'s dense int8 engine (the trace file must name K1's GEMV,
its pre-pass, K2 and the graph launches). ``dryrun`` (after ``parallel``)
runs the port's ``run_dryrun`` at world 1 over NCCL: every section but the
two MoE ones, which need two experts, and K1, K3, K4, K5, K6 and K7 must
launch. ``wide_pages`` (after ``attn_geometries``) serves GPT_6_7B's
widths at 4 layers through the paged engine at pages of 12 and 512 (int8)
and 4 (int4), K5 and K6 launched once per layer a step or chunk, and
times the kernels at the last shapes (``last_timing``). Each phase
prints one JSON line; the last line is {"ok": true, "device": {...}}. Any failure raises, so the
exit code is nonzero. Needs one CUDA device; exits nonzero without one.
Uses no JAX.

    python3 chip_smoke.py --tp-faults    # planted faults of the TP route, each caught
    python3 chip_smoke.py --tp-cards N   # N ranks on N cards against one card, faults planted;
                                         # then ring, Ulysses, EP, dp x tp and GPipe across them;
                                         # then run_dryrun across them, the ranks agreeing
    python3 chip_smoke.py --build-times  # each kernel source compiled alone, its seconds
    python3 chip_smoke.py --only PHASE[,PHASE...]

builds the kernels and runs only the named phases (``shape_limits``,
``ops_layer``, ...), for a short first run of new kernels.

    python3 chip_smoke.py --seq2seq-faults

trains the reverse model once, then plants three faults in the seq2seq
engine (copies of the package: the cross read ignoring the source
lengths, cross K/V written into the next slot's rows, the int8 cross
scales dropped) and fails unless each breaks the reverse model's bounds
on at least one engine (``S2S_FAULTS``).

    python3 chip_smoke.py --spec-faults

plants three faults in the speculative round (copies of the package) and
fails unless each is caught by the check named for it (``SPEC_FAULTS``).

    python3 chip_smoke.py --dense-step-ab OTHER_CHECKOUT [ROUNDS]

serves the dense int8 run alone, with another checkout's package (an
earlier commit unpacked by ``git archive``) and this one's, in turns
(other, this, this, other; ROUNDS times, default 1), each in its own
process, and prints both sides' decode step times.

    python3 chip_smoke.py --flash-ab OTHER_CHECKOUT [ROUNDS]

times K3 (B 1, H 32, S 512 and B 4, H 32, S 2048; D 128, causal, bf16),
K7 (B 4, H 32, S 2048) and the ``train`` step with another checkout's
package and this one's in the same turns, one process each, runs the bf16
edge grid on both, and prints each run, the medians and their ratios.

    python3 chip_smoke.py --gemv-ab OTHER_CHECKOUT [ROUNDS]

times the decode GEMVs (K1 and K4 at the four GPT_6_7B decode shapes and m
1, 8, 16; K8 at its two decode shapes) and the int8 and W4A8 engines'
steady decode windows (device time, the GEMV and pre-pass families, wall
time, idle share) with another checkout's package and this one's in the
same turns, and prints the medians, their ratios and the shares of the
byte bounds.

    python3 chip_smoke.py --tile-ab OTHER_CHECKOUT [ROUNDS]

times the tile kernels (K1 and K4 at the four GPT_6_7B shapes and m 32,
128, 512; K8 at its two MoE products and C 168, 328; row 3's dynamic
2048^3) and one full-depth GPT_6_7B prefill per bucket (128, 256, 512
tokens; int8 and W4A8 weights: wall time, device time, the tile kernels'
and pre-pass's time) with another checkout's package and this one's in the
same turns, and prints the medians, their ratios and the shares of the
kernels' bounds.

    python3 chip_smoke.py --paged-ab OTHER_CHECKOUT [ROUNDS]

times K5 (int8 and int4 pools; B 8, H 32, D 128, page 128 at row 9's
lengths 150-550 and at the decode profile's ~316), K6 (B 1, H 32, C 256,
D 128; int8 and int4; Hkv 32 and 8; after 0 and 768 positions), the paged
int8 engine's steady decode window (device time, K5's family, wall time,
idle share) and one full-depth GPT_6_7B prompt of 1024 tokens admitted in
256-row chunks (wall, device, K6's time) with another checkout's package
and this one's in the same turns, and prints the medians, their ratios and
the shares of the kernels' bounds.

    python3 chip_smoke.py --decode-ab OTHER_CHECKOUT [ROUNDS]

times K2 (int8 cache, B 8, H 32, S 1024, D 128 at row 5's lengths
150-550 and at 8 x 1,000 positions) and K5 (ragged entry, int8 pages of
128, the same rows), compares K5's outputs on seeded pools bit for bit
between the two checkouts, and profiles the dense int8 engine's steady
decode window on GPT_6_7B and on the MoE GPT (device time, the K2 family,
device operations, wall time, idle share) with another checkout's package
and this one's in the same turns, and prints the medians, their ratios
and the shares of the kernels' bounds.

    python3 chip_smoke.py --paged-logits N

serves the paged run's two short prompts and N more random ones (128-500
tokens) one at a time through the paged int8 engine on the full-depth
GPT_6_7B and prints, per request, how far its logits stray from
``generate``'s (dense int8 cache, K2 decode) at each step of their shared
history, relative to the largest logit: the readings ``serve_paged``
holds to ``PAGED_LOGIT_RTOL``.

    python3 chip_smoke.py --long-copy CKPT

trains the long copy model (``phase_long_copy``) and saves it to CKPT, or
reloads it from there, and prints its readings served through the dense
int8, paged int8 and paged int4 engines, judging none.

    python3 chip_smoke.py --decode-faults N [OTHER_CHECKOUT]

runs ``--long-copy`` and ``--paged-logits N`` with this checkout's kernels
(or another checkout's) and, with each of three faults planted in the decode kernels' split merge
(in copies of the script and package in a temporary directory), the
parity of each decode kernel the fault reaches, ``--long-copy`` on the
saved model and ``--paged-logits N``; prints every reading beside its
bound and fails unless the sound run keeps its bounds, every fault fails
the parity and the long copy's accuracy bound catches the dropped splits.

    python3 chip_smoke.py --k6-draws N

runs K6's edge case (offsets [0], Hkv 8, int8 pool) on the q draws of
seeds 0 to N - 1 against its plain version and a float64 result, and
prints each draw and the draws past the parity rule.

    python3 chip_smoke.py --quant-ab OTHER_CHECKOUT [ROUNDS]

times K9 (the MoE model's two expert weights in bf16 and 2048^2 f32, and
the MoE load's 48 launches), the dynamic GEMM at 2048^3 and row 12 (B 1,
H 32, S 2048, D 128, causal, bf16: the main kernel, the pre-pass and the
whole wrapper, int8 P and qk_only) with another checkout's package and
this one's in the same turns, compares their outputs (and K8's at C 8 and
168) bit for bit between the checkouts, and prints the medians, their
ratios and the shares of the bounds.

    python3 chip_smoke.py --quant-faults [OTHER_CHECKOUT]

runs the phases ``k9``, ``gemm_protocol`` and ``ops_layer`` on this
checkout's kernels (or another's), which must pass, then plants three
faults in copies (K9 without its cluster merge, row 12's pre-pass mean
over S - 1, row 12 without its alpha rescale) and fails unless each fails
the check named for it.

    python3 chip_smoke.py --graph-ab OTHER_CHECKOUT [ROUNDS]

profiles the steady decode windows of the full-depth int8 GPT_6_7B's dense
and paged int8 engines (wall and device time per step and per token, idle
share, the host's calls that queue device work, device operations, ITL
p50/p95, tokens/s) with another checkout's package (eager) and this one's
eager route, graph and graph with ``multi_step=4``, in turns (other,
eager, graph, graph_ms4, then back; ROUNDS times), one process each, and
prints the medians and their ratios to the other checkout's.

    python3 chip_smoke.py --graph-faults

runs ``--long-copy`` and ``--graph-transcripts`` (a random-weight int8
GPT through graph engines, held to ``generate``'s transcripts) with this
checkout's package and with each of three faults planted in the decode
step's in-place inputs (page tables uploaded into a fresh tensor, tokens
not fed back, positions not advanced), and fails unless the sound run
keeps its bounds and every fault fails the checks named for it: the
transcripts, and the long copy's accuracy floor where the fault reaches
what the copy model reads (it copies by position, so a token not fed back
leaves it at 1.0).

    python3 chip_smoke.py --row12-trace

traces five calls of row 12's pre-pass kernel and main kernel and prints
each device kernel's time a call.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

# H100 SXM published peaks (dense): HBM bytes/s, int8 ops/s, bf16 flop/s
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
BF16_FLOPS = 989e12


# GEMM shapes of a GPT_6_7B decode step: QKV / W_O, FFN up, FFN down, lm_head
GEMM_SHAPES = [(4096, 4096), (4096, 16384), (16384, 4096), (4096, 50272)]
# the six feature dims whose LayerNorm gains the outlier phases set to 20
OUTLIER_DIMS = [13, 781, 1550, 2402, 3119, 3990]
# The MoE serving configuration of scripts/bench_moe.py (its defaults): top-2
# of 8 experts, 24 layers, d_model 2048, 16 heads x 128, expert d_ff 4096,
# vocab 50272, bf16. The JAX package names no constant for it.
MOE_CFG = dict(vocab_size=50272, d_model=2048, n_heads=16, d_ff=4096, n_layers=24,
               max_seq_len=1024, dtype="bfloat16", n_experts=8, moe_top_k=2)
# K8's products in that model: up (K 2048 -> N 4096, ReLU) and down (K 4096
# -> N 2048), over E 8 experts of C capacity rows: C 8 at a decode step of 8
# slots, 168 and 328 at prefill buckets of 512 and 1024 tokens
MOE_GEMMS = [(2048, 4096), (4096, 2048)]


# rows of the K1 and K4 parity checks: the decode GEMV's (1, 8), the tile
# kernel's 64-row edges, a ragged 300, the prefill buckets 128 and 512 and
# 2048; the ragged n 4100 runs at m 300 beside them
PARITY_ROWS = (1, 8, 17, 32, 63, 64, 65, 128, 300, 512, 2048)
RAGGED_ROWS = (1, 17, 300)
# K8's capacities on the tile kernel: the smallest, a 512- and a 1024-token prefill
K8_TILE_ROWS = (17, 168, 328)
# rows of the K1 and K4 timing tables: decode (the GEMVs), prefill buckets
TIMING_ROWS = (1, 8, 16, 32, 128, 256, 512)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(bytes_moved: float, ops: float, peak_ops: float):
    """Least time (ms) for the work on the card and which roof sets it."""
    t_bytes, t_ops = bytes_moved / HBM_BPS * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| over max |ref|."""
    return max_err(got, ref) / max(float(ref.float().abs().max()), 1e-30)


def excess(got: torch.Tensor, ref: torch.Tensor, rtol: float) -> float:
    """max(|got - ref| - rtol * |ref|): the error beyond a relative allowance
    (rtol 2^-7 covers one bf16 rounding of an output on each side)."""
    g, r = got.float(), ref.float()
    return float(((g - r).abs() - rtol * r.abs()).max())


def bench_queued_or_not(fn) -> tuple:
    """bench_ms of ``fn`` queued behind the device sleep, or, where the host
    cannot queue its calls ahead (too many launches), without the sleep:
    (ms, how it was timed)."""
    from qgemm_tpu_torch.utils.profiling import bench_ms
    try:
        return bench_ms(fn), "queued behind the sleep"
    except RuntimeError as e:
        print(f"bench_ms could not queue ahead ({e}); timing without the sleep",
              file=sys.stderr)
        return bench_ms(fn, queue_ahead=False), "not queued ahead (host launches inside)"


def expert_int_mm_loop(x, wt, cw):
    """K8's yardstick (not a route of the port): per expert, torch
    row-quantize, torch._int_mm (rows padded to >= 17) and dequant."""
    from qgemm_tpu_torch.ops.quantize import absmax_quantize, dequantize
    outs = []
    for e in range(x.shape[0]):
        xq, cx = absmax_quantize(x[e].float(), axis=-1)
        m = xq.shape[0]
        if m < 17:
            xq = torch.cat([xq, xq.new_zeros((17 - m, xq.shape[1]))])
        outs.append(dequantize(torch._int_mm(xq, wt[e].t())[:m], cx, cw[e]))
    return torch.stack(outs)


def torch_col_quantize(w):
    """K9's yardstick (not a route of the port): the torch f32 column
    quantize the port ran before K9 (``quantize_weights`` of the f32
    weight, then the K-major copy), per expert for a stacked weight."""
    from qgemm_tpu_torch.ops.quantize import quantize_weights
    if w.ndim == 2:
        return quantize_weights(w.float())
    return [quantize_weights(w[e].float()) for e in range(w.shape[0])]


def paged_kv_bytes(lengths, hkv: int, d: int, page: int, bits: int) -> int:
    """Bytes of K and V that attending positions j < length of each slot
    reads from a paged pool: codes (int8 rows; an int4 byte row r holds
    positions r and r + page/2, so a slot's last page of fill f needs
    min(f, page/2) byte rows) and one f32 scale per position."""
    total = 0
    for n in map(int, lengths):
        full, fill = divmod(n, page)
        rows = n if bits == 8 else full * (page // 2) + min(fill, page // 2)
        total += hkv * 2 * (rows * d + n * 4)
    return total


def random_paged_cache(seed: int, lengths, hkv: int, page: int, bits: int, pps: int,
                       d: int = 128):
    """A paged cache on the card holding random codes (any byte: int4 nibbles
    span [-8, 7]) and positive scales for ``lengths`` tokens per slot, in
    pages of a shuffled physical order, with the step tables the engine
    would build. Returns (cache, resident page count)."""
    from qgemm_tpu_torch.serving.paged_cache import PagedKVCache, build_step_tables
    cpu = torch.Generator().manual_seed(seed)
    counts = [-(-int(n) // page) for n in lengths]
    n_pages = 1 + sum(counts) + 2
    perm = (torch.randperm(n_pages - 1, generator=cpu) + 1).tolist()
    pt = torch.zeros((len(lengths), pps), dtype=torch.int32)
    for s, n in enumerate(counts):
        pt[s, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    rows = page if bits == 8 else page // 2
    lo = -127 if bits == 8 else -128
    codes = lambda: torch.randint(lo, 128, (n_pages, hkv, rows, d), generator=g,
                                  device="cuda", dtype=torch.int8)
    scales = lambda: torch.rand((n_pages, hkv, 1, page), generator=g, device="cuda") * 2 + 0.05
    ss, sp = build_step_tables(counts, pps)
    cache = PagedKVCache(kq=codes(), kc=scales(), vq=codes(), vc=scales(),
                         page_table=pt.cuda(), step_slot=torch.from_numpy(ss),
                         step_page=torch.from_numpy(sp), page_size=page, kv_bits=bits)
    return cache, sum(counts)


def dense_requests(cfg, rng) -> list:
    """The dense serving runs' 16 requests as (prompt, max_new_tokens):
    random prompts of 128-500 tokens, max_new_tokens 16-48."""
    plens = rng.integers(128, 501, size=16)
    news = rng.integers(16, 49, size=16)
    return [(rng.integers(0, cfg.vocab_size, size=int(p)).tolist(), int(n))
            for p, n in zip(plens, news)]


def paged_requests(vocab: int, rng) -> tuple:
    """The paged serving runs' 16 requests, alternating: 8 share a 256-token
    prefix (a system prompt of two pages) followed by a random suffix of
    32-300 tokens; 8 are random prompts of 128-500 tokens, the first two of
    at most 256 (no prefix hit, one chunk: the whole-prompt prefill).
    max_new_tokens 16-48. Returns (prompts, max_new, indices of the two
    short random prompts)."""
    prefix = rng.integers(0, vocab, size=256).tolist()
    shared = [prefix + rng.integers(0, vocab, size=int(n)).tolist()
              for n in rng.integers(32, 301, size=8)]
    plens = rng.integers(128, 501, size=8)
    plens[:2] = rng.integers(128, 257, size=2)
    own = [rng.integers(0, vocab, size=int(n)).tolist() for n in plens]
    prompts = [p for pair in zip(shared, own) for p in pair]
    news = [int(n) for n in rng.integers(16, 49, size=16)]
    return prompts, news, (1, 3)


# ------------------------------------------------------------------ phases
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = "nvidia-smi unavailable"
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build() -> None:
    """The kernels (one ``nvcc`` per source, all at once) and the two host
    libraries (``g++``: the native scheduler, which every engine that names
    no scheduler then takes, and the idx loader)."""
    from qgemm_tpu_torch.ops.cuda import _build
    from qgemm_tpu_torch.utils import host_build
    t0 = time.perf_counter()
    built = _build.build()
    secs = time.perf_counter() - t0
    for name, log in _build.build_logs.items():
        print(f"--- ptxas {name}\n{log}", file=sys.stderr)
    t0 = time.perf_counter()
    host = {name: host_build.build(name).name for name in host_build.HOST_LIBS}
    emit({"phase": "build", "seconds": round(secs, 2), "built": built,
          "host_libraries": host, "host_seconds": round(time.perf_counter() - t0, 2)})


def build_times() -> None:
    """``--build-times``: every kernel source compiled alone, one ``nvcc``
    each, all started together (as ``phase_build`` starts them): each
    source's seconds to finish, the count of its kernels and its spills
    (``ptxas``), and whether it built. Prints one JSON line; fails if a
    source did not build."""
    import threading

    from qgemm_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    procs = {n: _build._compile(n) for n in _build.KERNELS}
    logs, secs = {}, {}

    def wait(name, proc):
        logs[name] = proc.communicate()[0]
        secs[name] = round(time.perf_counter() - t0, 1)

    threads = [threading.Thread(target=wait, args=kv) for kv in procs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    res = {}
    for name, proc in procs.items():
        print(f"--- nvcc {name}\n{logs[name]}", file=sys.stderr)
        if proc.returncode == 0:
            _build.publish(_build._lib_path(name))
        res[name] = {"seconds": secs[name], "built": proc.returncode == 0,
                     "kernels": logs[name].count("Compiling entry function"),
                     "spills": sum(" 0 bytes spill stores" not in ln
                                   for ln in logs[name].splitlines() if "spill stores" in ln)}
    emit({"phase": "build_times", "sources": res,
          "seconds": round(time.perf_counter() - t0, 1)})
    if not all(r["built"] for r in res.values()):
        raise AssertionError(f"build_times: a source did not build: {res}")


def phase_parity() -> dict:
    """Each kernel against its plain version at the serving shapes."""
    from qgemm_tpu_torch.ops.quantize import (dequantize_weights_int4, quantize_weights,
                                              quantize_weights_int4, quantized_matmul_plain,
                                              quantized_matmul_prequant,
                                              quantized_matmul_prequant_outlier,
                                              quantized_matmul_prequant_w4, w4a8_matmul_plain)
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    errs = {name: {"max_abs_err": 0.0, "max_rel_err": 0.0}
            for name in ("quantized_matmul", "decode_attention", "flash_attention",
                         "w4a8_matmul", "paged_decode_attention", "paged_context_attention",
                         "flash_attention_bwd", "flash_attention_autograd",
                         "expert_matmul", "col_quantize", "decode_attention_equals_paged")}
    report = []

    def record(name, got, ref, **row):
        e, r = max_err(got, ref), rel_err(got, ref)
        errs[name]["max_abs_err"] = max(errs[name]["max_abs_err"], e)
        errs[name]["max_rel_err"] = max(errs[name]["max_rel_err"], r)
        report.append(dict(kernel=name, max_abs_err=e, max_rel_err=r, **row))
        return e

    # K1: identical int8 codes on both sides, so only the f32 epilogue's
    # association differs: |err| <= 1e-6 * max|ref| (a few f32 ulps). The
    # rows past the first 512 and the ragged n 4100 draw from a generator of
    # their own, so the other checks keep their inputs.
    g_tile = torch.Generator(device=dev)
    g_tile.manual_seed(11)
    for k, n in GEMM_SHAPES + [(4096, 4100)]:
        ragged = n == 4100
        gw = g_tile if ragged else g
        w = torch.randn((k, n), generator=gw, device=dev).to(torch.bfloat16) * 0.02
        wq = quantize_weights(w)
        x = torch.randn((512, k), generator=gw, device=dev).to(torch.bfloat16)
        x = torch.cat([x, torch.randn((PARITY_ROWS[-1] - 512, k), generator=g_tile,
                                      device=dev).to(torch.bfloat16)])
        rows = {}
        for m in RAGGED_ROWS if ragged else PARITY_ROWS:
            got = quantized_matmul_prequant(x[:m], wq)
            ref = quantized_matmul_plain(x[:m], wq)
            tol = 1e-6 * float(ref.abs().max())
            e = record("quantized_matmul", got, ref, m=m, k=k, n=n, tol=tol)
            if not e <= tol:
                raise AssertionError(f"K1 m={m} k={k} n={n}: max err {e} > {tol}")
            rows[m] = got[0]
        # a row's result may not depend on how many rows share the call, nor
        # on the route (the GEMV at m <= 16, the tile kernel's plans above)
        for m, row in rows.items():
            if not torch.equal(row, rows[1]):
                raise AssertionError(f"K1 row 0 differs between m=1 and m={m} (k={k}, n={n})")
        del w, wq, x

    # K4: identical int8 codes and int32 group sums, and both kernels fold
    # groups and slabs in the plain version's order with correctly rounded
    # f32 steps: bit-equal to the plain version. The first K slab is 8x
    # larger, so per-slab scales differ within a row.
    for k, n in GEMM_SHAPES + [(4096, 4100)]:
        ragged = n == 4100
        gw = g_tile if ragged else g
        wq4 = quantize_weights_int4(torch.randn((k, n), generator=gw, device=dev) * 0.02)
        x = torch.randn((512, k), generator=gw, device=dev)
        x = torch.cat([x, torch.randn((PARITY_ROWS[-1] - 512, k), generator=g_tile, device=dev)])
        x[:, :2048] *= 8.0
        x = x.to(torch.bfloat16)
        rows = {}
        for m in RAGGED_ROWS if ragged else PARITY_ROWS:
            got = quantized_matmul_prequant_w4(x[:m], wq4)
            ref = w4a8_matmul_plain(x[:m], wq4)
            e = record("w4a8_matmul", got, ref, m=m, k=k, n=n, tol=0.0)
            if not bits_equal(got, ref):
                raise AssertionError(f"K4 m={m} k={k} n={n}: not bit-equal to its plain "
                                     f"version (max err {e})")
            rows[m] = got[0]
        for m, row in rows.items():
            if not torch.equal(row, rows[1]):
                raise AssertionError(f"K4 row 0 differs between m=1 and m={m} (k={k}, n={n})")
        del wq4, x

    k8_k9_checks(g, record)
    k8_tile_checks(record)
    gemv_parity(record)

    # the outlier split at the GEMM level, on planted-outlier activations
    # (three columns x60, as tests/test_outlier_serving.py builds them): the
    # decomposed product's error against the exact one is under half of the
    # plain quantized product's, for int8 (K1) and int4 (K4) weights
    k, n = 4096, 4096
    x = torch.randn((64, k), generator=g, device=dev)
    x[:, [5, 40, 100]] *= 60.0
    x = x.to(torch.bfloat16)
    w = torch.randn((k, n), generator=g, device=dev) / 64.0
    outlier_checks = []
    for bits in (8, 4):
        wq = quantize_weights_int4(w) if bits == 4 else quantize_weights(w)
        wf = dequantize_weights_int4(wq, k=k) if bits == 4 else w
        exact = torch.matmul(x.float(), wf)
        plain = quantized_matmul_prequant_w4(x, wq) if bits == 4 \
            else quantized_matmul_prequant(x, wq)
        dec = quantized_matmul_prequant_outlier(x, wq, threshold=6.0, capacity=32)
        e_plain = float((plain - exact).norm() / exact.norm())
        e_dec = float((dec - exact).norm() / exact.norm())
        outlier_checks.append({"bits": bits, "rel_err_plain": e_plain, "rel_err_outlier": e_dec})
        if not e_dec < e_plain / 2:
            raise AssertionError(f"outlier split, bits={bits}: error {e_dec} not under "
                                 f"half of the plain {e_plain}")
    del x, w, wq, wf

    k2_parity(g, record)
    k3_checks(g, record)

    paged_parity(g, record)
    k6_edges = k6_edge_checks(record)
    k2_k5_checks(record)
    k7_checks(g, record)
    torch.cuda.synchronize()
    emit({"phase": "parity", "checks": report, "outlier_gemm": outlier_checks,
          "k6_edges": k6_edges})
    return errs


def k2_parity(g: torch.Generator, record) -> None:
    """K2 against its plain version at GPT_6_7B's decode shape (B 8, H 32,
    S 1024, D 128; ragged lengths 1 to 1024): int8 caches, MHA and GQA
    (Hkv 16), and the bf16 and f32 caches."""
    from qgemm_tpu_torch.ops.cuda.decode_attention import (decode_attention,
                                                           decode_attention_plain)
    from qgemm_tpu_torch.ops.kv_cache import quantize_kv
    dev = "cuda"
    # K2: p rounds to bf16 on both sides at slightly different running
    # maxima (a one-ulp flip of a probability moves an output by <= ~4e-3),
    # and a bf16 output rounds once on each side (2^-7 relative)
    b, h, s, d = 8, 32, 1024, 128
    lengths = torch.tensor([1, 130, 257, 500, 511, 1000, 1024, 64], device=dev,
                           dtype=torch.int32)
    for hkv, cache in [(32, "int8"), (16, "int8"), (32, "bfloat16"), (32, "float32")]:
        q = torch.randn((b, h, 1, d), generator=g, device=dev).to(torch.bfloat16)
        kf = torch.randn((b, hkv, s, d), generator=g, device=dev)
        vf = torch.randn((b, hkv, s, d), generator=g, device=dev)
        if cache == "int8":
            (kq, kc), (vq, vc) = quantize_kv(kf), quantize_kv(vf)
            args, kw = (q, kq, vq, lengths), {"kc": kc, "vc": vc}
        else:
            dt = getattr(torch, cache)
            args, kw = (q.to(dt), kf.to(dt), vf.to(dt), lengths), {}
        got = decode_attention(*args, **kw)
        ref = decode_attention_plain(*args, **kw)
        tol = 5e-3 if cache != "float32" else 1e-4
        e = record("decode_attention", got, ref, cache=cache, hq=h, hkv=hkv, s=s,
                   tol=tol)
        if not excess(got, ref, 2 ** -7 if cache != "float32" else 0.0) <= tol:
            raise AssertionError(f"K2 {cache} hkv={hkv}: max err {e} > {tol}")


def k2_k5_checks(record) -> None:
    """K2 and K5 on the same int8 rows give equal bits: a paged pool
    (``random_paged_cache``, pages shuffled) at pages of 16, 32 and 128,
    gathered into a dense cache, through K2 at the pool's extent and at an
    extent of the longest length + 3 (S not a multiple of 4: the scale rows
    lose their 16-byte alignment), and through K5's ragged entry; MHA and
    GQA (G 4), head widths 128 and 80, bf16 q and one f32 q. Both run the
    split body of csrc/split_decode.cuh over 128-position splits from
    position 0. q draws from a generator of its own."""
    from qgemm_tpu_torch.ops.cuda.decode_attention import decode_attention
    from qgemm_tpu_torch.ops.cuda.paged_decode_attention import paged_decode_attention_ragged
    from qgemm_tpu_torch.serving.paged_cache import gather_slot_kv
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(25)
    lengths = torch.tensor([0, 1, 128, 129, 300, 640, 1000, 1018], device=dev,
                           dtype=torch.int32)
    cases = [(page, hkv, d, torch.bfloat16) for page in (16, 32, 128) for hkv in (32, 8)
             for d in (128, 80)] + [(32, 8, 128, torch.float32)]
    for page, hkv, d, qdt in cases:
        cache, _ = random_paged_cache(80 + page + hkv + d, lengths.tolist(), hkv, page, 8,
                                      pps=1024 // page, d=d)
        q = torch.randn((8, 32, 1, d), generator=g, device=dev).to(torch.bfloat16).to(qdt)
        paged = paged_decode_attention_ragged(q, cache, lengths)
        kq, kc, vq, vc = gather_slot_kv(cache)
        for s in (kq.shape[2], int(lengths.max()) + 3):
            dense = decode_attention(q, kq[:, :, :s].contiguous(), vq[:, :, :s].contiguous(),
                                     lengths, kc=kc[:, :, :s].contiguous(),
                                     vc=vc[:, :, :s].contiguous())
            record("decode_attention_equals_paged", dense, paged, page=page, hkv=hkv, d=d,
                   s=s, q_dtype=str(qdt), tol=0.0)
            if not (dense.dtype == paged.dtype == qdt and bits_equal(dense, paged)):
                raise AssertionError(f"K2 != K5 bit for bit: page={page} hkv={hkv} d={d} "
                                     f"S={s} q {qdt}, max diff {max_err(dense, paged)}")
        del cache, kq, kc, vq, vc


def paged_parity(g: torch.Generator, record) -> None:
    """K5, both entries, and K6 against their plain versions in bf16 (q and
    p * vc/127 rounded where the kernels round): K2's tolerance and
    reasoning. GPT_6_7B is MHA (Hkv 32); GQA (Hkv 8, g 4) runs too. Page
    tables take pages in a shuffled physical order; a slot of length 0
    must come out as zeros (the plain version averages V there, junk the
    engine never reads). Pages of 128 and 32 draw from ``g``; pages of 16
    (K6's 64-key tiles straddle four pages, K5's splits hold eight) and
    K6 at pages of 32 draw from a generator of their own, so the older
    checks keep their draws, as do a float32 q (the kernels' other input
    and output dtype) and a float16 q (which the wrappers pass through
    float32)."""
    from qgemm_tpu_torch.ops.cuda.paged_context_attention import paged_context_attention
    from qgemm_tpu_torch.ops.cuda.paged_decode_attention import (
        paged_decode_attention, paged_decode_attention_ragged)
    from qgemm_tpu_torch.serving.paged_cache import (paged_attention_reference,
                                                     paged_context_attention_reference)
    dev, bf16 = "cuda", torch.bfloat16
    g16 = torch.Generator(device=dev)
    g16.manual_seed(16)
    lengths = torch.tensor([0, 1, 128, 257, 500, 640, 1000, 1024], device=dev,
                           dtype=torch.int32)
    live = lengths > 0

    def k5_case(gen, hkv, page, bits, qdt=bf16):
        cache, _ = random_paged_cache(10 + hkv + page + bits, lengths.tolist(), hkv,
                                      page, bits, pps=1024 // page)
        rect = dataclasses.replace(cache, step_slot=None, step_page=None)
        q = torch.randn((8, 32, 1, 128), generator=gen, device=dev).to(bf16).to(qdt)
        ref = paged_attention_reference(q, cache, lengths, compute_dtype=bf16)
        for entry, c in (("rectangular", rect), ("ragged", cache)):
            fn = paged_decode_attention if entry == "rectangular" \
                else paged_decode_attention_ragged
            got = fn(q, c, lengths)
            e = record("paged_decode_attention", got[live], ref[live], entry=entry,
                       hkv=hkv, page=page, bits=bits, q_dtype=str(qdt), tol=5e-3)
            if not (got.dtype == qdt and excess(got[live], ref[live], 2 ** -7) <= 5e-3
                    and not bool(got[~live].any())):
                raise AssertionError(f"K5 {entry} hkv={hkv} page={page} bits={bits} "
                                     f"q {qdt}: max err {e}")

    def k6_case(gen, hkv, page, bits, offs, qdt=bf16):
        c = 256
        lens = torch.tensor([o + c for o in offs], device=dev, dtype=torch.int32)
        cache, _ = random_paged_cache(20 + hkv + bits + offs[0], lens.tolist(), hkv,
                                      page, bits, pps=1024 // page)
        q = torch.randn((len(offs), 32, c, 128), generator=gen, device=dev).to(bf16).to(qdt)
        off = offs[0] if len(offs) == 1 else torch.tensor(offs, device=dev)
        got = paged_context_attention(q, cache, lens, off)
        ref = paged_context_attention_reference(q, cache, lens, off, compute_dtype=bf16)
        e = record("paged_context_attention", got, ref, b=len(offs), offsets=offs,
                   hkv=hkv, page=page, bits=bits, q_dtype=str(qdt), tol=5e-3)
        if not (got.dtype == qdt and excess(got, ref, 2 ** -7) <= 5e-3):
            raise AssertionError(f"K6 offsets={offs} hkv={hkv} page={page} bits={bits} "
                                 f"q {qdt}: max err {e}")

    for hkv in (32, 8):
        for page in (128, 32):
            for bits in (8, 4):
                k5_case(g, hkv, page, bits)
    for bits in (8, 4):
        for hkv in (32, 8):
            for offs in ([0], [768], [300], [0, 768, 300, 129]):
                k6_case(g, hkv, 128, bits, offs)
    for hkv in (32, 8):
        for bits in (8, 4):
            k5_case(g16, hkv, 16, bits)
            for page in (16, 32):
                for offs in ([768], [0, 768, 300, 129]):
                    k6_case(g16, hkv, page, bits, offs)
    k5_case(g16, 8, 16, 4, torch.float32)
    k6_case(g16, 8, 16, 4, [0, 768, 300, 129], torch.float32)
    k5_case(g16, 8, 128, 8, torch.float16)
    k6_case(g16, 8, 32, 8, [0, 768, 300, 129], torch.float16)
    k6_verify_checks(record)


# K6 at the speculative verify chunk's shapes: C = gamma + 1 rows (gamma 1,
# 4 and 8) for 8 slots at unaligned per-slot offsets, some straddling a
# page edge within the chunk, one at 0 and one at the end of a 1,024-row
# table
VERIFY_ROWS = (2, 5, 9)
VERIFY_OFFSETS = (0, 126, 127, 255, 300, 511, 777, 1015)


def k6_verify_checks(record) -> None:
    """K6 against its plain version at the verify chunk's shapes
    (``VERIFY_ROWS`` x ``VERIFY_OFFSETS``), pages of 128 and 32, int8 and
    int4 pools, MHA and GQA (Hkv 32 and 8), by ``paged_parity``'s rule, on a
    generator of their own (the older checks keep their draws)."""
    from qgemm_tpu_torch.ops.cuda.paged_context_attention import paged_context_attention
    from qgemm_tpu_torch.serving.paged_cache import paged_context_attention_reference
    dev, bf16 = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(45)
    offs = torch.tensor(VERIFY_OFFSETS, device=dev)
    for c in VERIFY_ROWS:
        lens = (offs + c).to(torch.int32)
        for page in (128, 32):
            for bits in (8, 4):
                for hkv in (32, 8):
                    cache, _ = random_paged_cache(60 + c + page + bits + hkv, lens.tolist(),
                                                  hkv, page, bits, pps=-(-1024 // page))
                    q = torch.randn((len(VERIFY_OFFSETS), 32, c, 128), generator=gen,
                                    device=dev).to(bf16)
                    got = paged_context_attention(q, cache, lens, offs)
                    ref = paged_context_attention_reference(q, cache, lens, offs,
                                                            compute_dtype=bf16)
                    e = record("paged_context_attention", got, ref, b=len(VERIFY_OFFSETS),
                               rows=c, offsets=list(VERIFY_OFFSETS), hkv=hkv, page=page,
                               bits=bits, q_dtype=str(bf16), tol=5e-3, verify_chunk=True)
                    if not excess(got, ref, 2 ** -7) <= 5e-3:
                        raise AssertionError(f"K6 verify chunk C={c} hkv={hkv} page={page} "
                                             f"bits={bits}: max err {e}")


def reporter() -> tuple:
    """(a ``record`` function for the parity checks, the list it fills)."""
    report = []

    def record(name, got, ref, **row):
        report.append(dict(kernel=name, max_abs_err=max_err(got, ref),
                           max_rel_err=rel_err(got, ref), **row))
        return report[-1]["max_abs_err"]

    return record, report


def phase_paged() -> None:
    """K5 and K6 alone: ``paged_parity`` and ``k6_edge_checks`` (a short
    first run of changed paged kernels, through ``--only paged``)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    record, report = reporter()
    paged_parity(g, record)
    edges = k6_edge_checks(record)
    torch.cuda.synchronize()
    emit({"phase": "paged", "checks": report, "k6_edges": edges})


def phase_k2() -> None:
    """K2 alone: ``k2_parity`` and ``k2_k5_checks`` (through ``--only k2``)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    record, report = reporter()
    k2_parity(g, record)
    k2_k5_checks(record)
    torch.cuda.synchronize()
    emit({"phase": "k2", "checks": report})


# q draws of K6's edge case (``k6_edge_checks``), found by a search of
# seeds 0-255 on the H100 with the first (SIMT) K6: 31 of the 256 draws
# exceeded the parity rule; 44 by the most (excess 0.0075) and 5 among
# them, 68 passed it with the kernel furthest off the float64 result
# (0.0099, the plain version 0.0076). The mma.sync K6 normalizes a chunk's
# first causal rows before rounding, as the plain version does: in the
# same search every draw passes the rule (worst excess 0.0027, seed 29),
# the kernel as far from float64 as the plain version on each.
K6_EDGE_SEEDS = (5, 44, 68)


def paged_context_f64(q, cache, lens, offset: int) -> torch.Tensor:
    """K6's chunk attention in float64 (one slot, an int offset): the result
    without any of the kernel's or the plain version's bf16 roundings."""
    from qgemm_tpu_torch.serving.paged_cache import gather_slot_kv
    kq, kc, vq, vc = (t.double() for t in gather_slot_kv(cache))
    b, hq, c, d = q.shape
    hkv, s = kq.shape[1], kq.shape[2]
    qg = q.double().reshape(b, hkv, hq // hkv * c, d)
    pos = torch.arange(c, device=q.device).repeat(hq // hkv)[:, None] + offset
    kj = torch.arange(s, device=q.device)[None, :]
    valid = (kj <= pos) & (kj < lens.to(q.device)[:, None, None, None])
    sc = torch.matmul(qg, kq.transpose(-1, -2)) * (kc[..., 0] / (127 * math.sqrt(d)))[:, :, None]
    p = torch.softmax(sc.masked_fill(~valid, float("-inf")), dim=-1)
    o = torch.matmul(p * (vc[..., 0] / 127)[:, :, None], vq.double())
    return o.reshape(b, hq, c, d)


def k6_edge_case(seed: int, record=None) -> dict:
    """K6 at the parity phase's case offsets [0], Hkv 8, int8 pool, C 256 (the
    same cache), q drawn from ``seed``: the parity rule's error beyond 2^-7
    relative against the plain version, and the kernel's and the plain
    version's max errors against ``paged_context_f64``, over all rows and
    over the chunk's first 16 causal rows. ``record(name, got, ref,
    **row)`` takes the kernel's error against the plain version."""
    from qgemm_tpu_torch.ops.cuda.paged_context_attention import paged_context_attention
    from qgemm_tpu_torch.serving.paged_cache import paged_context_attention_reference
    c, hkv, bits = 256, 8, 8
    lens = torch.tensor([c], device="cuda", dtype=torch.int32)
    cache, _ = random_paged_cache(20 + hkv + bits, lens.tolist(), hkv, 128, bits, pps=8)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q = torch.randn((1, 32, c, 128), generator=g, device="cuda").to(torch.bfloat16)
    got = paged_context_attention(q, cache, lens, 0)
    ref = paged_context_attention_reference(q, cache, lens, 0, compute_dtype=torch.bfloat16)
    if record is not None:
        record("paged_context_attention", got, ref, b=1, offsets=[0], hkv=hkv, bits=bits,
               seed=seed, tol=5e-3)
    x = paged_context_f64(q, cache, lens, 0)
    err = lambda a, rows: float((a[:, :, rows].double() - x[:, :, rows]).abs().max())
    first = slice(0, 16)
    return {"seed": seed, "excess": excess(got, ref, 2 ** -7), "max_abs_err": max_err(got, ref),
            "kernel_vs_f64": err(got, slice(None)), "plain_vs_f64": err(ref, slice(None)),
            "kernel_vs_f64_first16": err(got, first), "plain_vs_f64_first16": err(ref, first)}


def k6_draws(n: int) -> None:
    """``k6_edge_case`` on the q draws of seeds 0 to n - 1 (how
    ``K6_EDGE_SEEDS`` were found): one JSON line per draw, then the draws
    past the parity rule and the largest errors."""
    rows = [k6_edge_case(seed) for seed in range(n)]
    for r in rows:
        emit(dict(phase="k6_draw", **r))
    emit({"phase": "k6_draws", "n": n,
          "past_rule": [r["seed"] for r in rows if r["excess"] > 5e-3],
          "worst_excess": max(rows, key=lambda r: r["excess"]),
          **{f"{key}_range": [min(r[key] for r in rows), max(r[key] for r in rows)]
             for key in ("kernel_vs_f64", "plain_vs_f64")},
          "max_kernel_minus_plain_vs_f64": max(r["kernel_vs_f64"] - r["plain_vs_f64"]
                                               for r in rows),
          "max_is_in_first16": all(r["kernel_vs_f64_first16"] == r["kernel_vs_f64"]
                                   and r["plain_vs_f64_first16"] == r["plain_vs_f64"]
                                   for r in rows)})


def k6_edge_checks(record) -> list:
    """K6's parity case offsets [0], Hkv 8, int8 pool on the q draws of
    ``K6_EDGE_SEEDS`` (``k6_edge_case``). The chunk's first causal rows
    attend a few keys, so P is O(1) and one bf16 rounding flip of P moves an
    output of |o| ~ 1 by a bf16 step (2^-7), as in K7's short causal rows
    (``flash_edge_checks``). A draw passes the parity rule (beyond 2^-7
    relative at most 5e-3), or, past it, only if the kernel's max error
    against the float64 result is no larger than the plain version's plus
    5e-3: the kernel is as exact as the plain version. Returns each draw's
    errors; raises on a draw that fails both."""
    rows = []
    for seed in K6_EDGE_SEEDS:
        r = k6_edge_case(seed, record)
        r["held_by_f64"] = r["excess"] > 5e-3
        rows.append(r)
        if r["held_by_f64"] and not r["kernel_vs_f64"] <= r["plain_vs_f64"] + 5e-3:
            raise AssertionError(f"K6 edge draw {seed}: {r}")
    return rows


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape, dtype and bytes (f32 compared as int32 bit patterns)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


GEMV_ROWS = tuple(range(1, 17))    # the rows the decode GEMVs take


def gemv_checks(tag: str, fn, x: torch.Tensor, where: dict) -> None:
    """The decode GEMV against the m > 16 tile kernel on the card: for every
    m in 1-16, ``fn(x[:m])`` must equal, bit for bit, rows [0, m) of ``fn``
    on the same rows stacked with zero rows to 17 along the row axis (dim
    -2), which runs the tile kernel. Both sum exact int32 products of the
    same pre-pass codes and take the same f32 epilogue (K1, K8) or group
    fold (K4), so a row's result does not depend on the route."""
    for m in GEMV_ROWS:
        xm = x.narrow(-2, 0, m)
        pad = list(xm.shape)
        pad[-2] = 17 - m
        tile = fn(torch.cat([xm, xm.new_zeros(pad)], dim=-2)).narrow(-2, 0, m)
        got = fn(xm)
        if not bits_equal(got, tile):
            raise AssertionError(f"{tag} GEMV at m={m} {where}: not bit-equal to the m > 16 "
                                 f"kernel's rows (max err {max_err(got, tile)})")


def gemv_parity(record) -> None:
    """The decode GEMVs at every m (K8: C) in 1-16, on a generator of their
    own (the other checks keep their inputs): K1 and K4 at the GPT_6_7B
    decode shapes and a ragged n 4100 (no multiple of a column tile) within
    the K1/K4 parity tolerance of their plain versions, K8 at the MoE
    products (E 8, f32 and bf16 x, one expert empty) bit-equal to its plain
    version, and each bit-equal to the m > 16 tile kernel (``gemv_checks``).
    K4's first K slab is 8x larger, so per-slab scales differ within a row."""
    from qgemm_tpu_torch.ops.cuda.col_quantize import col_quantize
    from qgemm_tpu_torch.ops.cuda.expert_matmul import (grouped_quantized_matmul,
                                                        grouped_quantized_matmul_plain)
    from qgemm_tpu_torch.ops.quantize import (quantize_weights, quantize_weights_int4,
                                              quantized_matmul_plain, quantized_matmul_prequant,
                                              quantized_matmul_prequant_w4, w4a8_matmul_plain)
    g = torch.Generator(device="cuda")
    g.manual_seed(9)
    for k, n in GEMM_SHAPES + [(4096, 4100)]:
        w = torch.randn((k, n), generator=g, device="cuda") * 0.02
        wq, wq4 = quantize_weights(w), quantize_weights_int4(w)
        del w
        x = torch.randn((16, k), generator=g, device="cuda")
        x4 = x.clone()
        x4[:, :2048] *= 8.0
        for name, tag, xx, fn, plain in (
                ("quantized_matmul", "K1", x.to(torch.bfloat16),
                 lambda a: quantized_matmul_prequant(a, wq),
                 lambda a: quantized_matmul_plain(a, wq)),
                ("w4a8_matmul", "K4", x4.to(torch.bfloat16),
                 lambda a: quantized_matmul_prequant_w4(a, wq4),
                 lambda a: w4a8_matmul_plain(a, wq4))):
            for m in GEMV_ROWS:
                got, ref = fn(xx[:m]), plain(xx[:m])
                tol = 1e-6 * float(ref.abs().max())
                e = record(name, got, ref, m=m, k=k, n=n, tol=tol, gemv=True)
                if not e <= tol:
                    raise AssertionError(f"{tag} m={m} k={k} n={n}: max err {e} > {tol}")
            gemv_checks(tag, fn, xx, dict(k=k, n=n))
        del wq, wq4, x, x4
    e = MOE_CFG["n_experts"]
    for k, n in MOE_GEMMS:
        wt, cw = col_quantize(torch.randn((e, k, n), generator=g, device="cuda") * 0.02)
        relu = k == MOE_CFG["d_model"]
        for dt in ("float32", "bfloat16"):
            x = torch.randn((e, 16, k), generator=g, device="cuda").to(getattr(torch, dt))
            x[5] = 0.0
            for c in GEMV_ROWS:
                got = grouped_quantized_matmul(x[:, :c], wt, cw, relu=relu)
                ref = grouped_quantized_matmul_plain(x[:, :c], wt, cw, relu=relu)
                err = record("expert_matmul", got, ref, e=e, c=c, k=k, n=n, x_dtype=dt,
                             relu=relu, tol=0.0, gemv=True)
                if not bits_equal(got, ref):
                    raise AssertionError(f"K8 c={c} k={k} n={n} {dt}: not bit-equal to its "
                                         f"plain version (max err {err})")
            gemv_checks("K8", lambda a: grouped_quantized_matmul(a, wt, cw, relu=relu), x,
                        dict(e=e, k=k, n=n, x_dtype=dt))
        del wt, cw


def k8_tile_checks(record) -> None:
    """K8 on its tile kernel at the MoE model's products (``MOE_GEMMS``, E 8)
    and C 17, 168 and 328 (the smallest tile route and the capacities of
    512- and 1024-token prefills), f32 and bf16 x, one expert empty, on a
    generator of its own: bit-equal to its plain version, and each expert's
    first rows bit-equal across C and across routes (C 1 and 8 run the
    GEMV)."""
    from qgemm_tpu_torch.ops.cuda.col_quantize import col_quantize
    from qgemm_tpu_torch.ops.cuda.expert_matmul import (grouped_quantized_matmul,
                                                        grouped_quantized_matmul_plain)
    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    e = MOE_CFG["n_experts"]
    for k, n in MOE_GEMMS:
        wt, cw = col_quantize(torch.randn((e, k, n), generator=g, device="cuda") * 0.02)
        relu = k == MOE_CFG["d_model"]
        for dt in ("float32", "bfloat16"):
            x = torch.randn((e, K8_TILE_ROWS[-1], k), generator=g, device="cuda")
            x[5] = 0.0
            x = x.to(getattr(torch, dt))
            first = None
            for c in (1, 8) + K8_TILE_ROWS:
                got = grouped_quantized_matmul(x[:, :c], wt, cw, relu=relu)
                if c > 8:
                    ref = grouped_quantized_matmul_plain(x[:, :c], wt, cw, relu=relu)
                    err = record("expert_matmul", got, ref, e=e, c=c, k=k, n=n, x_dtype=dt,
                                 relu=relu, tol=0.0)
                    if not (bits_equal(got, ref) and not bool(got[5].any())):
                        raise AssertionError(f"K8 c={c} k={k} n={n} {dt}: not bit-equal to its "
                                             f"plain version (max err {err}) or the empty "
                                             f"expert not 0")
                if first is None:
                    first = got[:, :1]
                elif not bits_equal(got[:, :1], first):
                    raise AssertionError(f"K8 k={k} n={n} {dt}: first rows differ between "
                                         f"C=1 and C={c}")
        del wt, cw


def k8_k9_checks(g: torch.Generator, record) -> None:
    """K8 and K9 against their plain versions, bit for bit (both compute
    the same f32 steps; K8's int32 sums are exact, and its plain version
    sums in float64 on the card, exact for K * 127^2 < 2^53). K8 at the MoE
    model's products (``MOE_GEMMS``, E 8): decode C 8 with f32 and bf16
    x, five of eight rows empty in every expert and one expert all empty
    (as most capacity rows are at a decode step: 16 choices over 64 slots);
    prefill C 168 and 328; the up product with its fused ReLU. K9:
    ``k9_checks``."""
    from qgemm_tpu_torch.ops.cuda.col_quantize import col_quantize
    from qgemm_tpu_torch.ops.cuda.expert_matmul import (grouped_quantized_matmul,
                                                        grouped_quantized_matmul_plain)
    e = MOE_CFG["n_experts"]
    for k, n in MOE_GEMMS:
        wt, cw = col_quantize(torch.randn((e, k, n), generator=g, device="cuda") * 0.02)
        relu = k == MOE_CFG["d_model"]
        for c, dt in ((8, "float32"), (8, "bfloat16"), (168, "float32"), (328, "float32")):
            x = torch.randn((e, c, k), generator=g, device="cuda")
            if c == 8:
                x[:, 3:] = 0.0
                x[5] = 0.0
            x = x.to(getattr(torch, dt))
            got = grouped_quantized_matmul(x, wt, cw, relu=relu)
            ref = grouped_quantized_matmul_plain(x, wt, cw, relu=relu)
            err = record("expert_matmul", got, ref, e=e, c=c, k=k, n=n, x_dtype=dt,
                         relu=relu, tol=0.0)
            empty_ok = c != 8 or not bool(got[:, 3:].any() or got[5].any())
            if not (bits_equal(got, ref) and empty_ok and bool(torch.isfinite(got).all())):
                raise AssertionError(f"K8 c={c} k={k} n={n} {dt}: not bit-equal to its plain "
                                     f"version (max err {err}) or empty rows not 0")
        del wt, cw
    k9_checks(g, record)


# K9's shapes past the cluster route's K (CLUSTER_MAX_K): the two_pass route
K9_TWO_PASS_SHAPES = (((16384, 96), "float32"), ((2, 20000, 200), "bfloat16"))


def k9_checks(g: torch.Generator, record) -> None:
    """K9 against its plain version, bit for bit: at the expert weights
    ([8, 2048, 4096] and [8, 4096, 2048] bf16) and the dynamic GEMM's 2048^2
    f32 (the cluster route, clusters of 8), both roundings; then, on a
    generator of its own (the other checks keep their draws), at
    ``K9_TWO_PASS_SHAPES`` (the two_pass route) and on a weight with a NaN
    column and +inf and -inf columns: the scales must be equal bit for bit
    where finite, inf where the plain version's are and NaN where its amax
    is (the NaN's payload may differ), and the codes of the finite columns
    bit for bit; the non-finite columns' codes are recorded (torch's cast
    of NaN to int8 is undefined; the kernel writes 0)."""
    from qgemm_tpu_torch.ops.cuda.col_quantize import col_quantize, col_quantize_plain
    from qgemm_tpu_torch.ops.cuda.quant_plan import col_quantize_plan
    e = MOE_CFG["n_experts"]
    routes = set()

    def held(w, dt, rounding, **row):
        qt, c = col_quantize(w, rounding)
        rq, rc = col_quantize_plain(w, rounding)
        shape = list(w.shape)
        p = col_quantize_plan(*((1, *shape) if w.ndim == 2 else shape), dt)
        routes.add(p["route"])
        fin = torch.isfinite(c) & torch.isfinite(rc)   # the NaN/inf case's scales apart
        err = record("col_quantize", qt.float(), rq.float(), shape=shape, dtype=dt,
                     rounding=rounding, route=p["route"], cluster=p["cluster"],
                     scales_max_abs_err=max_err(c[fin], rc[fin]), tol=0.0, **row)
        return qt, c, rq, rc, err

    for shape, dt in (((e, 2048, 4096), "bfloat16"), ((e, 4096, 2048), "bfloat16"),
                      ((2048, 2048), "float32")):
        w = (torch.randn(shape, generator=g, device="cuda") * 0.02).to(getattr(torch, dt))
        for rounding in ("nearest", "truncate"):
            qt, c, rq, rc, err = held(w, dt, rounding)
            if not (bits_equal(qt, rq) and bits_equal(c, rc)):
                raise AssertionError(f"K9 {shape} {dt} {rounding}: not bit-equal to its "
                                     f"plain version (codes max err {err}, scales "
                                     f"{max_err(c, rc)})")
        del w
    g9 = torch.Generator(device="cuda")
    g9.manual_seed(9)
    for shape, dt in K9_TWO_PASS_SHAPES:
        w = (torch.randn(shape, generator=g9, device="cuda") * 0.02).to(getattr(torch, dt))
        for rounding in ("nearest", "truncate"):
            qt, c, rq, rc, err = held(w, dt, rounding)
            if not (bits_equal(qt, rq) and bits_equal(c, rc)):
                raise AssertionError(f"K9 {shape} {dt} {rounding} (two_pass): not bit-equal "
                                     f"to its plain version (codes max err {err})")
        del w
    if routes != {"cluster", "two_pass"}:
        raise AssertionError(f"K9's checks took the routes {routes}, not both")
    for dt in ("float32", "bfloat16"):
        w = torch.randn((2048, 256), generator=g9, device="cuda") * 0.02
        w[5, 3], w[700, 7], w[9, 9] = float("nan"), float("inf"), float("-inf")
        w = w.to(getattr(torch, dt))
        bad = torch.zeros(256, dtype=torch.bool, device="cuda")
        bad[[3, 7, 9]] = True
        for rounding in ("nearest", "truncate"):
            qt, c, rq, rc, err = held(w[None], dt, rounding, case="nan_inf_columns")
            # equal bits, but any NaN for a NaN: the NaN's payload is not
            # part of the function (torch's amax and the kernel's max pick
            # different ones)
            scales_equal = (bits_equal(c[..., ~bad], rc[..., ~bad])
                            and torch.equal(torch.isnan(c), torch.isnan(rc))
                            and torch.equal(c[~torch.isnan(c)], rc[~torch.isnan(rc)]))
            emit({"phase": "k9_nonfinite", "dtype": dt, "rounding": rounding,
                  "scales_equal_nan_as_nan": scales_equal,
                  "scales_equal_bits": bits_equal(c, rc),
                  "scales_nonfinite": [str(v) for v in c[0, 0, bad].tolist()],
                  "scale_bits_nonfinite": {
                      "kernel": [f"{v:#010x}" for v in c[0, 0, bad].view(torch.int32).tolist()],
                      "plain": [f"{v:#010x}" for v in rc[0, 0, bad].view(torch.int32).tolist()]},
                  "finite_columns_codes_equal": bits_equal(qt[0][~bad], rq[0][~bad]),
                  "all_codes_equal": bits_equal(qt, rq),
                  "nonfinite_columns_codes": {"kernel_nonzero": int(qt[0][bad].ne(0).sum()),
                                              "plain_nonzero": int(rq[0][bad].ne(0).sum())}})
            if not (scales_equal and bits_equal(qt[0][~bad], rq[0][~bad])):
                raise AssertionError(f"K9 {dt} {rounding} with NaN/inf columns: the scales "
                                     f"or the finite columns' codes differ from the plain "
                                     f"version's")


def phase_k9() -> None:
    """``k9_checks`` alone (``--only k9``), on a generator of its own."""
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    rows = []

    def record(name, got, ref, **row):
        e = max_err(got, ref)
        rows.append(dict(kernel=name, max_abs_err=e, **row))
        return e

    k9_checks(g, record)
    emit({"phase": "k9", "checks": rows})


# K7 parity cases (B, H, Sq, Sk, D, causal, dtype): the training slice's
# shape first, then ragged lengths (not multiples of the 64-row blocks and
# tiles, nor of the f32 route's 32-row tiles), Sq != Sk both ways, float32,
# head_dim 64
K7_CASES = [(4, 32, 2048, 2048, 128, True, "bfloat16"),
            (1, 8, 200, 200, 128, True, "bfloat16"),
            (1, 8, 72, 200, 128, False, "bfloat16"),
            (1, 8, 72, 200, 128, True, "bfloat16"),
            (1, 8, 200, 72, 128, True, "bfloat16"),
            (1, 8, 300, 300, 128, True, "float32"),
            (2, 4, 333, 333, 64, True, "bfloat16"),
            (1, 8, 130, 97, 64, False, "float32")]


def k3_checks(g: torch.Generator, record) -> None:
    """Kernel K3 (bf16, the tensor-core route) against its plain version at
    GPT_6_7B's heads. Tolerances: bf16 O rounds once on each side (2^-7
    relative), p rounds to bf16 relative to a running max (rare one-ulp
    flips, atol 1e-2); lse sums unrounded p in f32 (atol 1e-4)."""
    from qgemm_tpu_torch.ops.cuda.flash_attention import (flash_attention_fwd,
                                                          flash_attention_plain)
    for sq, causal in [(8, True), (300, True), (512, True), (2048, True), (300, False)]:
        q, k, v = (torch.randn((1, 32, sq, 128), generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        ro, rl = flash_attention_plain(q, k, v, causal=causal)
        el = max_err(lse, rl)
        e = record("flash_attention", o, ro, sq=sq, causal=causal,
                   lse_max_abs_err=el, tol=1e-2)
        if not (excess(o, ro, 2 ** -7) <= 1e-2 and el <= 1e-4):
            raise AssertionError(f"K3 sq={sq} causal={causal}: O err {e}, lse err {el}")


def k7_checks(g: torch.Generator, record) -> None:
    """Kernel K7 against its plain version at ``K7_CASES``, then the
    differentiable ``flash_attention`` (K3 forward + K7 backward) against
    torch autograd through ``scaled_dot_product_attention`` in float32, MHA
    and a GQA model's repeated heads (dK/dV summed back over each group).

    Tolerances: bf16 dQ/dK/dV round once on each side (2^-7 relative), and
    P and dS round to bf16 at the same points on both sides from f32 values
    summed in different orders, so an entry can land one bf16 ulp apart:
    the error beyond 2^-7 relative must stay under 1e-3 * max|ref|. f32:
    summation order and expf over at most 2048 terms, |err| <= 1e-5 *
    max|ref|. Against SDPA (another algorithm, its own summation order and
    exp): |err| <= 1e-4 * max|ref|."""
    import torch.nn.functional as F

    from qgemm_tpu_torch.ops.cuda.flash_attention import flash_attention, flash_attention_fwd
    from qgemm_tpu_torch.ops.cuda.flash_attention_bwd import (flash_attention_bwd,
                                                              flash_attention_bwd_plain)
    for b, h, sq, sk, d, causal, dt in K7_CASES:
        dtype = getattr(torch, dt)
        q = torch.randn((b, h, sq, d), generator=g, device="cuda").to(dtype)
        k, v = (torch.randn((b, h, sk, d), generator=g, device="cuda").to(dtype)
                for _ in range(2))
        dout = torch.randn((b, h, sq, d), generator=g, device="cuda").to(dtype)
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        got = flash_attention_bwd(q, k, v, o, lse, dout, causal)
        ref = flash_attention_bwd_plain(q, k, v, o, lse, dout, causal)
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            scale = float(r.float().abs().max())
            if dt == "bfloat16":
                tol, beyond = 1e-3 * scale, excess(a, r, 2 ** -7)
            else:
                tol, beyond = 1e-5 * scale, max_err(a, r)
            e = record("flash_attention_bwd", a, r, grad=name, b=b, h=h, sq=sq, sk=sk, d=d,
                       causal=causal, dtype=dt, tol=tol, excess=beyond)
            if not (beyond <= tol and bool(torch.isfinite(a).all())):
                raise AssertionError(f"K7 {name} b={b} h={h} sq={sq} sk={sk} d={d} "
                                     f"causal={causal} {dt}: max err {e}, beyond the "
                                     f"allowance {beyond} > {tol}")
        del q, k, v, dout, o, lse, got, ref
        torch.cuda.empty_cache()

    for hq, hkv, s_len, d in ((8, 8, 300, 128), (8, 2, 257, 64)):
        q = torch.randn((2, hq, s_len, d), generator=g, device="cuda", requires_grad=True)
        k, v = (torch.randn((2, hkv, s_len, d), generator=g, device="cuda",
                            requires_grad=True) for _ in range(2))
        w = torch.randn((2, hq, s_len, d), generator=g, device="cuda")
        rep = lambda t: torch.repeat_interleave(t, hq // hkv, dim=1)
        got = torch.autograd.grad((flash_attention(q, rep(k), rep(v), True) * w).sum(),
                                  (q, k, v))
        ref = torch.autograd.grad((F.scaled_dot_product_attention(
            q, rep(k), rep(v), is_causal=True) * w).sum(), (q, k, v))
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            tol = 1e-4 * float(r.abs().max())
            e = record("flash_attention_autograd", a, r, grad=name, check="vs_sdpa_f32",
                       hq=hq, hkv=hkv, s=s_len, d=d, tol=tol)
            if not e <= tol:
                raise AssertionError(f"flash_attention autograd {name} hq={hq} hkv={hkv}: "
                                     f"max err {e} > {tol} against SDPA")


def decode_row(rows: list) -> dict:
    """The timing row at m 8, k 4096, n 16384: the FFN-up GEMM of a decode step."""
    return next(r for r in rows if (r["m"], r["k"], r["n"]) == (8, 4096, 16384))


def phase_timing(errs: dict) -> dict:
    """Kernel, plain-version and library device times at the main path's
    shapes: bench_ms, the median of 20 calls queued back to back behind a
    device sleep, each between its own CUDA events, L2 flushed by a read
    before each."""
    from qgemm_tpu_torch.ops.cuda.decode_attention import (decode_attention,
                                                           decode_attention_plain)
    from qgemm_tpu_torch.ops.kv_cache import quantize_kv
    from qgemm_tpu_torch.ops.quantize import (absmax_quantize, dequantize, quantize_weights,
                                              quantize_weights_int4, quantized_matmul_plain,
                                              quantized_matmul_prequant,
                                              quantized_matmul_prequant_w4, w4a8_matmul_plain)
    from qgemm_tpu_torch.utils.profiling import bench_ms
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    out = {}

    def int_mm_pipeline(x, wq):
        """One library pipeline for K1's function: torch row-quantize,
        torch._int_mm (m padded to >= 17), dequant."""
        m = x.shape[0]
        xq, cx = absmax_quantize(x.float(), axis=-1)
        if m < 17:
            xq = torch.cat([xq, xq.new_zeros((17 - m, xq.shape[1]))])
        acc = torch._int_mm(xq, wq.q)[:m]
        return dequantize(acc, cx, wq.c)

    k1_rows = []
    for m in TIMING_ROWS:
        for k, n in GEMM_SHAPES:
            wq = quantize_weights(torch.randn((k, n), generator=g, device=dev) * 0.02)
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            ms = bench_ms(lambda: quantized_matmul_prequant(x, wq))
            plain = bench_ms(lambda: quantized_matmul_plain(x, wq))
            try:
                lib = bench_ms(lambda: int_mm_pipeline(x, wq))
            except RuntimeError as e:   # layout or shape the library refuses
                print(f"torch._int_mm unavailable at m={m} k={k} n={n}: {e}",
                      file=sys.stderr)
                lib = None
            row = {}
            if m > 16:   # cuBLAS's int8 product alone, no quantize, no dequant
                xq = absmax_quantize(x.float(), axis=-1)[0]
                row["int_mm_alone_ms"] = bench_ms(lambda: torch._int_mm(xq, wq.q))
                del xq
            bms, by = bound(m * k * 2 + k * n + n * 4 + m * n * 4, 2 * m * n * k, INT8_OPS)
            k1_rows.append({"m": m, "k": k, "n": n, "ms": ms, "plain_ms": plain,
                            "library_ms": lib, **row, "bound_ms": bms, "bound_by": by,
                            "share_of_bound": bms / ms})
            del wq, x
    emit({"phase": "timing_k1_shapes", "rows": k1_rows})
    head = decode_row(k1_rows)
    out["quantized_matmul"] = dict(head, **errs["quantized_matmul"],
                                   shape=f"m={head['m']} k={head['k']} n={head['n']}")

    # K4 with K1 beside it at the same shape (the int8 point of comparison,
    # not a yardstick: K1 computes another function). No single PyTorch
    # call computes W4A8: torch._weight_int4pack_mm takes bf16 activations
    # (A16W4), so library_ms is null.
    k4_rows = []
    for m in TIMING_ROWS:
        for k, n in GEMM_SHAPES:
            w = torch.randn((k, n), generator=g, device=dev) * 0.02
            wq4, wq = quantize_weights_int4(w), quantize_weights(w)
            del w
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            ms = bench_ms(lambda: quantized_matmul_prequant_w4(x, wq4))
            # the plain version launches ~8 kernels per 128-row group:
            # more than the launch queue holds, so timed without the sleep
            plain = bench_ms(lambda: w4a8_matmul_plain(x, wq4), queue_ahead=False)
            k1 = bench_ms(lambda: quantized_matmul_prequant(x, wq))
            bms, by = bound(m * k * 2 + k * n // 2 + (k // 128) * n * 4 + m * n * 4,
                            2 * m * n * k, INT8_OPS)
            k4_rows.append({"m": m, "k": k, "n": n, "ms": ms, "plain_ms": plain,
                            "library_ms": None, "bound_ms": bms, "bound_by": by,
                            "share_of_bound": bms / ms, "k1_ms": k1})
            del wq4, wq, x
    emit({"phase": "timing_k4_shapes", "rows": k4_rows})
    head = decode_row(k4_rows)
    out["w4a8_matmul"] = dict(head, **errs["w4a8_matmul"],
                              shape=f"m={head['m']} k={head['k']} n={head['n']}")

    out.update(k8_k9_timing(g, errs))

    b, h, s, d = 8, 32, 1024, 128
    lengths = torch.tensor([150, 210, 260, 330, 400, 450, 500, 550], device=dev,
                           dtype=torch.int32)
    q = torch.randn((b, h, 1, d), generator=g, device=dev).to(torch.bfloat16)
    (kq, kc), (vq, vc) = (quantize_kv(torch.randn((b, h, s, d), generator=g, device=dev))
                          for _ in range(2))
    ms = bench_ms(lambda: decode_attention(q, kq, vq, lengths, kc=kc, vc=vc))
    plain = bench_ms(lambda: decode_attention_plain(q, kq, vq, lengths, kc=kc, vc=vc))
    tot = int(lengths.sum())
    bms, by = bound(b * h * d * 2 * 2 + tot * h * (2 * d + 8), tot * h * 4 * d, BF16_FLOPS)
    out["decode_attention"] = {"ms": ms, "plain_ms": plain, "library_ms": None,
                               "bound_ms": bms, "bound_by": by,
                               **errs["decode_attention"],
                               "shape": f"B={b} H={h} S={s} D={d} lengths={lengths.tolist()}"}

    out.update(phase_flash_timing(errs))

    # K5 at row 5's shape (K2's above), through the engine's ragged entry,
    # and K6 at one 256-row chunk after 768 resident positions, beside the
    # plain gather (JAX's default route for chunks). Bounds count, read
    # once, the K/V bytes the lengths need (``paged_kv_bytes``, as K2's
    # bound counts exact positions), q, the page table, the lengths and the
    # output; no single PyTorch call attends over a paged int8 pool, so
    # library_ms is null.
    from qgemm_tpu_torch.ops.cuda.paged_context_attention import paged_context_attention
    from qgemm_tpu_torch.ops.cuda.paged_decode_attention import paged_decode_attention_ragged
    from qgemm_tpu_torch.serving.paged_cache import (paged_attention_reference,
                                                     paged_context_attention_reference)
    no_library = "no single PyTorch call attends over a paged int8 or int4 pool"
    page, pps = 128, 8
    q = torch.randn((b, h, 1, d), generator=g, device=dev).to(torch.bfloat16)
    for bits in (8, 4):
        cache, resident = random_paged_cache(30 + bits, lengths.tolist(), h, page, bits, pps)
        ms = bench_ms(lambda: paged_decode_attention_ragged(q, cache, lengths))
        # the plain versions launch more kernels than the launch queue
        # holds ahead of bench_ms's sleep, so they are timed without it
        plain = bench_ms(lambda: paged_attention_reference(q, cache, lengths,
                                                           compute_dtype=torch.bfloat16),
                         queue_ahead=False)
        moved = 2 * b * h * d * 2 + b * (pps * 4 + 4) + paged_kv_bytes(
            lengths.tolist(), h, d, page, bits)
        bms, by = bound(moved, tot * h * 4 * d, BF16_FLOPS)
        key = "paged_decode_attention" if bits == 8 else "paged_decode_attention_int4"
        out[key] = {"ms": ms, "plain_ms": plain, "library_ms": None, "library_note": no_library,
                    "bound_ms": bms, "bound_by": by, "k2_ms_same_lengths":
                    out["decode_attention"]["ms"], "resident_pages": resident,
                    **errs["paged_decode_attention"],
                    "shape": f"B={b} H={h} D={d} page={page} kv_bits={bits} "
                             f"lengths={lengths.tolist()} (ragged entry)"}
        del cache
    out["decode_attention"]["k5_ms_same_lengths"] = out["paged_decode_attention"]["ms"]
    c, off = 256, 768
    q = torch.randn((1, h, c, d), generator=g, device=dev).to(torch.bfloat16)
    lens = torch.tensor([off + c], device=dev, dtype=torch.int32)
    pairs = c * off + c * (c + 1) // 2            # (row, attended position) pairs
    for bits in (8, 4):
        cache, resident = random_paged_cache(40 + bits, lens.tolist(), h, page, bits, pps)
        ms = bench_ms(lambda: paged_context_attention(q, cache, lens, off))
        plain = bench_ms(lambda: paged_context_attention_reference(
            q, cache, lens, off, compute_dtype=torch.bfloat16), queue_ahead=False)
        moved = 2 * c * h * d * 2 + pps * 4 + 8 + paged_kv_bytes(lens.tolist(), h, d, page, bits)
        bms, by = bound(moved, h * pairs * 4 * d, BF16_FLOPS)
        key = "paged_context_attention" if bits == 8 else "paged_context_attention_int4"
        out[key] = {"ms": ms, "plain_ms": plain, "library_ms": None, "library_note": no_library,
                    "bound_ms": bms, "bound_by": by, "resident_pages": resident,
                    **errs["paged_context_attention"],
                    "shape": f"B=1 H={h} C={c} D={d} offset={off} page={page} "
                             f"kv_bits={bits}"}
        del cache
    emit({"phase": "timing_paged", **{k: out[k] for k in out if k.startswith("paged")}})
    return out


def k8_k9_timing(g: torch.Generator, errs: dict) -> dict:
    """K8 at the MoE model's products (``MOE_GEMMS``, E 8) and
    ``k8_k9_checks``' shapes: decode C 8 (five of eight rows empty) with
    f32 x, as on the model path, and bf16 x; prefill C 168 and 328 (buckets
    of 512 and 1024 tokens); K9 at the expert weights and at
    2048^2 f32. Each beside its plain version and a yardstick: no single
    PyTorch call computes either function, so ``library_ms`` times a torch
    pipeline of the same function that the port never runs
    (``expert_int_mm_loop``, ``torch_col_quantize``). Bounds: each input
    read once and each output written once over 3.35 TB/s, or 2 * E * C *
    N * K int8 operations over 1,979 TOP/s."""
    from qgemm_tpu_torch.ops.cuda.col_quantize import col_quantize, col_quantize_plain
    from qgemm_tpu_torch.ops.cuda.expert_matmul import (grouped_quantized_matmul,
                                                        grouped_quantized_matmul_plain)
    from qgemm_tpu_torch.utils.profiling import bench_ms
    e = MOE_CFG["n_experts"]
    k8_rows = []
    for c, dt in ((8, "float32"), (8, "bfloat16"), (168, "float32"), (328, "float32")):
        for k, n in MOE_GEMMS:
            wt, cw = col_quantize(torch.randn((e, k, n), generator=g, device="cuda") * 0.02)
            x = torch.randn((e, c, k), generator=g, device="cuda")
            if c == 8:
                x[:, 3:] = 0.0
            x = x.to(getattr(torch, dt))
            relu = k == MOE_CFG["d_model"]
            ms = bench_ms(lambda: grouped_quantized_matmul(x, wt, cw, relu=relu))
            plain = bench_ms(lambda: grouped_quantized_matmul_plain(x, wt, cw, relu=relu))
            lib, lib_timing = bench_queued_or_not(lambda: expert_int_mm_loop(x, wt, cw))
            bms, by = bound(x.numel() * x.element_size() + e * n * k + e * n * 4 + e * c * n * 4,
                            2 * e * c * n * k, INT8_OPS)
            k8_rows.append({"e": e, "c": c, "k": k, "n": n, "x_dtype": dt, "ms": ms,
                            "plain_ms": plain,
                            "library_ms": lib, "library_timing": lib_timing,
                            "bound_ms": bms, "bound_by": by, "share_of_bound": bms / ms})
            del wt, cw, x
    emit({"phase": "timing_k8_shapes", "rows": k8_rows})
    k9_rows = []
    for shape, dt in (((e, 2048, 4096), "bfloat16"), ((e, 4096, 2048), "bfloat16"),
                      ((2048, 2048), "float32")):
        w = (torch.randn(shape, generator=g, device="cuda") * 0.02).to(getattr(torch, dt))
        ms = bench_ms(lambda: col_quantize(w))
        plain = bench_ms(lambda: col_quantize_plain(w))
        lib, lib_timing = bench_queued_or_not(lambda: torch_col_quantize(w))
        n_out = w.shape[-1] * (w.shape[0] if w.ndim == 3 else 1)
        bms, by = bound(w.numel() * w.element_size() + w.numel() + n_out * 4, 0, INT8_OPS)
        k9_rows.append({"shape": list(shape), "dtype": dt, "ms": ms, "plain_ms": plain,
                        "library_ms": lib, "library_timing": lib_timing, "bound_ms": bms,
                        "bound_by": by})
        del w
    emit({"phase": "timing_k9_shapes", "rows": k9_rows})
    head8, head9 = k8_rows[0], k9_rows[0]
    return {"expert_matmul": dict(head8, **errs["expert_matmul"],
                                  shape=f"E={e} C={head8['c']} K={head8['k']} "
                                        f"N={head8['n']} f32 x, ReLU (decode up)"),
            "col_quantize": dict(head9, **errs["col_quantize"],
                                 shape=f"{head9['shape']} {head9['dtype']} (w_up of "
                                       f"one MoE layer)")}


def phase_flash_timing(errs: Optional[dict] = None) -> dict:
    """K3 and K7 on the bf16 tensor-core route, at the main path's shapes:
    K3 at a prefill (B 1, H 32, S 512, D 128, causal: row 6's shape) and at
    the ``train`` phase's attention (B 4, H 32, S 2048), each at both query
    blocks of its plan (the plan's choice is its ``ms``); K7 at the
    ``train`` shape, split into its three kernels by one profiler trace.
    Each beside its plain version, SDPA (its forward, or its backward on a
    kept graph: yardsticks only), its bound and its achieved rate. Bounds:
    K3 two products and K7 five of 2 * D flops per attended (query, key)
    pair over 989 TFLOP/s (K7 runs seven, ``flash_attention_bwd.cu``'s
    note), against each input read once and each output written once over
    3.35 TB/s."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from qgemm_tpu_torch.ops.cuda.flash_attention import (flash_attention_fwd,
                                                          flash_attention_plain, flash_fwd_plan)
    from qgemm_tpu_torch.ops.cuda.flash_attention_bwd import (flash_attention_bwd,
                                                              flash_attention_bwd_plain,
                                                              flash_bwd_plan)
    from qgemm_tpu_torch.utils.profiling import bench_ms
    errs = errs or {}
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    bf16, h, d = torch.bfloat16, 32, 128
    k3 = {}
    for b, s in ((1, 512), (4, 2048)):
        q, k, v = (torch.randn((b, h, s, d), generator=g, device="cuda").to(bf16)
                   for _ in range(3))
        plan = flash_fwd_plan(bf16, b * h, s, s, d)
        ms = bench_ms(lambda: flash_attention_fwd(q, k, v, causal=True))
        sdpa = bench_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
        flops = 4 * d * b * h * s * (s + 1) // 2
        bms, by = bound(4 * b * h * s * d * 2 + b * h * s * 4, flops, BF16_FLOPS)
        k3[s] = {"ms": ms, "plan": plan, "library_ms": sdpa,
                 "over_sdpa": ms / sdpa, "bound_ms": bms, "bound_by": by,
                 "bound_share": bms / ms, "achieved_tflops": flops / ms / 1e9,
                 "shape": f"B={b} H={h} S={s} D={d} causal bf16"}
        if s == 512:
            k3[s]["plain_ms"] = bench_ms(lambda: flash_attention_plain(q, k, v, causal=True))
        del q, k, v

    b, s = 4, 2048
    q, k, v, dout = (torch.randn((b, h, s, d), generator=g, device="cuda").to(bf16)
                     for _ in range(4))
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    ms = bench_ms(lambda: flash_attention_bwd(q, k, v, o, lse, dout, True))
    plain = bench_ms(lambda: flash_attention_bwd_plain(q, k, v, o, lse, dout, True))
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    sdpa_bwd = lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), dout, retain_graph=True)
    try:
        lib, lib_timing = bench_ms(sdpa_bwd), "queued behind the sleep"
    except RuntimeError as e:   # the autograd engine held the host back
        print(f"SDPA backward could not be queued ahead: {e}", file=sys.stderr)
        lib, lib_timing = bench_ms(sdpa_bwd, queue_ahead=False), "not queued ahead"
    # K7's time by kernel, from one trace of a few calls (L2 warm)
    calls = 5
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flash_attention_bwd(q, k, v, o, lse, dout, True)
        torch.cuda.synchronize()
    _, by_name, _ = device_spans(prof)
    split = {part: sum(us for n, us in by_name.items() if key in n) / calls / 1e3
             for part, key in (("dq_kernel", "flash_bwd_dq"), ("dkv_kernel", "flash_bwd_dkv"),
                               ("delta_kernel", "delta_kernel"))}
    flops = 10 * d * b * h * s * (s + 1) // 2
    bms, by = bound(8 * b * h * s * d * 2 + b * h * s * 4, flops, BF16_FLOPS)
    k7 = {"ms": ms, "plain_ms": plain, "library_ms": lib, "library_timing": lib_timing,
          "over_sdpa": ms / lib, "bound_ms": bms, "bound_by": by, "bound_share": bms / ms,
          # the rate of the bound's 5 products, and of the 7 the kernels run
          "achieved_tflops": flops / ms / 1e9, "achieved_tflops_executed": 7 / 5 * flops / ms / 1e9,
          "plan": flash_bwd_plan(bf16, b * h, s, s, d), "ms_by_kernel_traced": split,
          "k3_fwd_ms_same_shape": k3[2048]["ms"], "bwd_over_fwd": ms / k3[2048]["ms"],
          "sdpa_fwd_ms_same_shape": k3[2048]["library_ms"],
          **errs.get("flash_attention_bwd", {}), "shape": f"B={b} H={h} S={s} D={d} causal bf16"}
    del q, k, v, dout, o, lse, qg, kg, vg, sdpa_out
    torch.cuda.empty_cache()
    row6 = dict(k3[512], **errs.get("flash_attention", {}), at_train_shape=k3[2048])
    emit({"phase": "timing_flash", "flash_attention": row6, "flash_attention_bwd": k7})
    return {"flash_attention": row6, "flash_attention_bwd": k7}


def device_spans(prof) -> tuple:
    """(microseconds in the union of the device kernels' intervals, time by
    kernel name, kernel count) of a torch.profiler trace; fails if the trace
    holds no device kernel."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise AssertionError("torch.profiler recorded no device kernel in the window")
    busy_us, end, by_name = 0.0, float("-inf"), {}
    for s, e, name in spans:        # union of the kernels' intervals
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    return busy_us, by_name, len(spans)


# kernel families of a decode step, by substrings of the kernels' names (the
# GEMVs' names before and after their redesign, so an A/B can read either tree)
DECODE_FAMILIES = {"gemv": ("gemv_kernel", "small_m_kernel"),
                   "dense_decode": ("decode_kernel<signed char", "dense_decode_split_kernel"),
                   "gemm_prepass": ("row_quantize_kernel", "row_absmax_kernel",
                                    "slab_quantize_kernel"),
                   "paged_decode": ("paged_decode",),
                   "nccl": ("nccl",)}


# host calls that put work on the card, by the prefixes of their names in a
# torch.profiler trace of CPU activity (the runtime's and the driver's API)
HOST_ISSUE_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch",
                       "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")


def host_issued(prof, n_steps: int) -> dict:
    """Per decode step: the host's calls that queued work on the card in a
    trace of CPU activity, in all and by name (a graph replay is one
    ``cudaGraphLaunch``)."""
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and \
                e.name.startswith(HOST_ISSUE_PREFIXES):
            by_name[e.name] = by_name.get(e.name, 0) + 1
    return {"host_issued_ops_per_step": sum(by_name.values()) / n_steps,
            "host_issued_by_name_per_step": {k: v / n_steps for k, v in sorted(by_name.items())}}


def long_prompt(rng, vocab: int) -> list:
    """A steady window's prompt: 300 random tokens."""
    return rng.integers(0, vocab, size=300).tolist()


def profile_decode(engine, rng, n_steps: int = 10, host_window: bool = False,
                   prompt=long_prompt) -> dict:
    """Where a steady decode step's time goes, with 8 busy slots: three
    windows of ``n_steps`` engine steps back to back, the middle one traced
    by torch.profiler (CUDA activity only). The trace gives the device's
    kernel time per step (the union of kernel intervals). The idle share is
    1 - kernel time / wall time, against the traced window's own wall time
    (which carries the profiler's host cost, so it is an upper bound) and
    against the mean wall time of the two untraced windows around it (whose
    slots sit, on average, at the traced window's positions). An engine
    step of a ``multi_step`` engine decodes a block of that many tokens: the
    per-token readings divide by it. With ``host_window`` a fourth window,
    traced with CPU activity, counts the host's calls that queue device
    work (``host_issued``). The untraced windows' dispatch gaps give the
    ITL percentiles (one gap per engine step, a block's tokens arriving
    together) and their tokens over their wall time the tokens/s. Every
    slot's prompt is ``prompt(rng, vocab)``. Runs after the serving
    phase's launch counts were read."""
    from torch.profiler import ProfilerActivity, profile

    from qgemm_tpu_torch.serving.engine import Request
    vocab = engine.model.cfg.vocab_size
    per_step = max(1, getattr(engine, "multi_step", 0))
    windows = 4 if host_window else 3
    for _ in range(engine.max_slots):
        engine.submit(Request(prompt=prompt(rng, vocab),
                              max_new_tokens=per_step * (windows * n_steps + 3) + 8))
    for _ in range(3):          # admits every slot, then two warm steps
        engine.step()
    if engine.book.num_active != engine.max_slots:
        raise AssertionError("profile window: not every slot is decoding")
    gaps = []

    def window() -> float:
        torch.cuda.synchronize()
        t = last = time.perf_counter()
        for _ in range(n_steps):
            engine.step()
            now = time.perf_counter()
            gaps.append(now - last)
            last = now
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / n_steps

    before = window()
    untraced_gaps = list(gaps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced_ms = window()
    del gaps[:]
    after = window()
    untraced_gaps += gaps
    host = None
    if host_window:
        with profile(activities=[ProfilerActivity.CPU]) as hprof:
            window()
        host = host_issued(hprof, n_steps)
    if engine.book.num_active != engine.max_slots:
        raise AssertionError("profile window: a slot finished inside the windows")
    engine.run_to_completion()
    busy_us, by_name, n_spans = device_spans(prof)
    kernel_ms = busy_us / 1e3 / n_steps
    untraced_ms = (before + after) / 2
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    families = {fam: sum(us for name, us in by_name.items() if any(p in name for p in pats))
                / 1e3 / n_steps for fam, pats in DECODE_FAMILIES.items()}
    gap_ms = np.asarray(untraced_gaps) * 1e3
    res = {"steps": n_steps, "slots": engine.max_slots, "tokens_per_slot_per_step": per_step,
           "wall_ms_per_step_untraced": untraced_ms,
           "wall_ms_per_step_untraced_windows": [before, after],
           "wall_ms_per_step_traced": traced_ms,
           "kernel_ms_per_step": kernel_ms,
           "wall_ms_per_token_untraced": untraced_ms / per_step,
           "kernel_ms_per_token": kernel_ms / per_step,
           "idle_share_untraced": 1.0 - kernel_ms / untraced_ms,
           "idle_share_traced": 1.0 - kernel_ms / traced_ms,
           "itl_p50_ms": float(np.percentile(gap_ms, 50)),
           "itl_p95_ms": float(np.percentile(gap_ms, 95)),
           "tokens_per_s_untraced": engine.max_slots * per_step * 1e3 / untraced_ms,
           "device_events_per_step": n_spans / n_steps,
           "family_ms_per_step": families,
           "top_kernels_ms_per_step": {n[:80]: v / 1e3 / n_steps for n, v in top}}
    if host is not None:
        res.update(host)
    return res


def plant_outlier_dims(model) -> None:
    """Systematic outlier features, as LLM.int8() reports for OPT-6.7B:
    ln1 and ln2 gain 20 at six fixed dims in every block. LayerNorm
    outputs are about N(0, 1) with random weights, so without this no
    activation would pass the 6.0 threshold."""
    with torch.no_grad():
        for blk in model.blocks:
            blk.ln1.gamma[OUTLIER_DIMS] = 20.0
            blk.ln2.gamma[OUTLIER_DIMS] = 20.0


def drive(engine, reqs, label: str, max_steps: int = 5000) -> dict:
    """Serve ``reqs`` to completion one step at a time, the launch counts set
    to 0 just before the run and read just after it. Per step: the kernels
    launched, and (decode-only steps) the wall time; with the paged tier,
    the pages reserved and used. A step that ran several decode steps (a
    ``multi_step`` block, decode steps between admission chunks) counts its
    launches per decode step: a decode-only step's counts divided by its
    decode steps, an admission step's less all but one of its decode steps'
    (so each admission step reads as its prefills and one decode step).
    A speculative engine's steps that ran only rounds count their launches
    per round (``per_round``: a step's counts divided by its rounds).
    ``admit_only`` reads every admission step less all of its decode
    steps and rounds (a speculative engine decodes plainly while requests
    wait), for the steps whose units were read.
    Fails unless every request finished, with no error, with its
    max_new_tokens tokens, within ``max_steps`` engine steps, and unless an
    engine that decodes by CUDA graph (this checkout's, unless its private
    ``_graphs`` was set to None) replayed its graphs."""
    from qgemm_tpu_torch.ops import cuda as kernels
    for r in reqs:
        engine.submit(r)
    kernels.reset_launch_counts()
    decode_only, admitting, step_ms, pages, rounds_only, round_ms = [], [], [], [], [], []
    while engine.book.num_waiting or engine.book.num_active:
        if engine.steps >= max_steps:
            raise AssertionError(f"{label}: not done after {max_steps} engine steps")
        before = kernels.launch_counts()
        n_adm = len(engine._admit_times)
        n_dec = getattr(engine, "decode_steps", None)  # an earlier checkout's engine counts none
        n_spec = getattr(engine, "spec_device_rounds", 0)
        t = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t) * 1e3
        delta = {kk: v - before[kk] for kk, v in kernels.launch_counts().items()}
        admitted = len(engine._admit_times) - n_adm
        n_dec = 1 if n_dec is None else engine.decode_steps - n_dec
        n_spec = getattr(engine, "spec_device_rounds", 0) - n_spec
        if n_spec and not admitted:
            if any(v % n_spec for v in delta.values()):
                raise AssertionError(f"{label}: a step of {n_spec} rounds launched {delta}")
            rounds_only.append({kk: v // n_spec for kk, v in delta.items()})
            round_ms.append(dt / n_spec)
        elif admitted:
            admitting.append((admitted, delta, n_dec, n_spec))
        elif n_dec:
            if any(v % n_dec for v in delta.values()):
                raise AssertionError(f"{label}: a step of {n_dec} decode steps launched "
                                     f"{delta}")
            decode_only.append({kk: v // n_dec for kk, v in delta.items()})
            step_ms.append(dt / n_dec)
        if getattr(engine, "paged", False):  # an earlier checkout's engine has no paged mode
            st = engine.stats
            pages.append((st["pages_reserved"], st["pages_used"], engine.book.num_active))
    counts = kernels.launch_counts()
    engine.run_to_completion()
    bad = [(r.id, r.error) for r in reqs if not r.done or r.error is not None]
    if bad:
        raise AssertionError(f"{label}: requests failed or unfinished: {bad}")
    for r in reqs:
        if len(r.generated) != r.max_new_tokens:
            raise AssertionError(f"{label}: request {r.id}: {len(r.generated)} tokens, "
                                 f"wanted {r.max_new_tokens}")
    per_decode = decode_only[0] if decode_only else None
    if any(dd != per_decode for dd in decode_only):
        raise AssertionError(f"{label}: decode steps launched different kernel counts")
    per_round = rounds_only[0] if rounds_only else None
    if any(dd != per_round for dd in rounds_only):
        raise AssertionError(f"{label}: speculative rounds launched different kernel counts")
    graphs = getattr(engine, "_graphs", None)
    if graphs is not None and not graphs.replays:
        raise AssertionError(f"{label}: the engine never replayed its decode graph")
    admit_steps = [(n, {kk: v - max(0, m - 1) * per_decode[kk] for kk, v in dd.items()})
                   for n, dd, m, _ in admitting] if per_decode else []
    admit_only = [(n, {kk: v - (m and m * per_decode[kk]) - (r and r * per_round[kk])
                       for kk, v in dd.items()})
                  for n, dd, m, r in admitting
                  if (not m or per_decode) and (not r or per_round)]
    return {"counts": counts, "per_decode": per_decode, "admit_steps": admit_steps,
            "admit_only": admit_only,
            "step_ms": step_ms, "pages": pages, "per_round": per_round, "round_ms": round_ms,
            "graph": None if graphs is None else {"captures": graphs.captures,
                                                  "replays": graphs.replays}}


# the stats a native-scheduled run must share with its Python-bookkept twin
TWIN_STATS = ("tokens_generated", "steps", "decode_steps", "admissions", "preemptions",
              "pages_in_use", "pages_total", "pages_reserved", "pages_used", "prefix_hits",
              "prefix_cached_pages", "prefill_tokens_skipped", "spec_rounds",
              "spec_acceptance", "decode_graph_captures", "decode_graph_replays")


def native_twin(label: str, model, kw: dict, make_reqs, want_reqs: list, want_run: dict,
                want_stats: dict, make_engine=None) -> dict:
    """Serve ``make_reqs()`` again through an engine of options ``kw`` with
    ``scheduler="native"`` (``make_engine(model, kw)``, default
    ``ContinuousBatchingEngine``), driven as its Python-bookkept twin was
    (``want_reqs``, ``want_run``: ``drive``'s result; ``want_stats``: its
    engine's stats right after). The transcripts must equal the twin's bit
    for bit, and so must every launch count ``drive`` read (in all, per
    decode step, per round, per admission step), the pages held after each
    step (paged) and the ``TWIN_STATS``. Returns the native run's readings
    and its engine."""
    from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, _NativeBookkeeper
    opts = dict(kw, scheduler="native")
    engine = (make_engine or (lambda m, o: ContinuousBatchingEngine(m, **o)))(model, opts)
    if engine.scheduler != "native" or not isinstance(engine.book, _NativeBookkeeper):
        raise AssertionError(f"{label}: the engine took the {engine.scheduler} scheduler")
    reqs = make_reqs()
    run = drive(engine, reqs, f"{label} native")
    for i, (a, b) in enumerate(zip(want_reqs, reqs)):
        if a.generated != b.generated:
            raise AssertionError(f"{label}: request {i}'s native transcript differs from the "
                                 f"Python bookkeeper's at step "
                                 f"{first_difference(a.generated, b.generated)}")
    for key in ("counts", "per_decode", "per_round", "admit_steps", "admit_only", "pages"):
        if run[key] != want_run[key]:
            raise AssertionError(f"{label}: native {key} {run[key]} != Python {want_run[key]}")
    stats = engine.stats
    differ = {k: (want_stats.get(k), stats.get(k)) for k in TWIN_STATS
              if want_stats.get(k) != stats.get(k)}
    if differ:
        raise AssertionError(f"{label}: native stats differ (Python, native): {differ}")
    return {"engine": engine, "run": run, "stats": stats,
            "checked": ["transcripts"] + [k for k in TWIN_STATS if k in stats]
            + ["launches in all, per decode step, per round, per admission step"]
            + (["pages after each step"] if run["pages"] else [])}


def twin_readings(want_run: dict, want_stats: dict, twin: dict) -> dict:
    """Both bookkeepers' walls in a twin pair: the median decode-only step
    (``drive``: synchronised after each step) and the whole run's wall per
    token (admissions included)."""
    out = {}
    for side, run, st in (("python", want_run, want_stats),
                          ("native", twin["run"], twin["stats"])):
        out[side] = {"decode_step_ms_median": (float(np.median(run["step_ms"]))
                                               if run["step_ms"] else None),
                     "round_ms_median": (float(np.median(run["round_ms"]))
                                         if run["round_ms"] else None),
                     "wall_ms_per_token": 1e3 * st["wall_s"] / max(1, st["tokens_generated"])}
    return out


def bookkeeping_host_us(slots: int = 8, max_seq_len: int = 1024) -> dict:
    """The host's microseconds per bookkeeping call of each bookkeeper, 8
    decoding slots (``host_us``): the engine's reads (``active_mask``,
    ``positions``), ``record_step``, and one decode step's bookkeeping as
    ``_record_block`` does it (mask, record, mask, drain)."""
    from qgemm_tpu_torch.serving.engine import _NativeBookkeeper, _PyBookkeeper, Request
    toks = np.zeros(slots, np.int64)
    out = {}
    for side, cls in (("python", _PyBookkeeper), ("native", _NativeBookkeeper)):
        book = cls(slots, max_seq_len)
        for _ in range(slots):
            book.submit(Request(prompt=[1], max_new_tokens=max_seq_len - 2))
        while (adm := book.next_admission()) is not None:
            book.admitted(adm[0], 1)
        calls = {"active_mask": book.active_mask, "positions": book.positions,
                 "record_step": lambda: book.record_step(toks),
                 "decode_step": lambda: (book.active_mask(), book.record_step(toks),
                                         book.active_mask(), book.drain_finished())}
        out[side] = {name: host_us(fn, calls=100) for name, fn in calls.items()}
        if book.num_active != slots:
            raise AssertionError(f"bookkeeping_host_us: a {side} slot finished")
    return out


def transcripts_match_generate(label: str, model, reqs) -> int:
    """Each request's greedy transcript equals the model's own generation
    with the dense int8 cache (K3 prefill, K2 decode). Returns the count."""
    for r in reqs:
        iso = model.generate(torch.tensor([r.prompt], device="cuda"), r.max_new_tokens,
                             quantized_cache=True)[0].tolist()
        if iso != r.generated:
            raise AssertionError(f"{label}: request {r.id}: engine {r.generated} "
                                 f"!= generate {iso}")
    return len(reqs)


def greedy_logits(model, prompt: list, n_new: int) -> tuple:
    """One request alone, greedy, through ``generate``'s calls with the
    dense int8 cache (K3 prefill, K2 decode), every step's logits kept.
    Returns (tokens, logits per step)."""
    plen = len(prompt)
    tokens = torch.tensor([prompt], device="cuda")
    caches = model.init_cache(1, plen + n_new, quantized=True)
    logits, caches = model.prefill(tokens, caches)
    steps = [logits[0, plen - 1].float()]
    tok = logits[:, plen - 1, :].argmax(dim=-1, keepdim=True)
    out = [int(tok)]
    for t in range(n_new - 1):
        logits, caches = model.decode_step(tok, plen + t, caches)
        steps.append(logits[0].float())
        tok = logits.argmax(dim=-1, keepdim=True)
        out.append(int(tok))
    return out, steps


def engine_alone_logits(model, prompt: list, n_new: int,
                        engine_kw: Optional[dict] = None) -> tuple:
    """One request served alone, greedy, by a new ContinuousBatchingEngine
    with ``engine_kw`` (default ``PAGED_ENGINE``'s options; slot 0), every
    step's logits of its slot kept as the engine samples them: on its eager
    route (a replayed graph runs no Python), so a graph engine's transcript
    held to it is held to the eager route's too; one step a dispatch
    (``multi_step`` dropped from the options). Returns (tokens, logits per
    step)."""
    from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
    kw = dict(engine_kw or PAGED_ENGINE)
    kw.pop("multi_step", None)
    engine = ContinuousBatchingEngine(model, **kw)
    engine._graphs = None
    seen, sample = [], engine._sample

    def observed(logits, *args):      # the first token's [1, V], then [slots, V]
        seen.append(logits[0].float().clone())
        return sample(logits, *args)

    engine._sample = observed
    req = Request(prompt=prompt, max_new_tokens=n_new)
    engine.submit(req)
    engine.run_to_completion()
    if req.error is not None or len(seen) != n_new or len(req.generated) != n_new:
        raise AssertionError(f"the engine alone: {req.error}, {len(seen)} samplings and "
                             f"{len(req.generated)} tokens for {n_new}")
    return list(req.generated), seen


def first_difference(want: list, got: list) -> Optional[int]:
    """The first step where two transcripts differ, or None."""
    return next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)


def paged_logit_reading(model, prompt: list, n_new: int,
                        engine_kw: Optional[dict] = None) -> dict:
    """A request's greedy run alone through the paged engine (K5 decode,
    ``engine_alone_logits``) against ``generate`` (K2 decode; its logits
    from ``greedy_logits``, whose tokens must be generate's). At every step
    of the two runs' shared history (each step up to and including the
    first where their tokens differ; every step where none does) the
    reading is max |dense - paged| over the vocabulary relative to the
    dense step's largest |logit|. Returns the tokens, the first differing
    step and the two runs' margins there, and the readings: the prefill's
    (step 0, no K5 yet), the largest (and its step) and the median, and
    whether the two runs' logits are equal bit for bit at every step of
    that history. ``engine_kw``: the paged engine's options
    (``PAGED_ENGINE``'s by default)."""
    iso = model.generate(torch.tensor([prompt], device="cuda"), n_new,
                         quantized_cache=True)[0].tolist()
    dense, d_logits = greedy_logits(model, prompt, n_new)
    if dense != iso:
        raise AssertionError(f"the dense loop {dense} is not generate's {iso}")
    paged, p_logits = engine_alone_logits(model, prompt, n_new, engine_kw)
    t = first_difference(iso, paged)
    shared = n_new if t is None else t + 1
    rel = [float((d_logits[i] - p_logits[i]).abs().max() / d_logits[i].abs().max())
           for i in range(shared)]
    res = {"prompt_tokens": len(prompt), "new_tokens": n_new, "generate": iso,
           "paged_alone": paged, "steps_compared": shared,
           "logit_rel_diff_prefill": rel[0], "logit_rel_diff_max": max(rel),
           "logit_rel_diff_max_step": int(np.argmax(rel)),
           "logit_rel_diff_median": float(np.median(rel)),
           "logits_equal": all(bits_equal(d_logits[i], p_logits[i]) for i in range(shared)),
           "first_difference": None}
    if t is not None:
        ld, lp = d_logits[t], p_logits[t]
        res["first_difference"] = {"step": t, "dense_token": iso[t], "paged_token": paged[t],
                                   "dense_margin": float(ld[iso[t]] - ld[paged[t]]),
                                   "paged_margin": float(lp[paged[t]] - lp[iso[t]])}
    return res


def paged_transcripts_match(label: str, model, reqs) -> dict:
    """The paged engine's greedy transcripts of ``reqs`` (prompts prefilled
    whole, through K3 on both paths) against the model's own generation.
    Each must equal, bit for bit, the request served alone by the engine
    (``engine_alone_logits``): batching, paging and admission change
    nothing. And each must equal ``generate``'s (dense int8 cache, K2
    decode), its logits equal bit for bit at every step
    (``paged_logit_reading``): K5 and K2 run one split body over the same
    128-position splits, so the same rows give the same bits. Returns how
    many transcripts equal generate's and each request's readings; raises
    on anything else."""
    readings = []
    for r in reqs:
        w = paged_logit_reading(model, r.prompt, r.max_new_tokens)
        if w["paged_alone"] != r.generated:
            raise AssertionError(f"{label}: request {r.id}: engine {r.generated} != the "
                                 f"request served alone {w['paged_alone']}")
        readings.append({"request": r.id, **{k: v for k, v in w.items()
                                             if k not in ("generate", "paged_alone")}})
        if not (w["logits_equal"] and w["first_difference"] is None):
            raise AssertionError(f"{label}: request {r.id}: the paged logits or transcript "
                                 f"are not generate's bit for bit: {readings[-1]}")
    return {"equal_to_generate": sum(w["first_difference"] is None for w in readings),
            "requests": len(reqs), "readings": readings}


def serve(label: str, qkw: dict, used: tuple, unused: tuple, outliers: bool = False,
          twin: bool = False) -> dict:
    """One pass of the main path: GPT_6_7B (full width and depth, weights
    quantized with ``qkw``) serving 16 greedy requests through the
    continuous-batching engine with an int8 KV cache and the Python
    bookkeeper. Every kernel in
    ``used`` must have launched and none in ``unused``. With ``twin`` the
    same requests are served again under the native scheduler
    (``native_twin``: equal transcripts, launches and stats), both sides'
    steady decode windows are profiled in turns (python, native, native,
    python) and both bookkeepers' host time per
    call is read (``bookkeeping_host_us``). With ``outliers``
    the outlier dims are planted, a forward pre-hook on every quantized
    linear adds its input's count of columns above the threshold into a
    device tensor (read once, after the run), and the transcripts are not
    held to isolated generation: outlier selection runs over every row of
    a step, so a request's tokens may depend on what shares its step."""
    from qgemm_tpu_torch.models.gpt import GPT, GPT_6_7B
    from qgemm_tpu_torch.models.linear import QuantizedLinear
    from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = GPT.init_quantized(GPT_6_7B, seed=0, device="cuda", **qkw)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    above = torch.zeros((), dtype=torch.int64, device="cuda")
    hooks = []
    if outliers:
        plant_outlier_dims(model)

        def count_above(mod, args):
            x = args[0]
            above.add_((x.abs().amax(dim=tuple(range(x.ndim - 1)))
                        > mod.outlier_threshold).sum())

        hooks = [mod.register_forward_pre_hook(count_above) for mod in model.modules()
                 if isinstance(mod, QuantizedLinear)]
    rng = np.random.default_rng(0)
    dense = dense_requests(GPT_6_7B, rng)
    make_reqs = lambda: [Request(prompt=p, max_new_tokens=n) for p, n in dense]
    reqs = make_reqs()
    engine = ContinuousBatchingEngine(model, **DENSE_ENGINE)
    run = drive(engine, reqs, label)
    counts, per_decode, step_ms = run["counts"], run["per_decode"], run["step_ms"]
    stats = engine.stats
    for hook in hooks:
        hook.remove()
    columns_above = int(above)

    if not all(counts[k] > 0 for k in used):
        raise AssertionError(f"{label}: a kernel of the path never launched: {counts}")
    if any(counts[k] for k in unused):
        raise AssertionError(f"{label}: a kernel off the path launched: {counts}")
    if outliers and not columns_above > 0:
        raise AssertionError(f"{label}: no activation column passed the outlier threshold")
    per_prefill = None
    if run["admit_steps"] and per_decode is not None:
        n, dd = run["admit_steps"][0]
        per_prefill = {kk: (dd[kk] - per_decode[kk]) // n for kk in dd}
    n_gemms = 4 * GPT_6_7B.n_layers + 2 * GPT_6_7B.n_layers + 1
    for k in used:
        if k in ("quantized_matmul", "w4a8_matmul") and not (
                per_decode[k] == n_gemms and per_prefill[k] == n_gemms):
            raise AssertionError(f"{label}: {k} launched {per_decode[k]} times per decode "
                                 f"step and {per_prefill[k]} per prefill, not {n_gemms}")

    # rows are independent: two transcripts equal generate
    matched = 0 if outliers else transcripts_match_generate(label, model, reqs[:2])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    profile_state = rng.bit_generator.state
    profile = profile_decode(engine, rng)
    native = None
    if twin:
        t_twin = time.perf_counter()
        nat = native_twin(f"serving_{label}", model, DENSE_ENGINE, make_reqs, reqs, run, stats)
        layers = GPT_6_7B.n_layers
        want = ({"quantized_matmul": n_gemms, "decode_attention": layers},
                {"quantized_matmul": n_gemms, "flash_attention": layers})
        got = ({k: nat["run"]["per_decode"][k] for k in want[0]},
               {k: per_prefill[k] for k in want[1]})
        if got != want:
            raise AssertionError(f"serving_{label}: launches per decode step and per prefill "
                                 f"{got}, expected {want}")
        # steady windows in turns, python (above), native, native, python,
        # each on the same prompts
        nat_engine, profiles = nat.pop("engine"), {"python": [profile], "native": []}
        for side, eng in (("native", nat_engine), ("native", nat_engine), ("python", engine)):
            rng.bit_generator.state = profile_state
            profiles[side].append(profile_decode(eng, rng))
        per_token = {side: float(np.mean([p["wall_ms_per_token_untraced"] for p in ps]))
                     for side, ps in profiles.items()}
        idle = {side: [p["idle_share_untraced"] for p in ps] for side, ps in profiles.items()}
        del nat_engine
        native = {"scheduler": "native", "checked": nat["checked"],
                  "launches": nat["run"]["counts"],
                  "launches_per_decode_step": nat["run"]["per_decode"],
                  "walls": twin_readings(run, stats, nat),
                  "steady_wall_ms_per_token_untraced_mean": per_token,
                  "steady_wall_ms_per_token_untraced_windows": {
                      side: [p["wall_ms_per_token_untraced"] for p in ps]
                      for side, ps in profiles.items()},
                  "steady_order": ["python", "native", "native", "python"],
                  "steady_native_over_python": per_token["native"] / per_token["python"],
                  "steady_idle_share_untraced": idle,
                  "bookkeeping_host_us": bookkeeping_host_us(),
                  "seconds": time.perf_counter() - t_twin}
    res = {"phase": f"serving_{label}",
           "model": f"GPT_6_7B {label} weights, int8 KV cache",
           "quantize": qkw, "layers": GPT_6_7B.n_layers, "d_model": GPT_6_7B.d_model,
           "vocab": GPT_6_7B.vocab_size, "init_s": round(init_s, 2),
           "requests": len(reqs), "prompt_tokens": sum(len(r.prompt) for r in reqs),
           "stats": stats, "decode_steps_timed": len(step_ms),
           "decode_step_ms_mean": float(np.mean(step_ms)) if step_ms else None,
           "decode_step_ms_median": float(np.median(step_ms)) if step_ms else None,
           "launches": counts, "launches_per_decode_step": per_decode,
           "launches_per_prefill": per_prefill,
           "peak_mem_gb": round(peak / 2**30, 2),
           "transcripts_match_generate": matched, "decode_profile": profile,
           "scheduler": engine.scheduler}
    if native is not None:
        res["native_twin"] = native
    if outliers:
        res["outlier_dims_planted"] = OUTLIER_DIMS
        res["columns_above_threshold"] = columns_above
    emit(res)
    del engine, model
    torch.cuda.empty_cache()
    return res


def paged_prefill_launches(run: dict, per_decode: dict, n_layers: int, n_gemms: int,
                           label: str) -> dict:
    """What the paged run's prefills launched: each admission step's counts
    less its one decode step's. A whole-prompt prefill launches K3 once per
    layer, a chunk (a 256-row piece of a long prompt, or the suffix after a
    prefix hit) K6 once per layer, and each runs the model's 193 GEMMs; no
    prefill launches K5."""
    tot = {k: sum(d[k] - per_decode[k] for _, d in run["admit_steps"]) for k in per_decode}
    whole, rem3 = divmod(tot["flash_attention"], n_layers)
    chunks, rem6 = divmod(tot["paged_context_attention"], n_layers)
    k5 = tot["paged_decode_attention"] + tot["paged_decode_attention_ragged"]
    if rem3 or rem6 or k5 or tot["quantized_matmul"] != n_gemms * (whole + chunks):
        raise AssertionError(f"{label}: prefill launches {tot} are not {n_layers} per "
                             f"layer pass and {n_gemms} GEMMs per prefill")
    return {"totals": tot, "whole_prompt_prefills": whole, "chunks": chunks,
            "per_whole_prompt_prefill": {"flash_attention": n_layers,
                                         "quantized_matmul": n_gemms},
            "per_chunk": {"paged_context_attention": n_layers, "quantized_matmul": n_gemms}}


def decode_ab(engines: dict, rng, n_steps: int = 10) -> dict:
    """Host wall time per steady decode step of two engines on one model,
    each with the same 8 busy slots of 300-token prompts, timed in turns
    (a, b, b, a) so that drift of the host's speed falls on both alike.
    Each engine's two windows cover the same positions as the other's."""
    from qgemm_tpu_torch.serving.engine import Request
    (a, ea), (b, eb) = engines.items()
    vocab = ea.model.cfg.vocab_size
    prompts = [rng.integers(0, vocab, size=300).tolist() for _ in range(ea.max_slots)]
    for eng in (ea, eb):
        for p in prompts:
            eng.submit(Request(prompt=p, max_new_tokens=2 * n_steps + 8))
        for _ in range(3):          # admits every slot, then two warm steps
            eng.step()
        if eng.book.num_active != eng.max_slots:
            raise AssertionError("decode A/B: not every slot is decoding")

    def window(eng) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / n_steps

    ms = {a: [], b: []}
    for name, eng in ((a, ea), (b, eb), (b, eb), (a, ea)):
        ms[name].append(window(eng))
    for eng in (ea, eb):
        eng.run_to_completion()
    mean = {k: float(np.mean(v)) for k, v in ms.items()}
    return {"order": [a, b, b, a], "steps_per_window": n_steps,
            "wall_ms_per_step_windows": ms, "wall_ms_per_step_mean": mean,
            f"ratio_{b}_over_{a}": mean[b] / mean[a]}


# The over-commit run: over-commit admits a request only while one free
# page per resident slot remains, and a slot crosses at most one page
# boundary while it decodes fewer than 128 tokens, so with max_new_tokens
# of 16-48 no growth can find the pool dry. Its requests therefore decode
# 200 tokens more (two or three boundaries each), in a pool of 24 pages of
# 128 positions (and the null page), far below the 8 residents' worst
# cases: decode growth preempts.
OVERCOMMIT_PAGES = 25
OVERCOMMIT_EXTRA_NEW = 200
# The paged runs' engine: 8 slots x 1024 positions in int8 pages of 128,
# prefix cache on, chunked admission of 256 rows.
# The Python bookkeeper, named: a phase's native-scheduled twin
# (``native_twin``) changes only that; an engine of the script that names
# no scheduler takes the native one, whose library the build phase built.
PAGED_ENGINE = dict(max_slots=8, max_seq_len=1024, paged=True, page_size=128,
                    prefix_cache=True, chunked_prefill=256, device="cuda", scheduler="python")
# The dense runs' engine: 8 slots x 1024 positions of int8 KV cache.
DENSE_ENGINE = dict(max_slots=8, max_seq_len=1024, quantized_cache=True, device="cuda",
                    scheduler="python")
# How far the paged engine's logits may stray from generate's, relative to
# the largest, at any step of a request's shared history, for a prompt
# admitted in chunks or after a prefix hit: K6's chunks against generate's
# whole-prompt K3 prefill move the bf16 model's logits by a few bf16 steps
# (a prompt prefilled whole gives generate's bits: K5 and K2 share their
# split body). PERF.md gives the readings of sound kernels and of planted
# merge faults (``--decode-faults``) on either side of it.
PAGED_LOGIT_RTOL = 0.04


def serve_paged() -> tuple:
    """The paged tier on the main path: int8 GPT_6_7B, full width and depth,
    8 slots x 1024 positions in pages of 128, prefix cache on, chunked
    admission of 256 rows, serving the 16 ``paged_requests``. Run
    ``paged_int8`` (int8 pools, full pool) must decode through K5 only (32
    launches per decode step, K1 193, no K2 or K4), launch K3 (whole-prompt
    prefills) and K6 (chunks and prefix-hit suffixes), hit the prefix
    cache, give the two short random prompts the transcripts they get
    served alone and ``generate``'s logits and transcripts bit for bit
    (``paged_transcripts_match``), and keep a chunked prompt's logits within
    ``PAGED_LOGIT_RTOL`` of ``generate``'s. Run ``paged_int4_overcommit`` (int4 pools, over-commit,
    overlapped admission, an undersized pool, the same prompts decoding
    ``OVERCOMMIT_EXTRA_NEW`` tokens more) must preempt at least once and
    still finish every request, through K5 and K6 on int4 pools; served
    again under the native scheduler (``native_twin``), it must give the
    same transcripts, launches, pages after every step and stats
    (preemptions among them). Returns both phases' results."""
    from qgemm_tpu_torch.models.gpt import GPT, GPT_6_7B
    from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = GPT.init_quantized(GPT_6_7B, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts, news, short = paged_requests(GPT_6_7B.vocab_size, np.random.default_rng(7))
    n_gemms = 6 * GPT_6_7B.n_layers + 1
    k5 = ("paged_decode_attention", "paged_decode_attention_ragged")
    results = []
    for label, extra, kw in (("paged_int8", 0, {}),
                             ("paged_int4_overcommit", OVERCOMMIT_EXTRA_NEW,
                              dict(kv_bits=4, overcommit=True, overlap_admission=True,
                                   n_pages=OVERCOMMIT_PAGES))):
        make_reqs = lambda extra=extra: [Request(prompt=p, max_new_tokens=n + extra)
                                         for p, n in zip(prompts, news)]
        reqs = make_reqs()
        engine = ContinuousBatchingEngine(model, **PAGED_ENGINE, **kw)
        t_run = time.perf_counter()
        run = drive(engine, reqs, label)
        run_s = time.perf_counter() - t_run
        counts, per_decode = run["counts"], run["per_decode"]
        stats = engine.stats
        k5_launches = sum(counts[k] for k in k5)
        if not (k5_launches > 0 and counts["paged_context_attention"] > 0):
            raise AssertionError(f"{label}: K5 or K6 never launched: {counts}")
        if any(c.kv_bits != (4 if "int4" in label else 8) for c in engine.caches):
            raise AssertionError(f"{label}: the pools are not of the run's kv_bits")
        if not (stats["prefix_hits"] > 0 and stats["prefill_tokens_skipped"] > 0):
            raise AssertionError(f"{label}: the prefix cache was never hit: {stats}")
        if label == "paged_int8":
            if not (per_decode is not None
                    and sum(per_decode[k] for k in k5) == GPT_6_7B.n_layers
                    and per_decode["quantized_matmul"] == n_gemms
                    and per_decode["decode_attention"] == 0 == per_decode["w4a8_matmul"]
                    and counts["flash_attention"] > 0):
                raise AssertionError(f"{label}: launches per decode step {per_decode}, "
                                     f"in all {counts}")
            prefill = paged_prefill_launches(run, per_decode, GPT_6_7B.n_layers, n_gemms,
                                             label)
            match = paged_transcripts_match(label, model, [reqs[i] for i in short])
            # a prompt past one chunk, served alone: K6 chunks against
            # generate's whole-prompt K3 prefill
            chunked = paged_logit_reading(model, reqs[0].prompt, reqs[0].max_new_tokens)
            chunked = {k: v for k, v in chunked.items() if k not in ("generate", "paged_alone")}
            if not chunked["logit_rel_diff_max"] <= PAGED_LOGIT_RTOL:
                raise AssertionError(f"{label}: a chunked prompt's paged logits differ from "
                                     f"generate's beyond {PAGED_LOGIT_RTOL}: {chunked}")
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            profile = profile_decode(engine, np.random.default_rng(8))
            ab = decode_ab({"dense_int8": ContinuousBatchingEngine(
                                model, max_slots=8, max_seq_len=1024, quantized_cache=True,
                                device="cuda"),
                            "paged_int8": ContinuousBatchingEngine(model, **PAGED_ENGINE)},
                           np.random.default_rng(9))
        elif not stats["preemptions"] >= 1:
            raise AssertionError(f"{label}: no preemption in an undersized pool: {stats}")
        else:
            t_twin = time.perf_counter()
            nat = native_twin(label, model, dict(PAGED_ENGINE, **kw), make_reqs, reqs, run,
                              stats)
            del nat["engine"]
            native = {"scheduler": "native", "checked": nat["checked"],
                      "launches": nat["run"]["counts"],
                      "preemptions": nat["stats"]["preemptions"],
                      "walls": twin_readings(run, stats, nat),
                      "seconds": {"python": run_s, "native": time.perf_counter() - t_twin}}
        reserved = max(p[0] for p in run["pages"])
        res = {"phase": f"serving_{label}",
               "model": "GPT_6_7B int8 weights, paged KV cache", "engine": kw,
               "layers": GPT_6_7B.n_layers, "init_s": round(init_s, 2),
               "requests": len(reqs), "prompt_tokens": sum(map(len, prompts)),
               "max_new_tokens": [r.max_new_tokens for r in reqs],
               "stats": stats, "decode_steps_timed": len(run["step_ms"]),
               "decode_step_ms_mean": float(np.mean(run["step_ms"])),
               "decode_step_ms_median": float(np.median(run["step_ms"])),
               "launches": counts, "launches_per_decode_step": per_decode,
               "admission_steps": len(run["admit_steps"]),
               "pages_total": stats["pages_total"], "pages_reserved_max": reserved,
               "pages_used_at_max_reserved": next(p[1] for p in run["pages"]
                                                  if p[0] == reserved),
               "pages_used_max": max(p[1] for p in run["pages"])}
        res["scheduler"] = engine.scheduler
        if label != "paged_int8":
            res["native_twin"] = native
        if label == "paged_int8":
            res.update(transcripts_equal_generate=match["equal_to_generate"],
                       transcripts_vs_generate=match, chunked_prompt_vs_generate=chunked,
                       paged_logit_rtol=PAGED_LOGIT_RTOL, peak_mem_gb=round(peak / 2**30, 2),
                       prefill_launches=prefill, decode_profile=profile, decode_ab=ab)
        emit(res)
        results.append(res)
        del engine
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    return tuple(results)


# The decode graphs' routes (``serving/decode_graph.py``): the eager step
# (the engine's private ``_graphs = None``), the captured step replayed once
# a step, and replayed in blocks of four (``multi_step=4``).
GRAPH_ROUTES = {"eager": {}, "graph": {}, "graph_ms4": {"multi_step": 4}}


def graph_engine(model, route: str, kw: dict):
    """A ContinuousBatchingEngine with options ``kw`` on one of
    ``GRAPH_ROUTES``."""
    from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine
    engine = ContinuousBatchingEngine(model, **kw, **GRAPH_ROUTES[route])
    if route == "eager":
        engine._graphs = None
    return engine


def graph_cases(cfg) -> dict:
    """The two engines of the decode graph checks and A/B on GPT_6_7B
    (``cfg``), each with its 16 requests (``serve``'s and
    ``serve_paged``'s) and the kernel family of its attention: the dense
    int8 cache of ``DENSE_ENGINE`` (K2) and the paged int8 tier of
    ``PAGED_ENGINE`` (K5)."""
    from qgemm_tpu_torch.serving.engine import Request
    dense = dense_requests(cfg, np.random.default_rng(0))
    prompts, news, _ = paged_requests(cfg.vocab_size, np.random.default_rng(7))
    return {"dense_int8": (DENSE_ENGINE,
                           lambda: [Request(prompt=p, max_new_tokens=n) for p, n in dense],
                           "dense_decode"),
            "paged_int8": (PAGED_ENGINE,
                           lambda: [Request(prompt=p, max_new_tokens=n)
                                    for p, n in zip(prompts, news)],
                           "paged_decode")}


def graph_fault_recovery(model, kw: dict, make_reqs, label: str) -> dict:
    """A fault injected into a graph replay mid-run (the fifth step of 8
    requests): every request in flight must fail with the error, the next
    step must capture the graph again, and a later 200-token request (one
    chunk: its prompt prefilled whole) must get ``generate``'s transcript."""
    from qgemm_tpu_torch.serving.engine import Request
    engine = graph_engine(model, "graph", kw)
    reqs = make_reqs()[:8]
    for r in reqs:
        engine.submit(r)
    for _ in range(4):
        engine.step()
    graphs = engine._graphs
    captures, real = graphs.captures, graphs._replay

    def boom(graph):
        graphs._replay = real
        raise RuntimeError("injected replay fault")

    graphs._replay = boom
    engine.step()
    failed = [r for r in reqs if r.error and "injected replay fault" in r.error and r.done]
    if len(failed) != len(reqs) or engine.book.num_active:
        raise AssertionError(f"{label}: after the fault {len(failed)} of {len(reqs)} requests "
                             f"failed, {engine.book.num_active} still active")
    rng = np.random.default_rng(12)
    later = Request(prompt=rng.integers(0, model.cfg.vocab_size, size=200).tolist(),
                    max_new_tokens=24)
    engine.submit(later)
    engine.run_to_completion()
    if later.error is not None or graphs.captures != captures + 1:
        raise AssertionError(f"{label}: after the fault: {later.error}, captures "
                             f"{captures} -> {graphs.captures}")
    transcripts_match_generate(f"{label} after the fault", model, [later])
    res = {"failed_in_flight": len(failed), "captures_before": captures,
           "captures_after": graphs.captures, "later_equals_generate": True}
    if engine.paged:
        res["prefix_cached_pages_after"] = engine.stats["prefix_cached_pages"]
    del engine
    torch.cuda.empty_cache()
    return res


def phase_decode_graph() -> dict:
    """The decode graphs on the full-depth int8 GPT_6_7B, through the dense
    int8 cache and the paged int8 tier (``graph_cases``): the same 16
    requests through the eager route, the graph and the graph with
    ``multi_step=4`` must give equal transcripts bit for bit (and the dense
    ones ``generate``'s) and equal launches per decode step (K1 193, K2 or
    K5 32), and so must 8 sampled requests on the dense engine
    (``sampled_routes_equal``). A steady window of each route is profiled (``profile_decode``
    with the host window): the replayed step must run the K1 GEMV, its
    pre-pass and K2 or K5; the host's calls that queue device work are
    counted per step. Then a replay fault mid-run must recover
    (``graph_fault_recovery``). The dense engine's ``multi_step=4`` route
    runs again under the native scheduler (``native_twin``: the same
    transcripts, launches and stats as the Python bookkeeper's)."""
    from qgemm_tpu_torch.models.gpt import GPT, GPT_6_7B
    t0 = time.perf_counter()
    model = GPT.init_quantized(GPT_6_7B, seed=0, device="cuda")
    n_gemms = 6 * GPT_6_7B.n_layers + 1
    res = {"phase": "decode_graph", "engines": {}}
    for label, (kw, make_reqs, family) in graph_cases(GPT_6_7B).items():
        runs, profiles = {}, {}
        for route in GRAPH_ROUTES:
            engine = graph_engine(model, route, kw)
            reqs = make_reqs()
            run = drive(engine, reqs, f"decode_graph {label} {route}")
            runs[route] = {"transcripts": [r.generated for r in reqs],
                           "per_decode": {k: v for k, v in run["per_decode"].items() if v},
                           "graph": run["graph"], "stats": engine.stats}
            if route == "graph_ms4":
                ms4 = (reqs, run, runs[route]["stats"])
            profiles[route] = profile_decode(engine, np.random.default_rng(8), host_window=True)
            if (label, route) == ("dense_int8", "graph"):   # the surface phase's trace
                res["surface_trace"] = traced_decode(engine, profiles[route])
            del engine
            torch.cuda.empty_cache()
        want = runs["eager"]
        attn = GPT_6_7B.n_layers
        per = want["per_decode"]
        if not (per.get("quantized_matmul") == n_gemms and sum(
                v for k, v in per.items() if "decode_attention" in k) == attn):
            raise AssertionError(f"decode_graph {label}: eager launches per step {per}")
        for route, run in runs.items():
            if run["transcripts"] != want["transcripts"]:
                raise AssertionError(f"decode_graph {label}: {route}'s transcripts are not "
                                     "the eager route's")
            if run["per_decode"] != per:
                raise AssertionError(f"decode_graph {label}: {route} launched "
                                     f"{run['per_decode']} per decode step, eager {per}")
        fams = profiles["graph"]["family_ms_per_step"]
        if not all(fams[f] > 0 for f in ("gemv", "gemm_prepass", family)):
            raise AssertionError(f"decode_graph {label}: the traced replay lacks a kernel "
                                 f"family: {fams}")
        # rows are independent: two transcripts equal generate
        matched = (transcripts_match_generate(f"decode_graph {label}", model,
                                              _requests_of(make_reqs, want["transcripts"])[:2])
                   if label == "dense_int8" else None)
        keys = ("wall_ms_per_step_untraced", "kernel_ms_per_step", "wall_ms_per_token_untraced",
                "kernel_ms_per_token", "idle_share_untraced", "host_issued_ops_per_step",
                "device_events_per_step", "itl_p50_ms", "itl_p95_ms", "tokens_per_s_untraced")
        sampled = (sampled_routes_equal(model, kw, make_reqs, f"decode_graph {label}")
                   if label == "dense_int8" else None)
        native = None
        if label == "dense_int8":
            nat = native_twin(f"decode_graph {label} graph_ms4", model, kw, make_reqs, *ms4,
                              make_engine=lambda m, o: graph_engine(m, "graph_ms4", o))
            del nat["engine"]
            native = {"route": "graph_ms4", "checked": nat["checked"],
                      "launches": nat["run"]["counts"],
                      "walls": twin_readings(ms4[1], ms4[2], nat)}
        res["engines"][label] = {
            "native_twin": native,
            "launches_per_decode_step": per, "transcripts_equal": True,
            "sampled": sampled,
            "transcripts_equal_generate": matched,
            "graph_runs": {r: v["graph"] for r, v in runs.items()},
            "profiles": {r: {k: p[k] for k in keys} for r, p in profiles.items()},
            "graph_families_ms_per_step": fams,
            "host_issued_by_name_per_step": {r: p["host_issued_by_name_per_step"]
                                             for r, p in profiles.items()},
            "fault": graph_fault_recovery(model, kw, make_reqs, f"decode_graph {label}")}
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    res["tp_serving"] = tp_serving(model)   # the same model, reused
    del model
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------- tensor parallelism
# K1's caller-given row scales at GPT_6_7B's row-parallel shard shapes: W_O
# (K 4096) and FFN-down (K 16384), N 4096, sharded on K over p ranks
K1_GIVEN_CX_SHAPES = {"w_o": (4096, 4096), "ffn_down": (16384, 4096)}
K1_GIVEN_CX_P = (1, 2, 4)
K1_GIVEN_CX_ROWS = (8, 512)
# the p shards' f32 outputs summed by hand against the unsharded K1: the
# codes are the same (one global grid), so the two differ by the rounding of
# p + 1 int32-to-f32 conversions and p - 1 f32 additions per element,
# under 2^-20 of the sum of the shards' magnitudes; a shard that quantized
# on its own grid moves outputs by ~1e-3 of that
K1_SHARD_SUM_RTOL = 2.0 ** -20
TP_REQUESTS = 8
# the tensor-parallel route at p = 1: per decode step of GPT_6_7B, a MAX and
# a SUM after W_O and after FFN-down in each of 32 layers, and the head's
# gather
TP_COLLECTIVES_PER_STEP = 4 * 32 + 1
TP_GIVEN_CX_PER_STEP = 2 * 32


def k1_given_cx_plain(x: torch.Tensor, qt: torch.Tensor, c: torch.Tensor,
                      cx: torch.Tensor) -> torch.Tensor:
    """The plain version of K1 on given row scales in K1's epilogue order,
    (acc * (cx / 127^2)) * cw (``quantized_matmul_plain(cx=...)`` takes
    JAX's, acc * (cx cw) / 127^2, an f32 rounding apart)."""
    from qgemm_tpu_torch.ops.quantize import QRANGE, int8_matmul, quantize_with_scales
    acc = int8_matmul(quantize_with_scales(x.float(), cx), qt.t())
    return (acc.to(torch.float32) * (cx * (1.0 / (QRANGE * QRANGE)))) * c


def k1_given_cx_checks(own_scales: bool = False) -> dict:
    """K1 on caller-given row scales at the shard shapes of
    ``K1_GIVEN_CX_SHAPES`` for each p of ``K1_GIVEN_CX_P`` and m of
    ``K1_GIVEN_CX_ROWS``: every shard's output equals the plain version's
    bit for bit on the whole row's absmax, and the fused route's where the
    scales are the shard's own absmax; the p shards' outputs summed by hand
    equal the unsharded K1 within ``K1_SHARD_SUM_RTOL``. Times the given-cx
    route, the fused route and the plain version on shard 0 (``bench_ms``)
    beside its bound. ``own_scales`` plants a fault: each shard quantizes
    on its own absmax (the sum check must fail, at p > 1). The plain
    version's time is ``quantized_matmul_plain(cx=...)``'s, its error
    beside the kernel's output ``plain_max_abs_err``."""
    from qgemm_tpu_torch.ops import cuda as kernels
    from qgemm_tpu_torch.ops.quantize import (QuantizedWeight, absmax_scales,
                                              quantize_weights, quantized_matmul_plain,
                                              quantized_matmul_prequant)
    from qgemm_tpu_torch.utils.profiling import bench_ms
    g = torch.Generator(device="cuda")
    g.manual_seed(17)
    rows, failures = [], []
    kernels.reset_launch_counts()
    for layer, (k, n) in K1_GIVEN_CX_SHAPES.items():
        wq = quantize_weights(torch.randn((k, n), generator=g, device="cuda") * 0.02)
        for m in K1_GIVEN_CX_ROWS:
            x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
            full = quantized_matmul_prequant(x, wq)
            cx = absmax_scales(x.float(), -1)
            for p in K1_GIVEN_CX_P:
                kl = k // p
                parts, bits, fused_bits, plain_err = [], True, True, 0.0
                for r in range(p):
                    xs = x[:, r * kl:(r + 1) * kl].contiguous()
                    ws = QuantizedWeight(qt=wq.qt[:, r * kl:(r + 1) * kl].contiguous(), c=wq.c)
                    c_r = absmax_scales(xs.float(), -1) if own_scales else cx
                    got = quantized_matmul_prequant(xs, ws, cx=c_r)
                    bits &= bits_equal(got, k1_given_cx_plain(xs, ws.qt, ws.c, c_r))
                    plain_err = max(plain_err, max_err(got, quantized_matmul_plain(xs, ws,
                                                                                   cx=c_r)))
                    fused_bits &= bits_equal(
                        quantized_matmul_prequant(xs, ws),
                        quantized_matmul_prequant(xs, ws, cx=absmax_scales(xs.float(), -1)))
                    parts.append(got)
                    if r == 0:
                        shard0 = (xs, ws, c_r)
                summed = torch.stack(parts).sum(0)
                scale = float(torch.stack(parts).abs().sum(0).max())
                err = max_err(summed, full)
                xs, ws, c_r = shard0
                ms = bench_ms(lambda: quantized_matmul_prequant(xs, ws, cx=c_r))
                fused_ms = bench_ms(lambda: quantized_matmul_prequant(xs, ws))
                plain_ms = bench_ms(lambda: quantized_matmul_plain(xs, ws, cx=c_r))
                bms, by = bound(m * kl * 2 + m * 4 + kl * n + n * 4 + m * n * 4,
                                2 * m * n * kl, INT8_OPS)
                row = {"layer": layer, "p": p, "m": m, "k_shard": kl, "n": n,
                       "bits_equal_plain": bits, "bits_equal_fused_on_own_absmax": fused_bits,
                       "plain_max_abs_err": plain_err,
                       "shard_sum_max_abs_err": err, "shard_sum_scale": scale,
                       "shard_sum_rtol": K1_SHARD_SUM_RTOL, "ms": ms, "fused_ms": fused_ms,
                       "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                       "share_of_bound": bms / ms}
                rows.append(row)
                if not (bits and fused_bits):
                    failures.append(f"{layer} p={p} m={m}: not bit-equal "
                                    f"(plain {bits}, fused {fused_bits})")
                if err > K1_SHARD_SUM_RTOL * scale:
                    failures.append(f"{layer} p={p} m={m}: shard sum off the unsharded K1 by "
                                    f"{err:.3e} > {K1_SHARD_SUM_RTOL:.1e} x {scale:.3e}")
            del x
        del wq
    launched = kernels.launch_counts()["quantized_matmul_given_cx"]
    if not launched:
        failures.append("the given-cx route never launched")
    return {"rows": rows, "failures": failures, "given_cx_launches": launched}


def phase_k1_given_cx() -> dict:
    """``k1_given_cx_checks`` (row 2's route: the row-parallel int8 layer's
    K1 on the all-reduced row scales); fails on any failure."""
    t0 = time.perf_counter()
    res = k1_given_cx_checks()
    res.update(phase="k1_given_cx", seconds=time.perf_counter() - t0)
    emit(res)
    if res["failures"]:
        raise AssertionError(f"k1_given_cx: {res['failures']}")
    return res


def tp_group() -> tuple:
    """A process group of world 1 on this card (NCCL, over a file store in
    ``build/``) and its mesh, all on "model"; -> (mesh, the store)."""
    from qgemm_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    store = Path(__file__).resolve().parent / "build" / f"tp_store.{os.getpid()}"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    initialize_distributed(init_method=f"file://{store}", world_size=1, rank=0)
    return make_mesh((1, 1)), store


def tp_close(store: Path) -> None:
    import torch.distributed as dist
    dist.destroy_process_group()
    store.unlink(missing_ok=True)


def decode_step_collectives(engine, make_reqs) -> dict:
    """The collectives of one decode step with every slot busy (the step's
    graph replay adds those its capture counted)."""
    from qgemm_tpu_torch.parallel import tp_ops
    for r in make_reqs()[:engine.max_slots]:
        r.max_new_tokens = 64       # none finishes before every slot is decoding
        engine.submit(r)
    while engine.book.num_waiting or engine.book.num_active < engine.max_slots:
        if engine.steps > 1000:
            raise AssertionError("decode_step_collectives: the slots never filled")
        engine.step()
    n_dec, n_adm = engine.decode_steps, len(engine._admit_times)
    tp_ops.reset_collective_counts()
    engine.step()
    torch.cuda.synchronize()
    counts = tp_ops.collective_counts()
    if engine.decode_steps != n_dec + 1 or len(engine._admit_times) != n_adm:
        raise AssertionError(f"decode_step_collectives: the step was not one decode step")
    engine.run_to_completion()
    return counts


def tp_run(label: str, make_engine, make_reqs, want: Optional[dict] = None) -> dict:
    """Serve ``make_reqs()`` through ``make_engine()`` with ``drive``; with
    ``want`` (the un-meshed run's result) hold the transcripts, the launches
    per decode step and per round (K1's given-cx route aside, which only
    the mesh takes) and the ``TWIN_STATS`` to it bit for bit."""
    engine = make_engine()
    reqs = make_reqs()
    run = drive(engine, reqs, label)
    strip = lambda d: None if d is None else {k: v for k, v in d.items()
                                             if v and k != "quantized_matmul_given_cx"}
    res = {"engine": engine, "transcripts": [r.generated for r in reqs],
           "counts": {k: v for k, v in run["counts"].items() if v},
           "per_decode": strip(run["per_decode"]), "per_round": strip(run["per_round"]),
           "given_cx": {"per_decode": (run["per_decode"] or {}).get("quantized_matmul_given_cx"),
                        "per_round": (run["per_round"] or {}).get("quantized_matmul_given_cx"),
                        "in_all": run["counts"]["quantized_matmul_given_cx"]},
           "stats": {k: v for k, v in engine.stats.items() if k in TWIN_STATS},
           "graph": run["graph"]}
    if want is not None:
        for i, (a, b) in enumerate(zip(want["transcripts"], res["transcripts"])):
            if a != b:
                raise AssertionError(f"{label}: request {i}'s transcript differs from the "
                                     f"un-meshed engine's at step {first_difference(a, b)}")
        for key in ("per_decode", "per_round", "stats"):
            if res[key] != want[key]:
                raise AssertionError(f"{label}: {key} {res[key]} != un-meshed {want[key]}")
    return res


def tp_serving(model, kv_fault: bool = False) -> dict:
    """The tensor-parallel route at p = 1 on the main path's model (the
    int8 GPT_6_7B at full depth, reused): an NCCL group of world 1, the
    rank's model ``shard_quantized_model(model, mesh)`` (at p = 1 it shares
    every tensor with ``model``; every quantized layer is marked, as JAX
    marks them), and three engines each serving ``TP_REQUESTS`` greedy
    requests with and without the mesh: the dense int8-KV graph engine,
    the paged int8 graph engine and the speculative dense engine (a W4A8
    draft of 2 full-width layers, sharded too). Transcripts, launches per
    decode step and per round, and stats must equal the un-meshed engines'
    bit for bit (at p = 1 the collectives are identities and the given-cx
    route equals the fused one); the meshed dense and paged engines' decode
    step must run ``TP_COLLECTIVES_PER_STEP`` collectives carrying
    ``decode_step_allreduce_bytes`` and ``TP_GIVEN_CX_PER_STEP``
    K1 launches on the given-cx route. A steady window of the dense graph
    engine is profiled with and without the mesh (wall and device time a
    token, the NCCL kernels' share: reported, not judged). ``kv_fault``
    plants a fault: every block's K/V shards taken one head past their
    own."""
    from qgemm_tpu_torch.models.gpt import GPT, GPT_6_7B
    from qgemm_tpu_torch.parallel.sharding import shard_quantized_model
    from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
    t0 = time.perf_counter()
    mesh, store = tp_group()
    try:
        local = shard_quantized_model(model, mesh)
        if kv_fault:
            shift_kv_heads(local)
        draft = GPT.init_quantized(dataclasses.replace(GPT_6_7B, n_layers=2), seed=1,
                                   device="cuda", bits=4)
        dlocal = shard_quantized_model(draft, mesh)
        dense = dense_requests(GPT_6_7B, np.random.default_rng(0))[:TP_REQUESTS]
        prompts, news, _ = paged_requests(GPT_6_7B.vocab_size, np.random.default_rng(7))
        cases = {
            "dense_int8_graph": (DENSE_ENGINE, {}, dense),
            "paged_int8_graph": (PAGED_ENGINE, {}, list(zip(prompts, news))[:TP_REQUESTS]),
            "spec_dense_int8_graph": (DENSE_ENGINE, {"spec_gamma": 4}, dense)}
        want_bytes = decode_step_allreduce_bytes(GPT_6_7B.n_layers, GPT_6_7B.d_model,
                                                 DENSE_ENGINE["max_slots"])
        res = {"phase": "tp_serving", "p": 1, "backend": "nccl", "requests": TP_REQUESTS,
               "engines": {}, "planted_fault": "kv_head_offset" if kv_fault else None}
        for label, (kw, extra, reqs) in cases.items():
            spec = "spec_gamma" in extra
            make_reqs = lambda reqs=reqs: [Request(prompt=p, max_new_tokens=n) for p, n in reqs]
            plain = lambda: ContinuousBatchingEngine(
                model, **kw, **extra, **({"draft_model": draft} if spec else {}))
            meshed = lambda: ContinuousBatchingEngine(
                local, **kw, **extra, mesh=mesh, **({"draft_model": dlocal} if spec else {}))
            want = tp_run(f"tp_serving {label} un-meshed", plain, make_reqs)
            got = tp_run(f"tp_serving {label} mesh", meshed, make_reqs, want)
            row = {"transcripts_equal": True, "launches_per_decode_step": got["per_decode"],
                   "launches_per_round": got["per_round"], "given_cx": got["given_cx"],
                   "stats": got["stats"], "graph": got["graph"]}
            if not got["given_cx"]["in_all"]:
                raise AssertionError(f"tp_serving {label}: the given-cx route never launched")
            if not spec:
                if got["given_cx"]["per_decode"] != TP_GIVEN_CX_PER_STEP:
                    raise AssertionError(f"tp_serving {label}: {got['given_cx']} given-cx "
                                         f"launches, not {TP_GIVEN_CX_PER_STEP} a step")
                coll = decode_step_collectives(got["engine"], make_reqs)
                n = coll["all_reduce_max"] + coll["all_reduce_sum"] + coll["all_gather"]
                ar = coll["all_reduce_max_bytes"] + coll["all_reduce_sum_bytes"]
                row.update(collectives_per_decode_step=coll, all_reduce_bytes_analytic=want_bytes)
                if n != TP_COLLECTIVES_PER_STEP or ar != want_bytes:
                    raise AssertionError(f"tp_serving {label}: a decode step ran {coll}; "
                                         f"expected {TP_COLLECTIVES_PER_STEP} collectives and "
                                         f"{want_bytes} all-reduce bytes")
            if label == "dense_int8_graph":
                prof = {side: profile_decode(e, np.random.default_rng(8))
                        for side, e in (("un_meshed", want["engine"]),
                                        ("mesh", got["engine"]))}
                keys = ("wall_ms_per_token_untraced", "kernel_ms_per_token",
                        "kernel_ms_per_step", "idle_share_untraced",
                        "device_events_per_step", "family_ms_per_step",
                        "top_kernels_ms_per_step")
                row["profile"] = {side: {k: p[k] for k in keys} for side, p in prof.items()}
                nccl = prof["mesh"]["family_ms_per_step"]["nccl"]
                row["nccl_ms_per_step"] = nccl
                row["nccl_share_of_device_step"] = nccl / prof["mesh"]["kernel_ms_per_step"]
                row["mesh_over_un_meshed_wall_per_token"] = (
                    prof["mesh"]["wall_ms_per_token_untraced"]
                    / prof["un_meshed"]["wall_ms_per_token_untraced"])
            res["engines"][label] = row
            del want, got
            torch.cuda.empty_cache()
        del draft, dlocal, local
    finally:
        tp_close(store)
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    torch.cuda.empty_cache()
    return res


def phase_tp_serving() -> dict:
    """``tp_serving`` alone (``--only``), on a model of its own."""
    from qgemm_tpu_torch.models.gpt import GPT, GPT_6_7B
    model = GPT.init_quantized(GPT_6_7B, seed=0, device="cuda")
    return tp_serving(model)


def decode_step_allreduce_bytes(n_layers: int, d_model: int, batch: int) -> int:
    """scripts/bench_scaling.py:69's formula (that script imports JAX, so
    the formula is copied; tests/test_torch_tp_engine.py holds the two
    equal): per layer an f32 [B, d_model] SUM after W_O and after FFN-down
    and the two f32 [B, 1] MAXes that globalize the row absmax."""
    return n_layers * 2 * (batch * d_model * 4 + batch * 4)


def shift_kv_heads(model) -> list:
    """A planted fault: every attention block's K/V projections take their
    shard one head past their own (the rank's head block rolled by one
    head). -> the (layer, codes, scales) it replaced, for ``unshift``."""
    saved = []
    with torch.no_grad():
        for mod in model.modules():
            if hasattr(mod, "wqkv_k") and hasattr(mod, "kv_heads"):
                dh = mod.wqkv_q.out_features // mod.n_heads
                for lin in (mod.wqkv_k, mod.wqkv_v):
                    saved.append((lin, lin.qt, lin.c))
                    # new tensors: at p = 1 the shard shares the model's
                    lin.qt = torch.roll(lin.qt, dh, dims=0)
                    lin.c = torch.roll(lin.c, dh, dims=1)
    return saved


def unshift(saved: list) -> None:
    for lin, qt, c in saved:
        lin.qt, lin.c = qt, c


# which planted fault the card's checks can see at p = 1, and which the CPU
# tests hold at p = 2 (tests/test_torch_tp_engine.py::test_planted_faults_are_caught)
TP_FAULTS = {
    "own_row_scales": "k1_given_cx: the shards' outputs summed by hand (p = 2, 4)",
    "kv_head_offset": "tp_serving: transcripts against the un-meshed engine (p = 1)",
    "skipped_sum": "an identity at p = 1; the CPU test at p = 2",
    "bf16_sum": "an identity at p = 1 in the bf16 model (the sum is cast to bf16 anyway); "
                "the CPU test at p = 2 in f32"}


def tp_faults() -> None:
    """Plant the faults the card can see: each must break its check. The
    un-planted checks must pass first. Prints which check caught which."""
    from qgemm_tpu_torch.models.gpt import GPT, GPT_6_7B
    phase_device()
    phase_build()
    caught = {}
    sound = k1_given_cx_checks()
    if sound["failures"]:
        raise AssertionError(f"tp_faults: the sound k1_given_cx fails: {sound['failures']}")
    bad = k1_given_cx_checks(own_scales=True)
    caught["own_row_scales"] = [f for f in bad["failures"]]
    model = GPT.init_quantized(GPT_6_7B, seed=0, device="cuda")
    try:
        tp_serving(model, kv_fault=True)
        caught["kv_head_offset"] = []
    except AssertionError as e:
        caught["kv_head_offset"] = [str(e)[:300]]
    for fault, check in TP_FAULTS.items():
        emit({"fault": fault, "check": check, "caught": bool(caught.get(fault)),
              "evidence": caught.get(fault, [])[:3]})
    missed = [f for f in ("own_row_scales", "kv_head_offset") if not caught[f]]
    if missed:
        raise AssertionError(f"tp_faults: not caught: {missed}")
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def steady_wall_ms(engine, rng, n_steps: int = 10) -> float:
    """Wall ms of a steady decode step with every slot busy, untraced
    (the host clock around ``n_steps`` steps, synchronised): the multi-card
    run's reading."""
    from qgemm_tpu_torch.serving.engine import Request
    vocab = engine.model.cfg.vocab_size
    for _ in range(engine.max_slots):
        engine.submit(Request(prompt=long_prompt(rng, vocab), max_new_tokens=n_steps + 8))
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n_steps):
        engine.step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / n_steps
    engine.run_to_completion()
    return ms


def prompt_logits(model, prompts) -> torch.Tensor:
    """Each prompt's logits after its last token, from a fresh cache (a
    whole-prompt prefill): f32 [len(prompts), vocab] on the host."""
    rows = []
    for p in prompts:
        logits, _ = model.prefill(torch.tensor([p], device=model.device),
                                  model.init_cache(1, len(p), quantized=True))
        rows.append(logits[0, -1].float().cpu())
    return torch.stack(rows)


# how far the logits of a prompt, and of a teacher-forced decode step, may
# move when the model is sharded over cards, relative to the largest: the
# bf16 paged chunks' bound (the ranks' f32 partials are summed in another
# order and each layer's bf16 output may round the other way). Read at p = 4
# on four H100s (PERF.md §6): sound, 0.0216 (prompts) and 0.0264 (forced
# decode steps); a skipped SUM 1.31 and KV shards one head off 1.22; a
# per-shard grid 0.0288 and a bf16 SUM 0.0286, which this bound cannot see
TP_CARDS_LOGIT_RTOL = PAGED_LOGIT_RTOL
# decode steps teacher-forced on the single card's transcripts
TP_CARDS_FORCED_STEPS = 8


def _own_row_scales(x, mesh, axis="model"):
    return x.to(torch.float32).abs().amax(dim=1, keepdim=True).clamp_min(1e-12)


def _skipped_sum(partial, mesh, axis="model"):
    return partial


def _bf16_sum(partial, mesh, axis="model"):
    from qgemm_tpu_torch.parallel import tp_ops
    return tp_ops.all_reduce_sum_(partial.to(torch.bfloat16), mesh, axis).to(torch.float32)


# the faults ``--tp-cards`` plants on every rank, each in a run of its own:
# name -> (the tp_ops function it replaces, its replacement); the KV shard
# one head off is ``shift_kv_heads``. Those the logits check must catch at
# p > 1 are in ``TP_CARDS_MUST_CATCH``; the others are read and reported
# (the per-shard grid is ``k1_given_cx``'s to catch, the bf16 SUM the CPU
# test's)
TP_CARDS_FAULTS = {"own_row_scales": ("global_row_scales", _own_row_scales),
                   "skipped_sum": ("reduce_partial", _skipped_sum),
                   "bf16_sum": ("reduce_partial", _bf16_sum),
                   "kv_head_offset": None}
TP_CARDS_MUST_CATCH = ("skipped_sum", "kv_head_offset")


def _future_visible(src: int, me: int) -> int:
    from qgemm_tpu_torch.parallel import ring_attention as ra
    return ra.DIAGONAL if src == me else ra.VISIBLE


def _block_local_lse(q, k, v, out, lse, g, causal: bool):
    """The ring's block backward against the block's own output and
    logsumexp instead of the global ones."""
    from qgemm_tpu_torch.ops.cuda.flash_attention import flash_attention_fwd
    from qgemm_tpu_torch.ops.cuda.flash_attention_bwd import flash_attention_bwd
    out_j, lse_j = flash_attention_fwd(q, k, v, causal)
    return flash_attention_bwd(q, k, v, out_j, lse_j, g, causal)


def _neighbour_expert_offset(r: int, n_local: int) -> int:
    return (r ^ 1) * n_local


def _collect_one_tick_early(t: int, n_stages: int) -> int:
    return t - n_stages + 2


def _no_data_grad_sync(mesh, axis: str = "data"):
    return lambda g: g


# the planted faults of the rest of parallelism (ring, EP, GPipe, data x
# model training): name -> (module, the function it replaces, its
# replacement). Each must fail its check at p = 2 (the CPU tests) and on
# ``--tp-cards`` across cards. The EP offset swaps the experts' slots with
# the neighbour rank's (plant it after ``shard_moe``), the data-axis
# reduction is skipped by gradient hooks that do nothing (plant it before
# ``shard_model``)
PARALLEL_FAULTS = {
    "ring_future_visible": ("qgemm_tpu_torch.parallel.ring_attention", "_regime",
                            _future_visible),
    "ring_block_local_lse": ("qgemm_tpu_torch.parallel.ring_attention", "_block_bwd",
                             _block_local_lse),
    "ep_expert_offset": ("qgemm_tpu_torch.parallel.expert", "_expert_offset",
                         _neighbour_expert_offset),
    "pipeline_tick": ("qgemm_tpu_torch.parallel.pipeline", "_collect_index",
                      _collect_one_tick_early),
    "data_grad_skipped": ("qgemm_tpu_torch.parallel.sharding", "_data_grad_hook",
                          _no_data_grad_sync),
}


class planted:
    """``with planted(name):`` runs its body with the fault of
    ``PARALLEL_FAULTS`` in place (None: sound)."""

    def __init__(self, name: Optional[str]):
        self.swap = None if name is None else PARALLEL_FAULTS[name]

    def __enter__(self):
        if self.swap is not None:
            import importlib
            mod = importlib.import_module(self.swap[0])
            self.saved = (mod, getattr(mod, self.swap[1]))
            setattr(mod, self.swap[1], self.swap[2])
        return self

    def __exit__(self, *exc):
        if self.swap is not None:
            setattr(self.saved[0], self.swap[1], self.saved[1])
        return False


def forced_decode_logits(engine, prompts, forced, n_steps: int) -> torch.Tensor:
    """``n_steps`` teacher-forced greedy decode steps through ``engine``'s
    own dispatch (on CUDA its captured graph, with a mesh's collectives in
    it), every prompt admitted first: before step t each request's slot is
    fed ``forced[i][t]`` (a reference transcript), and the step's logits
    are read from a tap the step's body writes. The engine is spent
    afterwards. -> f32 [len(prompts), n_steps, vocab] on the host."""
    from qgemm_tpu_torch.serving.engine import Request
    if len(prompts) > engine.max_slots or any(len(f) < n_steps for f in forced):
        raise ValueError("forced_decode_logits: a slot for every prompt, a forced "
                         "token for every step")
    vocab = engine.model.cfg.vocab_size
    tap = torch.zeros((engine.max_slots, vocab), dtype=torch.float32, device=engine.device)
    step_logits = engine._step_logits

    def tapped():
        logits = step_logits()
        tap.copy_(logits.reshape(tap.shape))
        return logits
    engine._step_logits = tapped      # before the first dispatch captures the step
    reqs = [Request(prompt=list(p), max_new_tokens=n_steps + 1) for p in prompts]
    for r in reqs:
        engine.submit(r)
    engine._t_start = time.perf_counter()
    engine._admit()
    slot_of = {}
    for s in range(engine.max_slots):
        q = engine.book.request_in_slot(s)
        if q is not None:
            slot_of[q.id] = s
    if len(slot_of) != len(reqs):
        raise AssertionError(f"forced_decode_logits: {len(slot_of)} of {len(reqs)} admitted")
    slots = [slot_of[r.id] for r in reqs]
    active = engine.book.active_mask()
    out = torch.empty((len(reqs), n_steps, vocab), dtype=torch.float32)
    for t in range(n_steps):
        engine.cur_tokens[slots, 0] = torch.tensor([f[t] for f in forced],
                                                   device=engine.device)
        engine._decode(active, 1)
        out[:, t] = tap[slots].cpu()
    return out


def logit_reading(got: torch.Tensor, want: torch.Tensor) -> dict:
    """How far ``got`` moved from ``want``: the largest change relative to
    want's largest magnitude, per request and in all, and the argmax flips."""
    d = (got - want).abs().flatten(1).amax(1)
    scale = float(want.abs().max())
    return {"rel_change": float(d.max()) / scale,
            "rel_change_per_request": (d / scale).tolist(),
            "argmax_flips": int((got.argmax(-1) != want.argmax(-1)).sum())}


def tp_cards_worker(rank: int, world: int, out: str) -> None:
    """One rank of ``--tp-cards``: the int8 GPT_6_7B from seed 0, rank 0 also
    served un-meshed on its card, then the rank's shards under the mesh
    (the full model dropped first); writes its transcripts and readings."""
    import torch.distributed as dist

    from qgemm_tpu_torch.models.gpt import GPT, GPT_6_7B
    from qgemm_tpu_torch.parallel import tp_ops
    from qgemm_tpu_torch.parallel.mesh import make_mesh
    from qgemm_tpu_torch.parallel.sharding import shard_quantized_model
    from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
    def stage(what: str) -> None:   # progress on stderr: where a stuck world stopped
        print(f"tp_cards rank {rank}: {what} at {time.perf_counter():.1f}", file=sys.stderr,
              flush=True)

    mesh = make_mesh((1, world))
    model = GPT.init_quantized(GPT_6_7B, seed=0, device="cuda")
    stage("model built")
    dense = dense_requests(GPT_6_7B, np.random.default_rng(0))[:TP_REQUESTS]
    make_reqs = lambda: [Request(prompt=p, max_new_tokens=n) for p, n in dense]
    prompts = [p for p, _ in dense]
    res = {"rank": rank}
    want = [None]
    if rank == 0:
        engine = ContinuousBatchingEngine(model, **DENSE_ENGINE)
        reqs = make_reqs()
        drive(engine, reqs, "tp_cards un-meshed")
        want = [[r.generated for r in reqs]]
        res["want"] = want[0]
        res["want_wall_ms_per_step"] = steady_wall_ms(engine, np.random.default_rng(8))
        want_logits = prompt_logits(model, prompts)
        want_forced = forced_decode_logits(ContinuousBatchingEngine(model, **DENSE_ENGINE),
                                           prompts, want[0], TP_CARDS_FORCED_STEPS)
        stage("single-card run done")
        del engine
        gc.collect()
    dist.broadcast_object_list(want, src=0)   # every rank forces the same tokens
    local = shard_quantized_model(model, mesh)
    del model
    torch.cuda.empty_cache()
    engine = ContinuousBatchingEngine(local, **DENSE_ENGINE, mesh=mesh)
    reqs = make_reqs()
    run = drive(engine, reqs, f"tp_cards mesh rank {rank}")
    stage("mesh run done")
    got_logits = prompt_logits(local, prompts)
    forced = {}
    for fault in (None,) + tuple(TP_CARDS_FAULTS):
        swap, saved = TP_CARDS_FAULTS.get(fault), None
        if swap is not None:
            orig = getattr(tp_ops, swap[0])
            setattr(tp_ops, swap[0], swap[1])
        elif fault is not None:
            saved = shift_kv_heads(local)
        try:
            forced[fault or "sound"] = forced_decode_logits(
                ContinuousBatchingEngine(local, **DENSE_ENGINE, mesh=mesh), prompts, want[0],
                TP_CARDS_FORCED_STEPS)
        finally:
            if swap is not None:
                setattr(tp_ops, swap[0], orig)
            if saved is not None:
                unshift(saved)
        gc.collect()       # the spent engine's graphs hold NCCL work of the group
    stage("forced decode steps done")
    if rank == 0:
        res["forced"] = {k: logit_reading(v, want_forced) for k, v in forced.items()}
        # a first token that differs must be a near tie: the single card's
        # top-2 gap within twice the largest logit change of that prompt
        dl = (got_logits - want_logits).abs()
        top2 = torch.topk(want_logits, 2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).tolist()
        flips = (got_logits.argmax(-1) != want_logits.argmax(-1)).tolist()
        res["logits"] = {"max_abs_change": dl.max(-1).values.tolist(),
                         "rel_change": float(dl.max() / want_logits.abs().max()),
                         "top2_gap": gaps, "argmax_flips": flips,
                         "near_tie": [g <= 2 * float(m) for g, m in
                                      zip(gaps, dl.max(-1).values.tolist())]}
    res.update(got=[r.generated for r in reqs], per_decode=run["per_decode"],
               collectives=decode_step_collectives(engine, make_reqs),
               wall_ms_per_step=steady_wall_ms(engine, np.random.default_rng(8)),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    stage("readings done")
    with open(Path(out) / f"tp_cards-{rank}.json", "w") as f:
        json.dump(res, f)
    # the decode graphs hold NCCL work of the group: free them (the engine
    # sits in a reference cycle) before the group is destroyed, which
    # otherwise waits on them forever
    del engine
    gc.collect()
    torch.cuda.synchronize()
    stage("graphs freed")


def tp_cards(n: int) -> None:
    """``n`` ranks, one per card, on NCCL: the int8 GPT_6_7B's dense graph
    engine sharded n ways, against the single-card engine on rank 0's card.
    Every rank must serve the same transcripts; the prompts' logits, and
    those of ``TP_CARDS_FORCED_STEPS`` decode steps teacher-forced on the
    single card's transcripts (the captured graph with the cross-card NCCL
    collectives, K2 on each rank's heads), may move by at most
    ``TP_CARDS_LOGIT_RTOL`` of the largest, and a first token that differs
    from the single card's must be a near tie. Each fault of
    ``TP_CARDS_FAULTS`` is planted in a forced run of its own; those of
    ``TP_CARDS_MUST_CATCH`` must move the forced logits past the bound, the
    others are reported. The free-running transcripts against the single
    card's are reported (greedy on random weights: a near tie anywhere
    sends one on another path)."""
    from qgemm_tpu_torch.utils.testing import run_world
    phase_device()
    if torch.cuda.device_count() < n:
        raise SystemExit(f"--tp-cards {n}: {torch.cuda.device_count()} card(s) here")
    phase_build()
    out = Path(__file__).resolve().parent / "build" / f"tp_cards.{os.getpid()}"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    try:
        run_world(tp_cards_worker, n, str(out), str(out), device=None, timeout=300)
    except TimeoutError:   # report what the ranks wrote, then fail
        emit({"phase": "tp_cards", "timed_out": True, "ranks_written": {
            f.name: json.loads(f.read_text()) for f in sorted(out.glob("tp_cards-*.json"))}})
        raise
    ranks = [json.loads((out / f"tp_cards-{r}.json").read_text()) for r in range(n)]
    want = ranks[0]["want"]
    diffs = {r["rank"]: [first_difference(a, b) for a, b in zip(want, r["got"])]
             for r in ranks}
    res = {"phase": "tp_cards", "p": n, "seconds": time.perf_counter() - t0,
           "transcripts_equal": all(r["got"] == want for r in ranks),
           "ranks_agree": all(r["got"] == ranks[0]["got"] for r in ranks),
           "prompt_logits": ranks[0]["logits"], "logit_rtol": TP_CARDS_LOGIT_RTOL,
           "forced_decode_steps": TP_CARDS_FORCED_STEPS,
           "forced_decode_logits": ranks[0]["forced"],
           "first_differences": diffs,
           "collectives_per_decode_step": ranks[0]["collectives"],
           "launches_per_decode_step": ranks[0]["per_decode"],
           "single_card_wall_ms_per_step": ranks[0]["want_wall_ms_per_step"],
           "mesh_wall_ms_per_step": {r["rank"]: r["wall_ms_per_step"] for r in ranks},
           "peak_mem_gb": {r["rank"]: r["peak_mem_gb"] for r in ranks}}
    emit(res)
    shutil.rmtree(out, ignore_errors=True)
    lg, fd = res["prompt_logits"], res["forced_decode_logits"]
    bad = [i for i, (f, t) in enumerate(zip(lg["argmax_flips"], lg["near_tie"])) if f and not t]
    caught = {f: fd[f]["rel_change"] > TP_CARDS_LOGIT_RTOL for f in TP_CARDS_FAULTS}
    for fault, hit in caught.items():
        emit({"fault": fault, "check": "tp_cards: teacher-forced decode logits, p = "
              f"{n}", "rel_change": fd[fault]["rel_change"], "caught": hit})
    missed = [f for f in TP_CARDS_MUST_CATCH if not caught[f]]
    if (not res["ranks_agree"] or lg["rel_change"] > TP_CARDS_LOGIT_RTOL or bad
            or fd["sound"]["rel_change"] > TP_CARDS_LOGIT_RTOL or missed):
        raise AssertionError(f"tp_cards: ranks agree {res['ranks_agree']}, prompt logits "
                             f"moved {lg['rel_change']:.3g} and teacher-forced decode "
                             f"logits {fd['sound']['rel_change']:.3g} of the largest (bound "
                             f"{TP_CARDS_LOGIT_RTOL}), first tokens flipped off a near tie: "
                             f"{bad}, planted faults not caught: {missed}")
    parallel_cards(n)
    dryrun_cards(n)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


# ---------------------------------------------------------------------------
# the rest of parallelism: expert, sequence, pipeline, data x model
# ---------------------------------------------------------------------------


def ep_collectives_per_step(n_layers: int) -> dict:
    """The expert-sharded MoE GPT's decode step under a mesh: per layer a MAX
    and a SUM after W_O and the experts' SUM, and the head's gather."""
    return {"all_reduce_max": n_layers, "all_reduce_sum": 2 * n_layers, "all_gather": 1}

# the ring on one card: B 1, H 32, D 128, bf16, S 8192 as 4 shards of 2048
RING_SHAPE = dict(b=1, h=32, s=8192, d=128, shards=4)
# the ring's bounds against K3 and K7 over the whole sequence (stated before
# its first card run): bf16 O and dQ/dK/dV round once more on the ring's
# side (each block's output, then the merge) -> |ring - whole| <= 2^-6 |whole|
# + 1e-2 max|whole|; the lse merges f32 block lses -> 1e-3 absolute
RING_RTOL, RING_ATOL_SHARE, RING_LSE_ATOL = 2 ** -6, 1e-2, 1e-3
# GPipe at one stage against the sequential forward on the same bf16 model:
# microbatch GEMMs of other row counts may round apart (stated bound: the
# logits within 2e-2 of the largest)
GPIPE_MICRO, GPIPE_LOGIT_RTOL = 4, 2e-2


def moe_step_allreduce_bytes(n_layers: int, d_model: int, batch: int) -> int:
    """A decode step's all-reduce bytes of the expert-sharded MoE GPT: per
    layer the f32 [B, 1] MAX and [B, d_model] SUM of the row-parallel W_O
    and the experts' f32 [B, d_model] SUM."""
    return n_layers * (batch * 4 + 2 * batch * d_model * 4)


def ep_serving(mesh) -> dict:
    """The MoE GPT (``MOE_CFG``, int8, seed 0) under ``mesh`` with its
    experts on the model axis (every block's FFN a rank's ``shard_moe``),
    served by the dense graph engine and the paged one beside the un-meshed
    engines (``tp_run``: transcripts, launches a decode step and stats bit
    for bit); the meshed decode step's collectives (``ep_collectives_per_step``
    with ``moe_step_allreduce_bytes``); then ``ep_moe_forward_a2a`` on the
    first layer at 64 tokens against the whole layer, bit for bit at p = 1,
    with its two all-to-alls."""
    from qgemm_tpu_torch.models.gpt import GPT, GPTConfig
    from qgemm_tpu_torch.ops import cuda as kernels
    from qgemm_tpu_torch.parallel import tp_ops
    from qgemm_tpu_torch.parallel.expert import ep_moe_forward_a2a, shard_moe
    from qgemm_tpu_torch.parallel.mesh import axis_size, make_mesh
    from qgemm_tpu_torch.parallel.sharding import shard_quantized_model
    from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = GPTConfig(**MOE_CFG)
    p = axis_size(mesh, "model")
    model = GPT.init_quantized(cfg, seed=0, device=dev)
    local = shard_quantized_model(model, mesh)
    held = [blk.ffn.n_local_experts for blk in local.blocks]
    if any(blk.ffn.tp_mode != "expert" for blk in local.blocks) or held != [
            cfg.n_experts // p] * cfg.n_layers:
        raise AssertionError(f"ep_serving: the experts are not sharded: {held}")
    dense = dense_requests(cfg, np.random.default_rng(0))[:TP_REQUESTS]
    prompts, news, _ = paged_requests(cfg.vocab_size, np.random.default_rng(7))
    cases = {"dense_int8_graph": (DENSE_ENGINE, dense),
             "paged_int8_graph": (PAGED_ENGINE, list(zip(prompts, news))[:TP_REQUESTS])}
    want_bytes = moe_step_allreduce_bytes(cfg.n_layers, cfg.d_model, DENSE_ENGINE["max_slots"])
    want_coll = ep_collectives_per_step(cfg.n_layers)
    res = {"p": p, "experts_per_rank": held[0], "engines": {}}
    for label, (kw, reqs) in cases.items():
        make_reqs = lambda reqs=reqs: [Request(prompt=q, max_new_tokens=n) for q, n in reqs]
        want = tp_run(f"ep_serving {label} un-meshed",
                      lambda: ContinuousBatchingEngine(model, **kw), make_reqs)
        got = tp_run(f"ep_serving {label} mesh",
                     lambda: ContinuousBatchingEngine(local, **kw, mesh=mesh), make_reqs, want)
        coll = decode_step_collectives(got["engine"], make_reqs)
        ar = coll["all_reduce_max_bytes"] + coll["all_reduce_sum_bytes"]
        if {k: coll[k] for k in want_coll} != want_coll or ar != want_bytes:
            raise AssertionError(f"ep_serving {label}: a decode step ran {coll}; expected "
                                 f"{want_coll} and {want_bytes} all-reduce bytes")
        res["engines"][label] = {
            "transcripts_equal": True, "launches_per_decode_step": got["per_decode"],
            "launches": got["counts"],
            "given_cx": got["given_cx"], "stats": got["stats"], "graph": got["graph"],
            "collectives_per_decode_step": coll, "all_reduce_bytes_analytic": want_bytes}
        del want, got
        gc.collect()
    # all-to-all expert parallelism on the first layer, 64 tokens
    ep_mesh = make_mesh((p,), ("expert",))
    layer = model.blocks[0].ffn
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    x = torch.randn((64, cfg.d_model), generator=g, device=dev).to(cfg.tdtype)
    rank_layer = shard_moe(layer, ep_mesh)
    with torch.no_grad():
        want = layer(x)
        kernels.reset_launch_counts()
        tp_ops.reset_collective_counts()
        got = ep_moe_forward_a2a(x, rank_layer, ep_mesh)
        torch.cuda.synchronize()
    res["a2a"] = {"tokens": 64, "bit_equal": bool(torch.equal(got, want)),
                  "max_abs_err": max_err(got, want),
                  "launches": {k: v for k, v in kernels.launch_counts().items() if v},
                  "collectives": {k: v for k, v in tp_ops.collective_counts().items() if v}}
    if p == 1 and not res["a2a"]["bit_equal"]:
        raise AssertionError(f"ep_serving: a2a EP differs from the whole layer at p = 1: "
                             f"{res['a2a']}")
    if res["a2a"]["collectives"].get("all_to_all") != 2:
        raise AssertionError(f"ep_serving: a2a ran {res['a2a']['collectives']}")
    del model, local, layer, rank_layer
    gc.collect()
    return res


def ring_blocks_one_device() -> dict:
    """Ring attention's block loops over ``shards`` shards of one sequence
    held on one device (the rotation moves the list), causal and not:
    the forward against K3 over the whole sequence, the backward (from the
    ring's own output and logsumexp) against K7 over the whole sequence,
    within ``RING_RTOL``/``RING_ATOL_SHARE``/``RING_LSE_ATOL``. The ring
    launches K3 and K7 once per visible block: n(n + 1)/2 causal (n
    diagonal, none for future blocks), n^2 not. The shape is
    ``RING_SHAPE``, bf16, from seed 0."""
    from qgemm_tpu_torch.ops import cuda as kernels
    from qgemm_tpu_torch.ops.cuda.flash_attention import flash_attention_fwd
    from qgemm_tpu_torch.ops.cuda.flash_attention_bwd import flash_attention_bwd
    from qgemm_tpu_torch.parallel.ring_attention import (local_rotation, ring_backward_blocks,
                                                         ring_forward_blocks)
    b, h, s, d, shards = (RING_SHAPE[k] for k in ("b", "h", "s", "d", "shards"))
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    q, k, v, dout = (torch.randn((b, h, s, d), generator=g, device="cuda").to(torch.bfloat16)
                     for _ in range(4))
    cut = lambda t: [c.contiguous() for c in t.chunk(shards, dim=2)]
    qs, ks, vs, gs = cut(q), cut(k), cut(v), cut(dout)
    pos = list(range(shards))
    res = {"shape": dict(RING_SHAPE, dtype="bfloat16"), "cases": {}}
    for causal in (True, False):
        kernels.reset_launch_counts()
        outs, lses = ring_forward_blocks(qs, ks, vs, pos, shards, causal, local_rotation)
        fwd = kernels.launch_counts()
        grads = ring_backward_blocks(qs, ks, vs, outs, lses, gs, pos, shards, causal,
                                     local_rotation)
        torch.cuda.synchronize()
        bwd = kernels.launch_counts()
        want_out, want_lse = flash_attention_fwd(q, k, v, causal)
        want = flash_attention_bwd(q, k, v, want_out, want_lse, dout, causal)
        blocks = shards * (shards + 1) // 2 if causal else shards * shards
        row = {"k3_launches": fwd["flash_attention"], "k7_launches": bwd["flash_attention_bwd"],
               "blocks": blocks}
        checks = [("out", torch.cat(outs, dim=2), want_out)]
        checks += [(n, torch.cat(gr, dim=2), w) for n, gr, w in zip(("dq", "dk", "dv"),
                                                                    grads, want)]
        failures = []
        for name, got, ref in checks:
            scale = float(ref.float().abs().max())
            beyond = excess(got, ref, RING_RTOL)
            row[name] = {"max_abs_err": max_err(got, ref), "max_ref": scale,
                         "beyond_rtol": beyond, "tol": RING_ATOL_SHARE * scale}
            if not beyond <= RING_ATOL_SHARE * scale:
                failures.append(name)
        row["lse_max_abs_err"] = max_err(torch.cat(lses, dim=2), want_lse)
        if row["lse_max_abs_err"] > RING_LSE_ATOL:
            failures.append("lse")
        if (fwd["flash_attention"], bwd["flash_attention_bwd"]) != (blocks, blocks):
            failures.append("launches")
        row["failures"] = failures
        res["cases"]["causal" if causal else "full"] = row
        del outs, lses, grads, want_out, want_lse, want
    from qgemm_tpu_torch.utils.profiling import bench_ms
    ring = lambda: ring_forward_blocks(qs, ks, vs, pos, shards, True, local_rotation)
    # the ring's merges launch more kernels than the launch queue holds
    res["ms_causal_ring_forward"] = bench_ms(ring, queue_ahead=False)
    res["ms_causal_k3_whole"] = bench_ms(lambda: flash_attention_fwd(q, k, v, True))
    res["failures"] = {c: r["failures"] for c, r in res["cases"].items() if r["failures"]}
    return res


def train_step_on_mesh(mesh) -> tuple:
    """One Adam step (the example's ``train_step``, lr ``TRAIN_LR``) of the
    ``train`` phase's model (GPT_6_7B's widths at ``TRAIN_LAYERS`` layers,
    seed 0, one fixed batch) un-meshed, and of its ``shard_model`` on
    ``mesh`` (a copy taken first) on the rank's ``shard_batch``: the loss
    and every updated parameter must equal the un-meshed step's bit for bit
    at p = 1 (the collectives identities); the meshed step's launches (K3
    and K7 once per layer) and collectives (per layer a SUM after W_O and
    FFN-down, in the backward one for each column layer's input and the
    head's, one per trainable parameter on the data axis; the head's
    gather). -> (the result, the un-meshed model after its step, the
    step's tokens)."""
    from qgemm_tpu_torch.examples.train_gpt_lm import train_step
    from qgemm_tpu_torch.models.gpt import GPT, GPT_6_7B
    from qgemm_tpu_torch.models.optim import Adam
    from qgemm_tpu_torch.ops import cuda as kernels
    from qgemm_tpu_torch.parallel import tp_ops
    from qgemm_tpu_torch.parallel.sharding import shard_batch, shard_model
    cfg = dataclasses.replace(GPT_6_7B, n_layers=TRAIN_LAYERS)
    batch, seq = TRAIN_BATCH, TRAIN_SEQ
    model = GPT.init(cfg, seed=0, device="cuda")
    local = shard_model(model, mesh)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    seqs = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=g, device="cuda")

    def one_step(m, tokens):
        params = [p for _, p in m.named_trainable()]
        opt = Adam(lr=TRAIN_LR)
        kernels.reset_launch_counts()
        tp_ops.reset_collective_counts()
        t = time.perf_counter()
        _, loss = train_step(m, params, opt, opt.init(params), tokens)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        for p in params:
            p.grad = None
        return loss, params, kernels.launch_counts(), tp_ops.collective_counts(), ms
    loss0, p0, _, _, ms0 = one_step(model, seqs)
    loss1, p1, launches, coll, ms1 = one_step(local, shard_batch(seqs, mesh))
    n = cfg.n_layers
    want_coll = {"all_reduce_sum": 2 * n + 4 * n + 1 + len(p1), "all_gather": 1}
    equal = [bool(torch.equal(a, b)) for a, b in zip(p0, p1)]
    res = {"model": f"GPT_6_7B widths, {n} layers, {cfg.dtype}", "batch": [batch, seq],
           "loss_un_meshed": float(loss0), "loss_mesh": float(loss1),
           "loss_bit_equal": bool(torch.equal(loss0, loss1)),
           "params_bit_equal": sum(equal), "params": len(equal),
           "max_param_diff": max(max_err(a, b) for a, b in zip(p0, p1)),
           "launches": {k: v for k, v in launches.items() if v},
           "collectives": {k: v for k, v in coll.items() if v},
           "collectives_expected": want_coll,
           "step_ms_un_meshed": ms0, "step_ms_mesh": ms1}
    failures = []
    if not (res["loss_bit_equal"] and all(equal)):
        failures.append("the meshed step differs from the un-meshed one")
    if (launches["flash_attention"], launches["flash_attention_bwd"]) != (n, n):
        failures.append(f"launches {res['launches']}")
    if {k: coll[k] for k in want_coll} != want_coll:
        failures.append(f"collectives {res['collectives']} != {want_coll}")
    res["failures"] = failures
    del local, p1
    gc.collect()
    return res, model, seqs[:, :-1]


def gpipe_one_stage(model, tokens) -> dict:
    """``pipeline_gpt_forward`` at one stage in ``GPIPE_MICRO`` microbatches
    against the model's sequential forward (logits within
    ``GPIPE_LOGIT_RTOL`` of the largest); K3 once per layer and
    microbatch."""
    from qgemm_tpu_torch.ops import cuda as kernels
    from qgemm_tpu_torch.parallel.mesh import make_mesh
    from qgemm_tpu_torch.parallel.pipeline import pipeline_gpt_forward
    pipe_mesh = make_mesh((1,), ("pipe",))
    with torch.no_grad():
        want = model(tokens)
        kernels.reset_launch_counts()
        got = pipeline_gpt_forward(model, tokens, mesh=pipe_mesh, n_microbatches=GPIPE_MICRO)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
    rel = max_err(got, want) / float(want.float().abs().max())
    res = {"stages": 1, "microbatches": GPIPE_MICRO, "tokens": list(tokens.shape),
           "rel_err": rel, "bit_equal": bool(torch.equal(got, want)),
           "launches": {k: v for k, v in launches.items() if v}}
    want_k3 = model.cfg.n_layers * GPIPE_MICRO
    res["failures"] = ([] if rel <= GPIPE_LOGIT_RTOL and launches["flash_attention"] == want_k3
                       else [f"logits {rel} (bound {GPIPE_LOGIT_RTOL}), K3 "
                             f"{launches['flash_attention']} (want {want_k3})"])
    return res


# the rest of parallelism across cards (``--tp-cards N``): each rank's
# readings against one card (the same seeds on the rank's own card); the
# data x model training step's bounds (stated before its first card run):
# the global loss within 1e-2 of the single card's, every parameter's
# gradient within 0.2 of the norm of its single-card slice (bf16 row SUMs
# across cards and the data axis' mean round otherwise, and a bias or gain
# summed over many tokens cancels: 0.034 in a rehearsal on 4 gloo ranks at
# tiny widths, where a skipped data-axis reduction read 1.27-1.50); the
# faults of ``PARALLEL_FAULTS``, each planted in a run of its own, must
# break them
CARDS_LOSS_RTOL, CARDS_GRAD_RTOL = 1e-2, 0.2


def _rel_norm(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


def _ring_cards(mesh, dev, fault: Optional[str] = None) -> dict:
    """Ring attention (``RING_SHAPE``'s sequence, causal) and Ulysses across
    the ``seq`` axis against K3 and K7 over the whole sequence on this
    card; the rank's shard within the ring's bounds."""
    from qgemm_tpu_torch.ops.cuda.flash_attention import flash_attention_fwd
    from qgemm_tpu_torch.ops.cuda.flash_attention_bwd import flash_attention_bwd
    from qgemm_tpu_torch.parallel.ring_attention import ring_attention, shard_sequence
    from qgemm_tpu_torch.parallel.ulysses import ulysses_attention
    b, h, s, d = (RING_SHAPE[k] for k in ("b", "h", "s", "d"))
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    q, k, v, dout = (torch.randn((b, h, s, d), generator=g, device=dev).to(torch.bfloat16)
                     for _ in range(4))
    want_out, want_lse = flash_attention_fwd(q, k, v, True)
    want = (want_out,) + flash_attention_bwd(q, k, v, want_out, want_lse, dout, True)
    cut = lambda t: shard_sequence(t, mesh)
    res = {}
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        if fault is not None and name == "ulysses":
            continue
        shards = [cut(t).requires_grad_(True) for t in (q, k, v)]
        with planted(fault):
            out = fn(*shards, mesh=mesh, causal=True)
            out.backward(cut(dout))
        row = {}
        for item, got, ref in zip(("out", "dq", "dk", "dv"),
                                  (out,) + tuple(t.grad for t in shards), want):
            ref = cut(ref)
            scale = float(ref.float().abs().max())
            row[item] = {"beyond_rtol": excess(got, ref, RING_RTOL),
                         "tol": RING_ATOL_SHARE * scale, "bit_equal": bool(torch.equal(got, ref))}
        row["within"] = all(r["beyond_rtol"] <= r["tol"] for r in row.values())
        res[name] = row
    return res


def _moe_cards(mesh, dev, prompts) -> tuple:
    """The expert-sharded MoE GPT (2 experts a card at p = 4) across the
    cards: its prompts' logits, the dense graph engine's transcripts and a
    decode step's collectives. -> (the readings, the whole model)."""
    from qgemm_tpu_torch.models.gpt import GPT, GPTConfig
    from qgemm_tpu_torch.parallel.sharding import shard_quantized_model
    from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
    model = GPT.init_quantized(GPTConfig(**MOE_CFG), seed=0, device=dev)
    local = shard_quantized_model(model, mesh)
    out = {"logits": prompt_logits(local, prompts),
           "experts_per_rank": local.blocks[0].ffn.n_local_experts}
    engine = ContinuousBatchingEngine(local, **DENSE_ENGINE, mesh=mesh)
    make_reqs = lambda: [Request(prompt=p, max_new_tokens=16) for p in prompts]
    reqs = make_reqs()
    drive(engine, reqs, "parallel_cards moe mesh")
    out["transcripts"] = [r.generated for r in reqs]
    out["collectives"] = decode_step_collectives(engine, make_reqs)
    del engine
    gc.collect()
    torch.cuda.synchronize()
    return out, model


def _train_cards(mesh, dev, fault: Optional[str] = None) -> dict:
    """The ``train`` phase's model, one step's loss and gradients on the
    (data, model) mesh (each rank its ``shard_batch`` slice) against the
    single-card step's on this card."""
    from qgemm_tpu_torch.examples.train_gpt_lm import loss_fn
    from qgemm_tpu_torch.models.gpt import GPT, GPT_6_7B
    from qgemm_tpu_torch.parallel.mesh import axis_rank
    from qgemm_tpu_torch.parallel.sharding import data_mean, shard_batch, shard_model
    cfg = dataclasses.replace(GPT_6_7B, n_layers=TRAIN_LAYERS)
    model = GPT.init(cfg, seed=0, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    seqs = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1), generator=g,
                         device=dev)
    with planted(fault):
        local = shard_model(model, mesh)
    loss = loss_fn(local, shard_batch(seqs, mesh))
    loss.backward()
    glob = float(data_mean(loss, mesh))
    want = loss_fn(model, seqs)
    want.backward()
    full = dict(model.named_trainable())
    r = axis_rank(mesh, "model")
    errs = {}
    for name, p in local.named_trainable():
        ref = full[name].grad
        for dim, (a, b) in enumerate(zip(ref.shape, p.shape)):
            if a != b:
                ref = ref.narrow(dim, r * b, b)
        errs[name] = _rel_norm(p.grad, ref)
    res = {"loss": glob, "loss_single_card": float(want),
           "loss_rel": abs(glob - float(want)) / abs(float(want)),
           "grad_rel_max": max(errs.values()),
           "grad_rel_worst": max(errs, key=errs.get)}
    res["within"] = res["loss_rel"] <= CARDS_LOSS_RTOL and res["grad_rel_max"] <= CARDS_GRAD_RTOL
    del model, local, loss, want
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _gpipe_cards(mesh, dev, model, tokens, want, fault: Optional[str] = None) -> dict:
    from qgemm_tpu_torch.parallel.pipeline import pipeline_gpt_forward
    with planted(fault), torch.no_grad():
        got = pipeline_gpt_forward(model, tokens, mesh=mesh, n_microbatches=GPIPE_MICRO)
    rel = max_err(got, want) / float(want.float().abs().max())
    return {"rel_err": rel, "within": rel <= GPIPE_LOGIT_RTOL,
            "bit_equal": bool(torch.equal(got, want))}


# which part each planted fault is read in
CARDS_FAULT_PARTS = {"ring_future_visible": "ring", "ring_block_local_lse": "ring",
                     "ep_expert_offset": "ep_layer", "pipeline_tick": "gpipe",
                     "data_grad_skipped": "train"}


def _ep_layer_cards(mesh, layer, x, fault: Optional[str] = None) -> dict:
    """``ep_moe_forward`` of a rank's ``shard_moe`` of ``layer`` on ``x`` (the
    same on every rank) against the whole layer on this card."""
    from qgemm_tpu_torch.parallel.expert import ep_moe_forward, shard_moe
    local = shard_moe(layer, mesh)
    with planted(fault), torch.no_grad():
        got = ep_moe_forward(x, local, mesh)
        want = layer(x)
    return {"bit_equal": bool(torch.equal(got, want)), "max_abs_err": max_err(got, want)}


def parallel_cards_worker(rank: int, world: int, out: str) -> None:
    """One rank of ``--tp-cards``' second world: ring and Ulysses over a
    ``seq`` mesh, the expert-sharded MoE GPT over (1, N) (its prompts'
    logits against this card's, its transcripts and a decode step's
    collectives), its first layer through ``ep_moe_forward`` and a2a over an
    ``expert`` mesh, the data x model training step over (2, N/2), GPipe
    over N stages of GPT_6_7B's widths at 2 N layers, each against this
    card alone; then each fault of ``CARDS_FAULT_PARTS`` planted in its
    part. Writes the rank's readings."""
    from qgemm_tpu_torch.models.gpt import GPT, GPT_6_7B
    from qgemm_tpu_torch.parallel import tp_ops
    from qgemm_tpu_torch.parallel.expert import ep_moe_forward_a2a, shard_moe
    from qgemm_tpu_torch.parallel.mesh import make_mesh
    dev = torch.device("cuda", torch.cuda.current_device())
    stage = lambda what: print(f"parallel_cards rank {rank}: {what} at {time.perf_counter():.1f}",
                               file=sys.stderr, flush=True)
    meshes = {"seq": make_mesh((world,), ("seq",)), "model": make_mesh((1, world)),
              "expert": make_mesh((world,), ("expert",)), "pipe": make_mesh((world,), ("pipe",)),
              "train": make_mesh((2, world // 2) if world % 2 == 0 else (1, world))}
    res = {"rank": rank, "train_mesh": list(meshes["train"].mesh.shape), "faults": {}}
    t = time.perf_counter()
    res["ring"] = _ring_cards(meshes["seq"], dev)
    res["seconds"] = {"ring": time.perf_counter() - t}
    stage("ring done")
    # the MoE GPT: the prompts' logits against this card's un-meshed model
    t = time.perf_counter()
    rng = np.random.default_rng(0)
    prompts = [p for p, _ in dense_requests(GPT_6_7B, rng)[:TP_REQUESTS]]
    moe, model = _moe_cards(meshes["model"], dev, prompts)
    want_logits = prompt_logits(model, prompts)
    # reported, not judged: a router near a tie sends a token to another
    # expert once the attention's SUM across cards rounds otherwise (0.199
    # of the largest on four H100s, where the dense TP GPT moves 0.02)
    res["moe"] = dict(moe, logits=logit_reading(moe.pop("logits"), want_logits))
    # the first layer alone: ep_moe_forward on the same 64 tokens on every
    # rank against the whole layer on this card (bit for bit: each token's
    # SUM adds its two choices' partials and zeros), and a2a on the rank's
    # 16 against the whole layer on those tokens alone (a2a's per-source
    # capacity)
    layer = model.blocks[0].ffn
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    x = torch.randn((64, MOE_CFG["d_model"]), generator=g, device=dev).to(torch.bfloat16)
    res["ep_layer"] = _ep_layer_cards(meshes["expert"], layer, x)
    xr = x.chunk(world)[rank]
    tp_ops.reset_collective_counts()
    with torch.no_grad():
        got = ep_moe_forward_a2a(xr, shard_moe(layer, meshes["expert"]), meshes["expert"])
        ref = layer(xr)
    res["a2a"] = {"bit_equal": bool(torch.equal(got, ref)), "max_abs_err": max_err(got, ref),
                  "all_to_all": tp_ops.collective_counts()["all_to_all"]}
    res["seconds"]["moe"] = time.perf_counter() - t
    stage("moe done")
    t = time.perf_counter()
    res["train"] = _train_cards(meshes["train"], dev)
    res["seconds"]["train"] = time.perf_counter() - t
    stage("train done")
    t = time.perf_counter()
    gcfg = dataclasses.replace(GPT_6_7B, n_layers=2 * world)
    gpt = GPT.init(gcfg, seed=0, device=dev)
    g.manual_seed(5)
    toks = torch.randint(0, gcfg.vocab_size, (4, TRAIN_SEQ), generator=g, device=dev)
    with torch.no_grad():
        gwant = gpt(toks)
    res["gpipe"] = _gpipe_cards(meshes["pipe"], dev, gpt, toks, gwant)
    res["seconds"]["gpipe"] = time.perf_counter() - t
    stage("gpipe done")
    for fault, part in CARDS_FAULT_PARTS.items():
        if part == "ring":
            ring = _ring_cards(meshes["seq"], dev, fault)["ring"]
            r, reading = ring["within"], {k: v["beyond_rtol"] / v["tol"]
                                          for k, v in ring.items() if k != "within"}
        elif part == "ep_layer":
            ep = _ep_layer_cards(meshes["expert"], layer, x, fault)
            r, reading = ep["bit_equal"], ep["max_abs_err"]
        elif part == "gpipe":
            pipe = _gpipe_cards(meshes["pipe"], dev, gpt, toks, gwant, fault)
            r, reading = pipe["within"], pipe["rel_err"]
        else:
            train = _train_cards(meshes["train"], dev, fault)
            r, reading = train["within"], train["grad_rel_max"]
        res["faults"][fault] = {"part": part, "caught": not r, "reading": reading}
    stage("faults done")
    with open(Path(out) / f"parallel_cards-{rank}.json", "w") as f:
        json.dump(res, f)
    del model, gpt, layer
    gc.collect()
    torch.cuda.synchronize()


def parallel_cards(n: int) -> dict:
    """``parallel_cards_worker`` on ``n`` cards: the ring, Ulysses, training
    and GPipe within their bounds and the EP layer and a2a bit for bit on
    every rank, the MoE GPT's decode step with its collectives and the
    ranks' transcripts agreeing (its logits against one card reported), and
    every planted fault caught."""
    from qgemm_tpu_torch.utils.testing import run_world
    out = Path(__file__).resolve().parent / "build" / f"parallel_cards.{os.getpid()}"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    try:
        run_world(parallel_cards_worker, n, str(out), str(out), device=None, timeout=400)
    except TimeoutError:
        emit({"phase": "parallel_cards", "timed_out": True, "ranks_written": {
            f.name: json.loads(f.read_text()) for f in sorted(out.glob("parallel_cards-*"))}})
        raise
    ranks = [json.loads((out / f"parallel_cards-{r}.json").read_text()) for r in range(n)]
    shutil.rmtree(out, ignore_errors=True)
    res = {"phase": "parallel_cards", "p": n, "seconds": time.perf_counter() - t0,
           "ranks": ranks}
    emit(res)
    bad = []
    want_coll = ep_collectives_per_step(MOE_CFG["n_layers"])
    for r in ranks:
        for part in ("train", "gpipe"):
            if not r[part]["within"]:
                bad.append((r["rank"], part))
        if not r["ep_layer"]["bit_equal"]:
            bad.append((r["rank"], "ep_layer"))
        if {k: r["moe"]["collectives"][k] for k in want_coll} != want_coll:
            bad.append((r["rank"], "moe collectives"))
        for name, row in r["ring"].items():
            if not row["within"]:
                bad.append((r["rank"], name))
        if not r["a2a"]["bit_equal"] or r["a2a"]["all_to_all"] != 2:
            bad.append((r["rank"], "a2a"))
        bad += [(r["rank"], f) for f, c in r["faults"].items() if not c["caught"]]
    if any(r["moe"]["transcripts"] != ranks[0]["moe"]["transcripts"] for r in ranks):
        bad.append("the ranks' MoE transcripts differ")
    if bad:
        raise AssertionError(f"parallel_cards: {bad}")
    return res


def parallel_launches(par: dict, wrappers) -> dict:
    """A kernel's launches on ``phase_parallel``'s paths (its wrappers'
    counts summed): each EP engine's run and decode step, the a2a layer, the
    ring's forward and backward (causal and not), the meshed training step,
    the one-stage GPipe forward; the nonzero ones."""
    count = lambda d: sum((d or {}).get(w, 0) for w in wrappers)
    out = {}
    for label, e in par["ep_serving"]["engines"].items():
        out[f"ep_serving {label}"] = count(e["launches"])
        out[f"ep_serving {label} per decode step"] = count(e["launches_per_decode_step"])
    out["ep_a2a one layer"] = count(par["ep_serving"]["a2a"]["launches"])
    for case, row in par["ring"]["cases"].items():
        out[f"ring {case} forward"] = (row["k3_launches"] if "flash_attention" in wrappers
                                       else 0)
        out[f"ring {case} backward"] = (row["k7_launches"] if "flash_attention_bwd" in wrappers
                                        else 0)
    out["train dp x tp step"] = count(par["train"]["launches"])
    out["gpipe one stage"] = count(par["gpipe"]["launches"])
    return {k: v for k, v in out.items() if v}


def phase_parallel() -> dict:
    """The rest of parallelism on this card at world 1 over NCCL
    (``tp_group``): ``ep_serving`` (the expert-sharded MoE GPT served
    meshed and un-meshed, dense and paged graph engines; a2a EP on one
    layer), ``ring_blocks_one_device`` (ring attention's block loops over
    four shards of one sequence against K3 and K7 over the whole),
    ``train_step_on_mesh`` (dp x tp at (1, 1)) and ``gpipe_one_stage``.
    Each part's launch counts are set to 0 just before it runs and read
    just after. Fails if any part failed."""
    t0 = time.perf_counter()
    res = {"phase": "parallel", "p": 1, "backend": "nccl", "seconds_by_part": {}}
    mesh, store = tp_group()
    try:
        def part(name, fn):
            t = time.perf_counter()
            out = fn()
            res["seconds_by_part"][name] = time.perf_counter() - t
            res[name] = out[0] if isinstance(out, tuple) else out
            emit({"phase": "parallel", "part": name, **res[name]})   # each as it ends
            torch.cuda.empty_cache()
            return out
        part("ep_serving", lambda: ep_serving(mesh))
        part("ring", ring_blocks_one_device)
        _, model, tokens = part("train", lambda: train_step_on_mesh(mesh))
        part("gpipe", lambda: gpipe_one_stage(model, tokens))
        del model, tokens
        gc.collect()
        torch.cuda.synchronize()
    finally:
        tp_close(store)
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    torch.cuda.empty_cache()
    failures = {k: res[k]["failures"] for k in ("ring", "train", "gpipe") if res[k]["failures"]}
    if failures:
        raise AssertionError(f"parallel: {failures}")
    return res


# ---------------------------------------------------------------------------
# the JAX package's surface on the card, and the port's dryrun
# ---------------------------------------------------------------------------

SURFACE_TRACE_STEPS = 4
# the kernel families the traced decode step must show: K1's GEMV and its
# pre-pass, K2 (DECODE_FAMILIES' names, those device_spans reads)
SURFACE_TRACE_FAMILIES = ("gemv", "gemm_prepass", "dense_decode")
GRAPH_LAUNCH_NAMES = ("cudaGraphLaunch", "cuGraphLaunch")


def traced_decode(engine, profiled: dict) -> dict:
    """``utils.profiling.trace`` around ``SURFACE_TRACE_STEPS`` steady
    decode steps of a graph engine with every slot busy. The trace file
    must name the kernels of ``SURFACE_TRACE_FAMILIES`` and the decode
    graph's launches (``GRAPH_LAUNCH_NAMES``, the host calls that replay
    it); its device time a step (the union of its kernel intervals) is
    reported beside ``profile_decode``'s for the same engine
    (``profiled``), not judged."""
    from qgemm_tpu_torch.serving.engine import Request
    from qgemm_tpu_torch.utils.profiling import trace
    rng = np.random.default_rng(9)
    for _ in range(engine.max_slots):
        engine.submit(Request(prompt=long_prompt(rng, engine.model.cfg.vocab_size),
                              max_new_tokens=SURFACE_TRACE_STEPS + 8))
    for _ in range(3):          # admits every slot, then two warm steps
        engine.step()
    if engine.book.num_active != engine.max_slots:
        raise AssertionError("surface trace: not every slot is decoding")
    log_dir = Path(__file__).resolve().parent / "build" / f"trace.{os.getpid()}"
    t0 = time.perf_counter()
    with trace(str(log_dir)) as t:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(SURFACE_TRACE_STEPS):
            engine.step()
        torch.cuda.synchronize()
        steps_ms = (time.perf_counter() - t1) * 1e3
    context_ms = (time.perf_counter() - t0) * 1e3
    if engine.book.num_active != engine.max_slots:
        raise AssertionError("surface trace: a slot finished inside the window")
    engine.run_to_completion()
    file_bytes = os.path.getsize(t.path)
    with open(t.path) as f:
        events = json.load(f)["traceEvents"]
    shutil.rmtree(log_dir, ignore_errors=True)
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
                   if e.get("cat") == "kernel")
    busy_us, end, by_name = 0.0, float("-inf"), {}
    for a, b, name in spans:        # union of the kernels' intervals, as device_spans
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    fams = {fam: sum(us for name, us in by_name.items() if any(p in name for p in pats))
            / 1e3 / SURFACE_TRACE_STEPS for fam, pats in DECODE_FAMILIES.items()}
    graph_launches = sum(1 for e in events if e.get("name", "").startswith(GRAPH_LAUNCH_NAMES))
    res = {"steps": SURFACE_TRACE_STEPS, "file_bytes": file_bytes, "events": len(events),
           "kernel_events": len(spans), "graph_launches": graph_launches,
           "kernel_ms_per_step": busy_us / 1e3 / SURFACE_TRACE_STEPS,
           "profile_decode_kernel_ms_per_step": profiled["kernel_ms_per_step"],
           "wall_ms_per_step_traced": steps_ms / SURFACE_TRACE_STEPS,
           # the profiler's start and stop and the file's export included
           "context_wall_ms": context_ms,
           "profile_decode_wall_ms_per_step_untraced": profiled["wall_ms_per_step_untraced"],
           "family_ms_per_step": fams}
    res["failures"] = [f"no {fam} kernel in the trace" for fam in SURFACE_TRACE_FAMILIES
                       if not fams[fam]]
    if graph_launches < SURFACE_TRACE_STEPS:
        res["failures"].append(f"{graph_launches} graph launches in the trace, "
                               f"{SURFACE_TRACE_STEPS} steps")
    return res


def backend_checks() -> dict:
    """``backend=`` of the four public int8 matmuls at bench.py's 2048^3
    (``phase_gemm_protocol``'s operands; the outlier routes on x with
    the dims of ``OUTLIER_DIMS`` below 2048 scaled by 20, past the 6.0
    threshold): "kernel" and
    "auto" give equal bits and launch their kernels (K1; K9 and K1 for the
    dynamic products), "plain" launches no counted kernel and stays within
    ``gemm_protocol``'s rule of the kernel's result (1e-6 of its largest
    output); ``matmul_fn`` set to the prequant product gives the outlier
    route's bits; "kernel" on a CPU tensor and an unknown backend raise."""
    from qgemm_tpu_torch.ops import cuda as kernels
    from qgemm_tpu_torch.ops.quantize import (quantize_weights, quantized_matmul,
                                              quantized_matmul_outlier,
                                              quantized_matmul_prequant,
                                              quantized_matmul_prequant_outlier)
    m = n = k = 2048
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    x = torch.rand((m, k), generator=g, device="cuda") * 2 - 1
    w = torch.rand((k, n), generator=g, device="cuda") * 2 - 1
    xo = x.clone()
    xo[:, [d for d in OUTLIER_DIMS if d < k]] *= 20.0
    wq = quantize_weights(w)
    k1, k9 = {"quantized_matmul": 1}, {"col_quantize": 1, "quantized_matmul": 1}
    cases = {"quantized_matmul_prequant": (
                 lambda b: quantized_matmul_prequant(x, wq, backend=b), k1),
             "quantized_matmul": (lambda b: quantized_matmul(x, w, backend=b), k9),
             "quantized_matmul_prequant_outlier": (
                 lambda b: quantized_matmul_prequant_outlier(xo, wq, backend=b), k1),
             "quantized_matmul_outlier": (
                 lambda b: quantized_matmul_outlier(xo, w, backend=b), k9)}

    def launched(fn):
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, {kk: v for kk, v in kernels.launch_counts().items() if v}

    res, failures = {"m": m, "n": n, "k": k, "rows": {}}, []
    for name, (fn, want) in cases.items():
        got = {b: launched(lambda: fn(b)) for b in ("kernel", "auto", "plain")}
        ref = got["kernel"][0]
        row = {f"{b}_launches": got[b][1] for b in got}
        row.update(kernel_equals_auto=bool(torch.equal(ref, got["auto"][0])),
                   plain_max_abs_err=max_err(got["plain"][0], ref),
                   plain_tolerance=1e-6 * float(ref.abs().max()))
        if row["kernel_launches"] != want or row["auto_launches"] != want:
            failures.append(f"{name}: kernel/auto launched {row['kernel_launches']}, "
                            f"{row['auto_launches']}, not {want}")
        if row["plain_launches"]:
            failures.append(f"{name}: plain launched {row['plain_launches']}")
        if not row["kernel_equals_auto"] or row["plain_max_abs_err"] > row["plain_tolerance"]:
            failures.append(f"{name}: {row}")
        res["rows"][name] = row
        del got, ref
    routed, route_launches = launched(lambda: quantized_matmul_prequant_outlier(
        xo, wq, matmul_fn=quantized_matmul_prequant))
    res["matmul_fn"] = {"equals_the_route": bool(torch.equal(
        routed, quantized_matmul_prequant_outlier(xo, wq))), "launches": route_launches}
    if not res["matmul_fn"]["equals_the_route"] or route_launches != k1:
        failures.append(f"matmul_fn: {res['matmul_fn']}")
    xc, wc = x[:8, :64].cpu(), w[:64, :16].cpu()
    calls = {"quantized_matmul_prequant": lambda b: quantized_matmul_prequant(
                 xc, quantize_weights(wc), backend=b),
             "quantized_matmul": lambda b: quantized_matmul(xc, wc, backend=b),
             "quantized_matmul_prequant_outlier": lambda b: quantized_matmul_prequant_outlier(
                 xc, quantize_weights(wc), backend=b),
             "quantized_matmul_outlier": lambda b: quantized_matmul_outlier(xc, wc, backend=b)}
    raised = {}
    for name, fn in calls.items():
        for b, err in (("kernel", RuntimeError), ("xla", ValueError)):
            try:
                fn(b)
                raised[f"{name} {b} on cpu"] = False
            except err:
                raised[f"{name} {b} on cpu"] = True
    try:
        quantized_matmul_prequant(x, wq, backend="pallas")
        raised["quantized_matmul_prequant pallas on cuda"] = False
    except ValueError:
        raised["quantized_matmul_prequant pallas on cuda"] = True
    res["raised"] = raised
    failures += [f"{case} did not raise" for case, r in raised.items() if not r]
    res["failures"] = failures
    return res


def phase_surface(trace_reading: Optional[dict] = None) -> dict:
    """The names the port gained for the JAX package's surface, on the
    card: ``backend_checks`` and ``profiling.trace`` around steady decode
    steps of the main path's graph engine (``traced_decode``; in the whole
    script taken inside ``decode_graph`` on its dense int8 graph engine and
    passed as ``trace_reading``, alone on an engine of its own). Fails on
    any failure."""
    t0 = time.perf_counter()
    res = {"phase": "surface", "backend": backend_checks()}
    if trace_reading is None:
        from qgemm_tpu_torch.models.gpt import GPT, GPT_6_7B
        model = GPT.init_quantized(GPT_6_7B, seed=0, device="cuda")
        engine = graph_engine(model, "graph", DENSE_ENGINE)
        trace_reading = traced_decode(engine, profile_decode(engine, np.random.default_rng(8)))
        del engine, model
        torch.cuda.empty_cache()
    res["trace"] = trace_reading
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    failures = res["backend"]["failures"] + res["trace"]["failures"]
    if failures:
        raise AssertionError(f"surface: {failures}")
    return res


# the kernels the dryrun must launch at world 1 (their wrappers' counts
# summed); K2, K8 and K9 are reported beside them
DRYRUN_MUST_LAUNCH = ("quantized_matmul", "flash_attention", "w4a8_matmul",
                      "paged_decode_attention", "paged_context_attention",
                      "flash_attention_bwd")
# each kernel's launch counters, by ``launch_counts``' names
KERNEL_WRAPPERS = {"paged_decode_attention": ("paged_decode_attention",
                                              "paged_decode_attention_ragged")}
# the dryrun's readings every rank must hold alike (tests/test_torch_dryrun.py)
DRYRUN_REPLICATED = ("train_loss", "pipeline_loss", "ep_loss", "prefix_hits", "preemptions",
                     "tp_column_err", "tp_row_err", "moe_sections")


def kernel_launches(counts: dict, name: str) -> int:
    return sum(counts.get(w, 0) for w in KERNEL_WRAPPERS.get(name, (name,)))


def phase_dryrun() -> dict:
    """``parallel/dryrun.run_dryrun`` (JAX's ``dryrun_multichip``) at
    world 1 over NCCL (``tp_group``), every section through the kernels:
    the launch counts are set to 0 just before it and read just after, and
    each kernel of ``DRYRUN_MUST_LAUNCH`` must have launched (a zero would
    say a section took a plain route on the card). The two MoE sections
    need two experts and run only across cards (``--tp-cards``)."""
    from qgemm_tpu_torch.ops import cuda as kernels
    from qgemm_tpu_torch.parallel.dryrun import run_dryrun
    t0 = time.perf_counter()
    _, store = tp_group()
    try:
        kernels.reset_launch_counts()
        readings = run_dryrun()
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        gc.collect()    # the engines' decode graphs, before the group goes
        torch.cuda.synchronize()
    finally:
        tp_close(store)
    res = {"phase": "dryrun", "p": 1, "backend": "nccl", "readings": readings,
           "launches": launches, "seconds": time.perf_counter() - t0}
    emit(res)
    torch.cuda.empty_cache()
    missing = [k for k in DRYRUN_MUST_LAUNCH if not kernel_launches(launches, k)]
    if missing:
        raise AssertionError(f"dryrun: no launch of {missing} at world 1: {launches}")
    return res


def dryrun_cards_worker(rank: int, world: int, out: str) -> None:
    """One rank of ``--tp-cards``' third world: ``run_dryrun`` across the
    cards, its launch counts set to 0 just before it; writes the readings."""
    from qgemm_tpu_torch.ops import cuda as kernels
    from qgemm_tpu_torch.parallel.dryrun import run_dryrun
    t = time.perf_counter()
    kernels.reset_launch_counts()
    readings = run_dryrun()
    torch.cuda.synchronize()
    res = {"rank": rank, "readings": readings, "seconds": time.perf_counter() - t,
           "launches": {k: v for k, v in kernels.launch_counts().items() if v}}
    with open(Path(out) / f"dryrun_cards-{rank}.json", "w") as f:
        json.dump(res, f)


def dryrun_cards(n: int) -> dict:
    """``run_dryrun`` on ``n`` cards, one rank each (JAX's
    ``dryrun_multichip(n)``): every rank must pass, hold the MoE sections,
    launch K8 and the kernels of ``DRYRUN_MUST_LAUNCH``, and agree with
    the others on every reading of ``DRYRUN_REPLICATED``."""
    from qgemm_tpu_torch.utils.testing import run_world
    out = Path(__file__).resolve().parent / "build" / f"dryrun_cards.{os.getpid()}"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    try:
        run_world(dryrun_cards_worker, n, str(out), str(out), device=None, timeout=400)
    except TimeoutError:
        emit({"phase": "dryrun_cards", "timed_out": True, "ranks_written": {
            f.name: json.loads(f.read_text()) for f in sorted(out.glob("dryrun_cards-*"))}})
        raise
    ranks = [json.loads((out / f"dryrun_cards-{r}.json").read_text()) for r in range(n)]
    shutil.rmtree(out, ignore_errors=True)
    res = {"phase": "dryrun_cards", "p": n, "seconds": time.perf_counter() - t0,
           "ranks": ranks}
    emit(res)
    first = ranks[0]["readings"]
    bad = [k for k in DRYRUN_REPLICATED
           if any(r["readings"][k] != first[k] for r in ranks)]
    for r in ranks:
        bad += [(r["rank"], k) for k in DRYRUN_MUST_LAUNCH + ("expert_matmul",)
                if not kernel_launches(r["launches"], k)]
        if not r["readings"]["moe_sections"]:
            bad.append((r["rank"], "MoE sections left out"))
    if bad:
        raise AssertionError(f"dryrun_cards: {bad}")
    return res


def sampled_routes_equal(model, kw: dict, make_reqs, label: str, make_engine=graph_engine,
                         routes=tuple(GRAPH_ROUTES)) -> dict:
    """8 of ``make_reqs``' requests sampled (temperature 0.8, top-p 0.95)
    through each of ``routes`` (the first the eager one; engines from
    ``make_engine(model, route, kw)``) with engine seed 5: the sampled
    graph (``torch.rand`` and ``torch.multinomial`` on the engine's
    generator, registered with the graph) must draw what the eager step
    draws, so the transcripts must be equal bit for bit; each graph engine
    captures its sampled mode once."""
    out = {}
    for route in routes:
        engine = make_engine(model, route, dict(kw, seed=5))
        reqs = make_reqs()[:8]
        for r in reqs:
            r.temperature, r.top_p = 0.8, 0.95
        run = drive(engine, reqs, f"{label} sampled {route}")
        out[route] = ([r.generated for r in reqs], run["graph"], engine.stats)
        del engine
    if any(toks != out[routes[0]][0] for toks, _, _ in out.values()):
        raise AssertionError(f"{label}: sampled transcripts differ between the routes")
    if any(g is not None and g["captures"] != 1 for _, g, _ in out.values()):
        raise AssertionError(f"{label}: sampled graph captures {out}")
    return {"requests": 8, "transcripts_equal": True,
            "graph_runs": {r: g for r, (_, g, _) in out.items()},
            "spec_acceptance": {r: st.get("spec_acceptance") for r, (_, _, st) in out.items()}}


def _requests_of(make_reqs, transcripts) -> list:
    """``make_reqs``' requests with ``transcripts`` as their generated
    tokens (for ``transcripts_match_generate``)."""
    reqs = make_reqs()
    for r, t in zip(reqs, transcripts):
        r.generated = list(t)
    return reqs


# ------------------------------------------------------------ speculation (A.7)
SPEC_GAMMA = 4
# The speculative engine's routes beside the plain engine replaying its
# decode graph: the round run eagerly (the engine's private ``_graphs =
# None``), replayed from its graph, and replayed four rounds a dispatch.
SPEC_ROUTES = ("plain_graph", "spec_eager", "spec_graph", "spec_graph_ms4")
# the host calls that queue device work per round, at most (a dispatch's
# graph launch, the ring index's reset, the ring's read; a page-table
# upload now and then)
SPEC_HOST_CALLS_PER_ROUND = 5
# kernel families of a round, by substrings of the kernels' names
SPEC_FAMILIES = {"draft_gemv_k4": ("w4a8_gemv_kernel",),
                 "verify_tiles_k1": ("qmm_wgmma_kernel",),
                 "verify_paged_k6": ("paged_context_mma_kernel",),
                 "gemm_prepass": ("row_quantize_kernel",),
                 "cublas_bf16": ("gemm", "gemv", "sm90_xmma", "cutlass", "Kernel2")}


def spec_engine(model, draft, route: str, kw: dict):
    """A ContinuousBatchingEngine with options ``kw`` on one of
    ``SPEC_ROUTES`` (the speculative ones with ``draft`` and
    ``SPEC_GAMMA``)."""
    from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine
    opts = dict(kw)
    if route != "plain_graph":
        opts.update(draft_model=draft, spec_gamma=SPEC_GAMMA)
    if route.endswith("ms4"):
        opts["multi_step"] = 4
    engine = ContinuousBatchingEngine(model, **opts)
    if route == "spec_eager":
        engine._graphs = None
    return engine


def spec_launches_expected(n_layers: int, paged: bool) -> dict:
    """What a round must launch: the W4A8 draft's GEMVs in each of its
    gamma + 1 decode steps (K4), the target's verify chunk's GEMMs on the
    tile route (K1, m = slots x (gamma + 1)) and, on the paged engine, its
    attention (K6); no decode attention kernel (the draft's float cache and
    the dense verify chunk take the plain composition) and no K3."""
    n_gemms = 6 * n_layers + 1
    return {"w4a8_matmul": (SPEC_GAMMA + 1) * n_gemms, "quantized_matmul": n_gemms,
            "paged_context_attention": n_layers if paged else 0, "decode_attention": 0,
            "paged_decode_attention": 0, "paged_decode_attention_ragged": 0,
            "flash_attention": 0}


def profile_spec(engine, rng, n_steps: int = 5, prompt=long_prompt) -> dict:
    """Where a steady speculative dispatch's time goes, 8 busy slots with
    prompts of ``prompt(rng, vocab)`` (default ~300 positions): four windows of ``n_steps`` engine steps (each a dispatch
    of ``multi_step`` or one rounds), the second traced by torch.profiler
    (CUDA activity), the fourth by CPU activity (the host's calls that
    queue device work, ``host_issued``). Per round: the untraced windows'
    wall, the device's kernel time (union of intervals), the idle share,
    host calls; tokens per round per slot, acceptance, tokens/s and ITL
    p50/p95 (one gap per dispatch) over the untraced windows. The requests
    are cancelled after the windows."""
    from torch.profiler import ProfilerActivity, profile

    from qgemm_tpu_torch.serving.engine import Request
    per_step = max(1, engine.multi_step)
    vocab = engine.model.cfg.vocab_size
    reqs = [Request(prompt=prompt(rng, vocab),
                    max_new_tokens=(SPEC_GAMMA + 1) * per_step * (4 * n_steps + 3) + 8)
            for _ in range(engine.max_slots)]
    for r in reqs:
        engine.submit(r)
    for _ in range(3):          # admits every slot, then two warm dispatches
        engine.step()
    gaps, untraced = [], {"ms": [], "tokens": 0, "rounds": 0, "drafted": 0, "accepted": 0}

    def window(record: bool) -> float:
        torch.cuda.synchronize()
        tok, rnd = engine.tokens_generated, engine.spec_device_rounds
        drf, acc = engine.spec_drafted, engine.spec_accepted
        t = last = time.perf_counter()
        for _ in range(n_steps):
            engine.step()
            now = time.perf_counter()
            if record:
                gaps.append(now - last)
            last = now
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        if record:
            untraced["ms"].append(ms)
            untraced["tokens"] += engine.tokens_generated - tok
            untraced["rounds"] += engine.spec_device_rounds - rnd
            untraced["drafted"] += engine.spec_drafted - drf
            untraced["accepted"] += engine.spec_accepted - acc
        return ms / (n_steps * per_step)

    window(True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced_ms = window(False)
    window(True)
    with profile(activities=[ProfilerActivity.CPU]) as hprof:
        window(False)
    host = host_issued(hprof, n_steps * per_step)
    if engine.book.num_active != engine.max_slots:
        raise AssertionError("spec profile window: a slot finished inside the windows")
    for r in reqs:
        engine.cancel(r.id)
    rounds = n_steps * per_step
    busy_us, by_name, n_spans = device_spans(prof)
    kernel_ms = busy_us / 1e3 / rounds
    wall_ms = sum(untraced["ms"]) / untraced["rounds"]
    families = {fam: sum(us for name, us in by_name.items() if any(p in name for p in pats))
                / 1e3 / rounds for fam, pats in SPEC_FAMILIES.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gap_ms = np.asarray(gaps) * 1e3
    return {"rounds_per_dispatch": per_step, "slots": engine.max_slots,
            "wall_ms_per_round_untraced": wall_ms, "wall_ms_per_round_traced": traced_ms,
            "kernel_ms_per_round": kernel_ms, "idle_share_untraced": 1.0 - kernel_ms / wall_ms,
            "tokens_per_round_per_slot": untraced["tokens"] / (untraced["rounds"]
                                                               * engine.max_slots),
            "acceptance": untraced["accepted"] / max(1, untraced["drafted"]),
            "tokens_per_s_untraced": untraced["tokens"] * 1e3 / sum(untraced["ms"]),
            "itl_p50_ms": float(np.percentile(gap_ms, 50)),
            "itl_p95_ms": float(np.percentile(gap_ms, 95)),
            "host_issued_ops_per_round": host["host_issued_ops_per_step"],
            "host_issued_by_name_per_round": host["host_issued_by_name_per_step"],
            "device_events_per_round": n_spans / rounds, "family_ms_per_round": families,
            "top_kernels_ms_per_round": {n[:80]: v / 1e3 / rounds for n, v in top}}


def spec_divergence(model, reqs, want: list, kw: dict) -> dict:
    """Where the speculative transcripts of ``reqs`` differ from the plain
    engine's (``want``): how many differ, and for the first that does, the
    step and the plain engine's logits there (the request served alone on
    its eager route, ``engine_alone_logits``): the margin of its token over
    the speculative one and its top-2 gap."""
    diffs = [first_difference(w, r.generated) for w, r in zip(want, reqs)]
    res = {"differ": sum(d is not None for d in diffs), "first_difference_steps": diffs,
           "first": None}
    i = next((i for i, d in enumerate(diffs) if d is not None), None)
    if i is not None:
        t = diffs[i]
        alone, logits = engine_alone_logits(model, reqs[i].prompt, reqs[i].max_new_tokens, kw)
        lg = logits[t]
        a, b = want[i][t], reqs[i].generated[t]
        top2 = torch.topk(lg, 2).values
        res["first"] = {"request": i, "step": t, "plain_token": a, "spec_token": b,
                        "plain_alone_equals_batched": alone == want[i],
                        "plain_margin": float(lg[a] - lg[b]),
                        "plain_top2_gap": float(top2[0] - top2[1])}
    return res


# the depth the ``spec`` phase runs GPT_6_7B at (full width): a quarter of
# its 32 layers, so that the whole script stays within
# its time with the seq2seq phases and the last shapes' checks; a round's
# launches scale with the layers
SPEC_LAYERS = 8


def phase_spec() -> dict:
    """Speculative decoding on the main path at full width: the int8
    GPT_6_7B target at ``SPEC_LAYERS`` of its 32 layers and its W4A8
    self-draft from the same float weights
    (``GPT.init_quantized`` with seed 0, int8 and ``bits=4``, each built
    block by block), gamma 4, 8 slots x 1,024 positions, serving the 16
    greedy ``dense_requests`` through the dense int8-cache engine and the
    paged int8 engine (``PAGED_ENGINE``) on each of ``SPEC_ROUTES``. Fails
    unless every speculative route launches per round what
    ``spec_launches_expected`` says, the eager, graph and ``multi_step=4``
    routes give equal transcripts bit for bit, and so do 8 sampled
    requests under one seed (``sampled_routes_equal``).
    Reports the speculative transcripts against the plain engine's
    (``spec_divergence``: random weights make greedy near-ties) and a
    steady window of the plain graph engine and of the two speculative
    graph routes (``profile_decode``, ``profile_spec``). The dense engine's
    ``spec_graph`` route runs again under the native scheduler
    (``native_twin``: its rounds through ``record_block``; the same
    transcripts, launches and stats as the Python bookkeeper's)."""
    from qgemm_tpu_torch.models.gpt import GPT, GPT_6_7B
    from qgemm_tpu_torch.serving.engine import Request
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(GPT_6_7B, n_layers=SPEC_LAYERS)
    model = GPT.init_quantized(cfg, seed=0, device="cuda")
    draft = GPT.init_quantized(cfg, seed=0, device="cuda", bits=4)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    dense = dense_requests(cfg, np.random.default_rng(0))
    make = lambda: [Request(prompt=p, max_new_tokens=n) for p, n in dense]
    res = {"phase": "spec", "model": f"GPT_6_7B at {SPEC_LAYERS} layers, int8 target, its "
                                      "W4A8 self-draft (seed 0)",
           "gamma": SPEC_GAMMA, "init_s": init_s, "requests": len(dense), "engines": {}}
    for label, kw in (("dense_int8", DENSE_ENGINE), ("paged_int8", PAGED_ENGINE)):
        want_round = spec_launches_expected(cfg.n_layers, label.startswith("paged"))
        runs, profiles, seconds = {}, {}, {}
        for route in SPEC_ROUTES:
            t_route = time.perf_counter()
            engine = spec_engine(model, draft, route, kw)
            reqs = make()
            run = drive(engine, reqs, f"spec {label} {route}")
            st = engine.stats
            runs[route] = {"transcripts": [r.generated for r in reqs], "stats": st,
                           "graph": run["graph"], "per_round": run["per_round"],
                           "per_decode": run["per_decode"],
                           "round_ms_mean": (float(np.mean(run["round_ms"]))
                                             if run["round_ms"] else None),
                           "rounds_timed": len(run["round_ms"])}
            if route == "spec_eager":
                runs[route]["reqs"] = reqs
            if route == "spec_graph":
                spec_graph = (reqs, run, st)
            if route != "spec_eager":
                profiles[route] = (profile_decode(engine, np.random.default_rng(8),
                                                  host_window=True)
                                   if route == "plain_graph"
                                   else profile_spec(engine, np.random.default_rng(8),
                                                     n_steps=5 if route == "spec_graph" else 2))
            del engine
            torch.cuda.empty_cache()
            seconds[route] = time.perf_counter() - t_route
        for route in SPEC_ROUTES[1:]:
            per = runs[route]["per_round"]
            if per is None or any(per.get(k, 0) != v for k, v in want_round.items()):
                raise AssertionError(f"spec {label} {route}: launches per round {per}, "
                                     f"expected {want_round}")
            if runs[route]["transcripts"] != runs["spec_eager"]["transcripts"]:
                raise AssertionError(f"spec {label}: {route}'s transcripts are not the eager "
                                     "round's")
        for route in ("spec_graph", "spec_graph_ms4"):
            p = profiles[route]
            if not p["host_issued_ops_per_round"] <= SPEC_HOST_CALLS_PER_ROUND:
                raise AssertionError(f"spec {label} {route}: "
                                     f"{p['host_issued_ops_per_round']} host calls a round")
            fams = p["family_ms_per_round"]
            need = ["draft_gemv_k4", "verify_tiles_k1"] + \
                (["verify_paged_k6"] if label.startswith("paged") else [])
            if not all(fams[f] > 0 for f in need):
                raise AssertionError(f"spec {label} {route}: the traced round lacks a kernel "
                                     f"family: {fams}")
        div = spec_divergence(model, runs["spec_eager"].pop("reqs"),
                              runs["plain_graph"]["transcripts"], kw)
        sampled = sampled_routes_equal(
            model, kw, make, f"spec {label}", routes=SPEC_ROUTES[1:],
            make_engine=lambda m, route, k: spec_engine(m, draft, route, k)) \
            if label == "dense_int8" else None
        keys = ("wall_ms_per_round_untraced", "kernel_ms_per_round", "idle_share_untraced",
                "tokens_per_round_per_slot", "acceptance", "tokens_per_s_untraced",
                "itl_p50_ms", "itl_p95_ms", "host_issued_ops_per_round",
                "device_events_per_round", "family_ms_per_round", "top_kernels_ms_per_round",
                "host_issued_by_name_per_round")
        plain_keys = ("wall_ms_per_step_untraced", "kernel_ms_per_step", "idle_share_untraced",
                      "tokens_per_s_untraced", "itl_p50_ms", "itl_p95_ms",
                      "host_issued_ops_per_step")
        native = None
        if label == "dense_int8":
            nat = native_twin(f"spec {label} spec_graph", model, kw, make, *spec_graph,
                              make_engine=lambda m, o: spec_engine(m, draft, "spec_graph", o))
            del nat["engine"]
            native = {"route": "spec_graph", "checked": nat["checked"],
                      "launches": nat["run"]["counts"],
                      "launches_per_round": nat["run"]["per_round"],
                      "walls": twin_readings(spec_graph[1], spec_graph[2], nat)}
        res["engines"][label] = {
            "native_twin": native,
            "launches_per_round": {k: v for k, v in runs["spec_graph"]["per_round"].items()
                                   if v},
            "launches_per_decode_step_plain": {k: v for k, v in
                                               runs["plain_graph"]["per_decode"].items() if v},
            "transcripts_equal_eager_graph_ms4": True,
            "vs_plain": div, "sampled": sampled,
            "stats": {r: {k: v for k, v in runs[r]["stats"].items()
                          if k in ("spec_rounds", "spec_acceptance", "tokens_per_s", "steps",
                                   "decode_steps", "itl_p50_ms", "itl_p95_ms",
                                   "decode_graph_captures", "decode_graph_replays")}
                      for r in SPEC_ROUTES},
            "round_ms_mean_in_run": {r: runs[r]["round_ms_mean"] for r in SPEC_ROUTES[1:]},
            "profiles": {r: {k: p[k] for k in (plain_keys if r == "plain_graph" else keys)}
                         for r, p in profiles.items()},
            "seconds_by_route": seconds}
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    del model, draft
    torch.cuda.empty_cache()
    return res


def serve_moe() -> dict:
    """The MoE GPT (``MOE_CFG``: scripts/bench_moe.py's configuration at
    full width and depth, random weights from seed 0) built straight into
    int8 by ``GPT.init_quantized`` — which must launch K9 twice per layer
    (w_up and w_down, all experts each) and no other kernel — then serving
    the 16 ``dense_requests`` through the engine (8 slots x 1024 positions,
    int8 KV cache). Every decode step must launch K8 48 times (up and down
    per layer), K1 97 (four attention projections per layer and lm_head),
    K2 24 and nothing else; every prefill K8 48, K3 24 and K1 97. The
    transcripts equal to isolated ``generate`` are counted, not required:
    the prompt's bucket padding competes for expert capacity in the
    engine's prefill, and not in ``generate``'s."""
    from qgemm_tpu_torch.models.gpt import GPT, GPTConfig
    from qgemm_tpu_torch.ops import cuda as kernels
    from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
    cfg = GPTConfig(**MOE_CFG)
    n_layers = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    model = GPT.init_quantized(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_launches = kernels.launch_counts()
    want = {kk: 0 for kk in init_launches}
    if init_launches != dict(want, col_quantize=2 * n_layers):
        raise AssertionError(f"moe init: launches {init_launches}, not K9 {2 * n_layers}")
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=p, max_new_tokens=n) for p, n in dense_requests(cfg, rng)]
    engine = ContinuousBatchingEngine(model, max_slots=8, max_seq_len=1024,
                                      quantized_cache=True, device="cuda")
    run = drive(engine, reqs, "moe_int8")
    counts, per_decode, step_ms = run["counts"], run["per_decode"], run["step_ms"]
    stats = engine.stats
    n_gemms = 4 * n_layers + 1
    want_decode = dict(want, expert_matmul=2 * n_layers, quantized_matmul=n_gemms,
                       decode_attention=n_layers)
    want_prefill = dict(want, expert_matmul=2 * n_layers, quantized_matmul=n_gemms,
                        flash_attention=n_layers)
    if per_decode != want_decode:
        raise AssertionError(f"moe_int8: launches per decode step {per_decode}, not "
                             f"{want_decode}")
    for n_adm, dd in run["admit_steps"]:
        prefill = {kk: dd[kk] - per_decode[kk] for kk in dd}
        if prefill != {kk: n_adm * v for kk, v in want_prefill.items()}:
            raise AssertionError(f"moe_int8: an admission step of {n_adm} prefills "
                                 f"launched {prefill} beside its decode step")
    matched = 0
    for r in reqs:
        iso = model.generate(torch.tensor([r.prompt], device="cuda"), r.max_new_tokens,
                             quantized_cache=True)[0].tolist()
        matched += iso == r.generated
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    drops = prefill_capacity_drops(model, [r.prompt for r in reqs])
    profile = profile_decode(engine, rng)
    res = {"phase": "serving_moe_int8",
           "model": "MoE GPT (scripts/bench_moe.py), int8 weights, int8 KV cache",
           "config": MOE_CFG, "params": model.num_params(), "init_s": round(init_s, 2),
           "init_launches": {kk: v for kk, v in init_launches.items() if v},
           "requests": len(reqs), "prompt_tokens": sum(len(r.prompt) for r in reqs),
           "stats": stats, "decode_steps_timed": len(step_ms),
           "decode_step_ms_mean": float(np.mean(step_ms)),
           "decode_step_ms_median": float(np.median(step_ms)),
           "launches": counts, "launches_per_decode_step": per_decode,
           "launches_per_prefill": want_prefill, "admission_steps": len(run["admit_steps"]),
           "peak_mem_gb": round(peak / 2**30, 2),
           "transcripts_match_generate": matched, "prefill_capacity_drops": drops,
           "decode_profile": profile}
    emit(res)
    del engine, model
    torch.cuda.empty_cache()
    return res


def prefill_capacity_drops(model, prompts) -> dict:
    """Why engine transcripts can differ from ``generate``'s: each prompt
    prefilled as the engine prefills it (zero-padded to its power-of-two
    bucket) and as ``generate`` does (its exact length), counting in every
    MoE layer the prompt tokens' expert choices that found their expert's
    capacity full. Summed over the prompts and layers."""
    from qgemm_tpu_torch.models.moe import _capacity, route_slots
    dropped = torch.zeros((), dtype=torch.int64, device="cuda")
    plen = {"n": 0}

    def count(mod, args):
        xf = args[0].reshape(-1, args[0].shape[-1]).float()
        cap = _capacity(xf.shape[0], mod.n_experts, mod.top_k, mod.capacity_factor)
        slot, _ = route_slots(xf, mod.router_w, mod.top_k, cap)
        full = slot.reshape(mod.top_k, -1)[:, :plen["n"]] == mod.n_experts * cap
        dropped.add_(full.sum())

    hooks = [blk.ffn.register_forward_pre_hook(count) for blk in model.blocks]
    out = {"prompts": len(prompts), "choices": 0}
    try:
        for label in ("bucket", "exact"):
            dropped.zero_()
            for p in prompts:
                plen["n"] = len(p)
                width = len(p) if label == "exact" else max(8, 1 << (len(p) - 1).bit_length())
                toks = torch.tensor([p + [0] * (width - len(p))], device="cuda")
                model.prefill(toks, model.init_cache(1, width, quantized=True))
            out[f"dropped_{label}"] = int(dropped)
        out["choices"] = sum(map(len, prompts)) * model.cfg.moe_top_k * len(model.blocks)
    finally:
        for hook in hooks:
            hook.remove()
    return out


def phase_numerics_moe() -> dict:
    """A 2-layer MoE model at ``MOE_CFG``'s widths, int8, float32 on both
    sides: the CPU's plain versions against the GPU's kernels (K1, K3, K8;
    K9 quantized the GPU copy's experts from the same float weights, and
    its codes must equal the CPU's). Prefill logits of a 64-token prompt
    and 4 greedy tokens. The two sides differ only in f32 summation order
    outside the int8 products (LayerNorm, attention, the router): a flipped
    activation code moves a logit by ~1e-3, a routing choice flipped at a
    near-tie changes that token's FFN output outright (the prefill's
    expert choices that differ are counted). The logits must agree as the dense
    phase's do (0.15 max abs, 3% relative RMS); the greedy tokens are
    reported."""
    from qgemm_tpu_torch.models.gpt import GPT, GPTConfig
    cfg = GPTConfig(**dict(MOE_CFG, n_layers=2, dtype="float32"))
    cpu_f = GPT.init(cfg, seed=3, device="cpu")
    gpu = copy.deepcopy(cpu_f).to("cuda").quantize()
    cpu = cpu_f.quantize()
    del cpu_f
    for bc, bg in zip(cpu.blocks, gpu.blocks):
        for name in ("w_up_qt", "w_up_c", "w_down_qt", "w_down_c"):
            if not bits_equal(getattr(bc.ffn, name), getattr(bg.ffn, name).cpu()):
                raise AssertionError(f"numerics_moe: K9's {name} differs from the CPU's")
    from qgemm_tpu_torch.models.moe import _capacity, route_slots
    slots = {"cpu": [], "gpu": []}

    def keep_slots(side):
        def hook(mod, args):
            xf = args[0].reshape(-1, args[0].shape[-1]).float()
            cap = _capacity(xf.shape[0], mod.n_experts, mod.top_k, mod.capacity_factor)
            slot = route_slots(xf, mod.router_w, mod.top_k, cap)[0]
            slots[side].append(torch.div(slot, cap, rounding_mode="floor").cpu())   # expert
        return hook

    hooks = [blk.ffn.register_forward_pre_hook(keep_slots(side))
             for side, model in (("cpu", cpu), ("gpu", gpu)) for blk in model.blocks]
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, size=(1, 64))
    lc, _ = cpu.prefill(torch.from_numpy(prompt), cpu.init_cache(1, 64, quantized=True))
    lg, _ = gpu.prefill(torch.from_numpy(prompt).cuda(), gpu.init_cache(1, 64, quantized=True))
    for hook in hooks:
        hook.remove()
    differ = sum(int((a != b).sum()) for a, b in zip(slots["cpu"], slots["gpu"]))
    a, b_ = lc[0, -1].double(), lg[0, -1].double().cpu()
    err = float((a - b_).abs().max())
    tc = cpu.generate(torch.from_numpy(prompt), 4, quantized_cache=True)[0].tolist()
    tg = gpu.generate(torch.from_numpy(prompt).cuda(), 4, quantized_cache=True)[0].tolist()
    rel_rms = float((a - b_).norm() / a.norm())
    res = {"phase": "numerics_moe", "layers": 2, "dtype": "float32", "max_abs_err": err,
           "rel_rms_err": rel_rms, "prefill_expert_choices_differ": differ,
           "prefill_expert_choices": sum(t.numel() for t in slots["cpu"]),
           "greedy_cpu": tc, "greedy_gpu": tg,
           "greedy_equal": sum(x == y for x, y in zip(tc, tg))}
    emit(res)
    if not (err <= 0.15 and rel_rms <= 0.03):
        raise AssertionError(f"numerics_moe: CPU/GPU logits differ: max {err}, "
                             f"rel rms {rel_rms}")
    del cpu, gpu
    torch.cuda.empty_cache()
    return res


def phase_gemm_protocol() -> dict:
    """bench.py's protocol on the card: M = N = K = 2048, uniform(-1, 1)
    f32 operands; the dynamic int8 path against its plain version (K1's
    parity rule) and its signed mean error against the exact f32 product; bench_ms times of f32 (TF32 off) and bf16
    torch.matmul, the dynamic int8 path (K9 column-quantizes W, then K1:
    TPU kernel row 3; one launch of each, checked by the launch counts),
    the prequantized int8 path (K1) and W4A8 (K4). Row 3's plain time runs
    both plain versions; its library time is one torch pipeline of the
    same function: row- and column-quantize, torch._int_mm, dequant."""
    from qgemm_tpu_torch.ops import cuda as kernels
    from qgemm_tpu_torch.ops.cuda.col_quantize import col_quantize_plain
    from qgemm_tpu_torch.ops.quantize import (QuantizedWeight, absmax_quantize, dequantize,
                                              quantize_weights, quantize_weights_int4,
                                              quantized_matmul, quantized_matmul_plain,
                                              quantized_matmul_prequant,
                                              quantized_matmul_prequant_w4)
    from qgemm_tpu_torch.utils.profiling import bench_ms
    m = n = k = 2048
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    x = torch.rand((m, k), generator=g, device="cuda") * 2 - 1
    w = torch.rand((k, n), generator=g, device="cuda") * 2 - 1
    exact = torch.matmul(x, w)
    kernels.reset_launch_counts()
    got = quantized_matmul(x, w)
    dynamic_launches = {kk: v for kk, v in kernels.launch_counts().items() if v}
    err = got - exact
    # the dynamic path against its plain version (K9's and K1's): the same
    # codes on both sides, so K1's parity rule, 1e-6 of the largest output
    ref = quantized_matmul_plain(x, QuantizedWeight(*col_quantize_plain(w)))
    plain_err, plain_tol = max_err(got, ref), 1e-6 * float(ref.abs().max())
    if dynamic_launches != {"col_quantize": 1, "quantized_matmul": 1} or plain_err > plain_tol:
        raise AssertionError(f"gemm_protocol: the dynamic path launched {dynamic_launches} "
                             f"(K9 and K1 once each expected), max err {plain_err} against "
                             f"its plain version (tolerance {plain_tol})")
    del ref
    wq, wq4 = quantize_weights(w), quantize_weights_int4(w)
    err4 = quantized_matmul_prequant_w4(x, wq4) - exact

    def int_mm_dynamic():
        xq, cx = absmax_quantize(x, axis=-1)
        wqd = quantize_weights(w)
        return dequantize(torch._int_mm(xq, wqd.q), cx, wqd.c)

    t = {"f32_ms": bench_ms(lambda: torch.matmul(x, w)),
         "bf16_ms": bench_ms(lambda: torch.matmul(x.to(torch.bfloat16), w.to(torch.bfloat16))),
         "int8_dynamic_ms": bench_ms(lambda: quantized_matmul(x, w)),
         "int8_dynamic_plain_ms": bench_ms(
             lambda: quantized_matmul_plain(x, QuantizedWeight(*col_quantize_plain(w)))),
         "int8_dynamic_library_ms": bench_ms(int_mm_dynamic),
         "int8_prequant_ms": bench_ms(lambda: quantized_matmul_prequant(x, wq)),
         "w4a8_ms": bench_ms(lambda: quantized_matmul_prequant_w4(x, wq4))}
    bms, by = bound(4 * (m * k + k * n + m * n), 2 * m * n * k, INT8_OPS)
    res = {"phase": "gemm_protocol", "m": m, "n": n, "k": k,
           "operands": "uniform(-1, 1) float32",
           "int8_dynamic_launches": dynamic_launches,
           "int8_dynamic_max_abs_err_vs_plain": plain_err,
           "int8_dynamic_tolerance_vs_plain": plain_tol,
           "int8_dynamic_signed_mean_err": float(err.mean()),
           "int8_dynamic_mean_abs_err": float(err.abs().mean()),
           "w4a8_signed_mean_err": float(err4.mean()),
           "w4a8_mean_abs_err": float(err4.abs().mean()),
           **t, "int8_dynamic_bound_ms": bms, "int8_dynamic_bound_by": by,
           "speedup_int8_dynamic_vs_f32": t["f32_ms"] / t["int8_dynamic_ms"],
           "speedup_int8_dynamic_vs_bf16": t["bf16_ms"] / t["int8_dynamic_ms"]}
    emit(res)
    return res


# The MNIST oracle's protocol (scripts/mnist_oracle.py, RESULTS_MNIST.md): the
# 784-16-10 MLP, SGD lr 0.01, batch 32 in order, 50 epochs, on MNIST.synthetic
# at noise 2.0 (8,192 train samples of seed 1, 2,048 test of seed 2), from the
# JAX package's initial weights of seed 1 (tests/fixtures/
# mnist_mlp_init_seed1.npz: the port's own PRNG draws others). JAX's fp32 test
# accuracy on it is 0.8984; the card's must land within MNIST_FP32_TOL of it,
# and the int8 model's within MNIST_INT8_TOL of the card's fp32.
MNIST_DIMS = [784, 16, 10]
MNIST_JAX_FP32 = 0.8984
MNIST_FP32_TOL = 0.015
MNIST_INT8_TOL = 0.01
MNIST_FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures"


def phase_mnist() -> dict:
    """A.10 on the card: the idx loader's native route against the numpy
    parser on the checked-in fixture; the MNIST example's ``train_mlp`` on
    the oracle's protocol (wall time; one more epoch traced for the device
    time a step); the int8 model (every layer through K1, 2 launches a
    forward, nothing else) and the fp32 one on the test split, held to the
    bounds above; K1 against its plain version (1e-6 of the largest output)
    and timed at the MLP's four shapes (M 32 and 2,048; K 784 to N 16, K 16
    to N 10), beside its bound."""
    from torch.profiler import ProfilerActivity, profile

    from qgemm_tpu_torch.data import native as data_native
    from qgemm_tpu_torch.data.mnist import (_SPLIT_FILES, MNIST, load_idx_images,
                                            load_idx_labels)
    from qgemm_tpu_torch.examples.train_mnist import evaluate, train_mlp
    from qgemm_tpu_torch.ops import cuda as kernels
    from qgemm_tpu_torch.ops.quantize import quantized_matmul_plain, quantized_matmul_prequant
    from qgemm_tpu_torch.utils.profiling import bench_ms
    t0 = time.perf_counter()
    data_native.build()
    loader = {}
    fixture = MNIST_FIXTURES / "mnist_mini"
    for split, (img, lbl) in _SPLIT_FILES.items():
        got = MNIST.load(str(fixture), split)                  # the native route
        want_x = load_idx_images(str(fixture / img), use_native=False)
        want_y = load_idx_labels(str(fixture / lbl), use_native=False)
        if not (np.array_equal(got.images, want_x) and np.array_equal(got.targets, want_y)):
            raise AssertionError(f"mnist: the native idx loader differs from the numpy "
                                 f"parser on mnist_mini/{split}")
        loader[split] = len(got)
    train = MNIST.synthetic(8192, seed=1, noise=2.0)
    test = MNIST.synthetic(2048, seed=2, noise=2.0)
    init = str(MNIST_FIXTURES / "mnist_mlp_init_seed1.npz")
    proto = dict(dims=MNIST_DIMS, batch=32, lr=0.01, seed=1, device="cuda", shuffle=False,
                 init=init)
    model, records, wall = train_mlp(train, epochs=50, **proto)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, traced_wall = train_mlp(train, epochs=1, **proto)
    busy_us, by_name, n_spans = device_spans(prof)
    steps = len(train) // 32
    tx = torch.as_tensor(test.images, device="cuda")
    ty = torch.as_tensor(test.targets.astype(np.int64), device="cuda")
    fp32 = evaluate(model, tx, ty)
    qmodel = model.quantize()
    kernels.reset_launch_counts()
    int8 = evaluate(qmodel, tx, ty)
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    if launches != {"quantized_matmul": 2}:
        raise AssertionError(f"mnist: an int8 forward launched {launches}, not K1 twice")
    if not (abs(fp32 - MNIST_JAX_FP32) <= MNIST_FP32_TOL and abs(int8 - fp32) <= MNIST_INT8_TOL):
        raise AssertionError(f"mnist: fp32 test accuracy {fp32} (JAX {MNIST_JAX_FP32} +- "
                             f"{MNIST_FP32_TOL}), int8 {int8} (+- {MNIST_INT8_TOL} of fp32)")
    k1 = []
    with torch.no_grad():
        hidden = torch.relu(qmodel.layers[0](tx))
        for m in (32, 2048):
            for layer, x in zip(qmodel.layers, (tx[:m], hidden[:m])):
                wq = layer.wq
                k, n = x.shape[1], layer.out_features
                got = quantized_matmul_prequant(x, wq)
                ref = quantized_matmul_plain(x, wq)
                err, tol = max_err(got, ref), 1e-6 * float(ref.abs().max())
                if not err <= tol:
                    raise AssertionError(f"mnist: K1 at m {m}, k {k}, n {n}: max err {err} "
                                         f"against its plain version (tolerance {tol})")
                bms, by = bound(4 * m * k + k * n + 4 * n + 4 * m * n, 2 * m * n * k, INT8_OPS)
                w_f32 = model.layers[0 if k == 784 else 1].w.detach()
                k1.append({"m": m, "k": k, "n": n, "max_abs_err": err, "tolerance": tol,
                           "ms": bench_ms(lambda: quantized_matmul_prequant(x, wq)),
                           "plain_ms": bench_ms(lambda: quantized_matmul_plain(x, wq)),
                           "bound_ms": bms, "bound_by": by, "library_ms": None,
                           "f32_matmul_ms": bench_ms(lambda: torch.matmul(x, w_f32))})
    res = {"phase": "mnist", "protocol": "784-16-10 MLP, SGD lr 0.01, batch 32 in order, 50 "
                                         "epochs, MNIST.synthetic noise 2.0 (8192 / 2048), "
                                         "JAX's initial weights of seed 1",
           "idx_loader_native_equals_numpy": loader,
           "train_acc_running_last_epoch": records[-1]["train_acc"],
           "loss_last_epoch": records[-1]["loss"], "fp32_test_acc": fp32,
           "int8_test_acc": int8, "jax_fp32_test_acc": MNIST_JAX_FP32,
           "int8_launches_per_forward": launches, "train_wall_s": wall,
           "train_steps": 50 * steps, "wall_ms_per_step": wall * 1e3 / (50 * steps),
           "device_ms_per_step_traced_epoch": busy_us / 1e3 / steps,
           "device_ops_per_step": n_spans / steps,
           "traced_epoch_wall_s": traced_wall, "k1_at_mlp_shapes": k1,
           "k1_library_note": "no one PyTorch call: torch._int_mm takes n a multiple of 8 "
                              "and m > 16",
           "seconds": time.perf_counter() - t0}
    emit(res)
    return res


def phase_quantize_demo() -> dict:
    """The quantize demo (examples/quantize_demo.py) on the card at its
    default case (the reference's 3x3 @ 3x2) and at 2048^3: each dynamic
    call launches K9 once and K1 once, its result is held to the plain
    versions' (K9's and K1's, on the same inputs) to 1e-6 of the largest
    output, and so is its printed mean error."""
    from qgemm_tpu_torch.examples.quantize_demo import inputs, main as demo_main
    from qgemm_tpu_torch.ops import cuda as kernels
    from qgemm_tpu_torch.ops.cuda.col_quantize import col_quantize_plain
    from qgemm_tpu_torch.ops.quantize import QuantizedWeight, quantized_matmul_plain
    cases = []
    for name, dims in (("reference_3x3_3x2", (0, 0, 0)), ("2048^3", (2048, 2048, 2048))):
        x, w = (t.cuda() for t in inputs(*dims, seed=0))
        kernels.reset_launch_counts()
        got = demo_main(["-m", str(dims[0]), "-n", str(dims[1]), "-k", str(dims[2])])
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        plain = quantized_matmul_plain(x, QuantizedWeight(*col_quantize_plain(w)))
        plain_err = float((got["exact"] - plain).abs().mean())
        tol = 1e-6 * float(plain.abs().max())
        err = max_err(got["quantized"], plain)
        if launches != {"col_quantize": 1, "quantized_matmul": 1} or not (
                err <= tol and abs(got["mean_error"] - plain_err) <= tol):
            raise AssertionError(f"quantize_demo {name}: launches {launches}; max err {err}, "
                                 f"mean error {got['mean_error']} against the plain "
                                 f"versions' {plain_err} (tolerance {tol})")
        cases.append({"case": name, "m_n_k": dims, "launches": launches,
                      "mean_error": got["mean_error"], "plain_mean_error": plain_err,
                      "max_abs_err_vs_plain": err, "tolerance": tol})
    res = {"phase": "quantize_demo", "cases": cases}
    emit(res)
    return res


def phase_serving_int8() -> dict:
    """``serve``'s int8 run and its native twin alone (``--only``)."""
    return serve("int8", {}, used=("quantized_matmul", "decode_attention", "flash_attention"),
                 unused=("w4a8_matmul",), twin=True)


def phase_serving_paged() -> tuple:
    """``serve_paged`` alone (``--only``)."""
    return serve_paged()


def phase_numerics() -> None:
    """2 layers at full width: CPU float32 plain path vs GPU bf16 kernels,
    same int8 weights. Tolerance: bf16 activations carry ~2^-8 relative
    error through two blocks and may flip int8 activation codes; the
    logits (std ~0.6) must agree to 0.15 max abs and 3% relative RMS, and
    the top-1 token must agree unless the CPU logits tie it within 0.15."""
    from qgemm_tpu_torch.models.gpt import GPT, GPT_6_7B
    cfg = dataclasses.replace(GPT_6_7B, n_layers=2, dtype="float32")
    cpu = GPT.init(cfg, seed=3, device="cpu").quantize()
    gpu = copy.deepcopy(cpu)
    gpu.cfg = dataclasses.replace(cfg, dtype="bfloat16")
    for p in gpu.parameters():
        p.data = p.data.to(torch.bfloat16)
    gpu = gpu.to("cuda")
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, size=(1, 128))
    lc, _ = cpu.prefill(torch.from_numpy(prompt), cpu.init_cache(1, 128, quantized=True))
    lg, _ = gpu.prefill(torch.from_numpy(prompt).cuda(),
                        gpu.init_cache(1, 128, quantized=True))
    a, b_ = lc[0, -1].double(), lg[0, -1].double().cpu()
    err = float((a - b_).abs().max())
    rel_rms = float((a - b_).norm() / a.norm())
    top_cpu, top_gpu = int(a.argmax()), int(b_.argmax())
    tie_gap = float(a[top_cpu] - a[top_gpu])
    emit({"phase": "numerics", "max_abs_err": err, "rel_rms_err": rel_rms,
          "top1_cpu": top_cpu, "top1_gpu": top_gpu, "top1_gap_cpu_logits": tie_gap})
    if not (err <= 0.15 and rel_rms <= 0.03):
        raise AssertionError(f"CPU/GPU logits differ: max {err}, rel rms {rel_rms}")
    if top_cpu != top_gpu and tie_gap > 0.15:
        raise AssertionError(f"top-1 differs: cpu {top_cpu} gpu {top_gpu} gap {tie_gap}")


def phase_outlier_numerics() -> dict:
    """2 layers at full width, float32, outlier dims planted: the relative
    RMS error of the last position's logits against the unquantized model,
    for int8 and int4 weights, without and with the outlier split
    (threshold 6.0). The split must bring the error down for both."""
    from qgemm_tpu_torch.models.gpt import GPT, GPT_6_7B
    cfg = dataclasses.replace(GPT_6_7B, n_layers=2, dtype="float32")
    model = GPT.init(cfg, seed=5, device="cuda")
    plant_outlier_dims(model)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, size=(1, 128))).cuda()
    errs = {}
    with torch.no_grad():
        ref = model.forward(tokens)[0, -1].double()
        for label, qkw in (("int8", {}), ("int8_outlier", {"outlier_threshold": 6.0}),
                           ("int4", {"bits": 4}),
                           ("int4_outlier", {"bits": 4, "outlier_threshold": 6.0})):
            got = model.quantize(**qkw).forward(tokens)[0, -1].double()
            errs[label] = float((got - ref).norm() / ref.norm())
    res = {"phase": "outlier_numerics", "layers": 2, "outlier_dims_planted": OUTLIER_DIMS,
           "rel_rms_err_vs_float": errs}
    emit(res)
    for bits in ("int8", "int4"):
        if not errs[f"{bits}_outlier"] < errs[bits]:
            raise AssertionError(f"outlier split did not lower the {bits} logits' error: {errs}")
    del model
    torch.cuda.empty_cache()
    return res


# The training phase: GPT_6_7B's widths at 4 of its 32 layers (32 layers of
# bf16 weights and gradients with f32 Adam moments need ~80 GB before any
# activation), one fixed batch of 4 x 2048 tokens
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 4, 4, 2048, 1e-4
TRAIN_TIMED_STEPS = 5

# The induction runs of ``train_model`` (the example's defaults: batch 16,
# seq_len 128, vocab 64, 2 layers, d_ff 512, lr 3e-3; 1,500 steps).
# ``jax_cpu_acc``: the held-out copy accuracy of the JAX package's
# examples/train_gpt_lm.py with the same flags on the CPU. d128_h4 is the
# example's own default (head_dim 32); d256_h4 stalls at the uniform loss
# there (ln 64 for 1,500 steps); d128_h2 (head_dim 64) learns the task.
INDUCTION_STEPS = 1500
INDUCTION_RUNS = {"d128_h4": {"d_model": 128, "n_heads": 4, "jax_cpu_acc": 1.0},
                  "d256_h4": {"d_model": 256, "n_heads": 4, "jax_cpu_acc": 0.0159},
                  "d128_h2": {"d_model": 128, "n_heads": 2, "jax_cpu_acc": 0.9995}}


def train_kernel_counts(per_step: list, n_layers: int, label: str) -> dict:
    """Every training step launched K3 and K7 once per layer and no other
    kernel of the port (a float model trains through cuBLAS GEMMs)."""
    want = {k: 0 for k in per_step[0]}
    want.update(flash_attention=n_layers, flash_attention_bwd=n_layers)
    bad = [d for d in per_step if d != want]
    if bad:
        raise AssertionError(f"{label}: a step launched {bad[0]}, not {want}")
    return want


def step_profile(fn) -> dict:
    """One call of ``fn`` (a training step) traced by torch.profiler (CUDA
    activity): its host wall time (synchronised; it carries the profiler's
    host cost, so the idle share is an upper bound), the union of its
    device kernels' intervals, and the time by kernel family."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    busy_us, by_name, n_spans = device_spans(prof)
    families = {"k7_flash_bwd": ("flash_bwd", "delta_kernel"), "k3_flash_fwd": ("flash_fwd",),
                "gemm": ("nvjet", "gemm", "xmma", "cutlass"),
                "elementwise": ("elementwise",), "reduce": ("reduce",),
                "index_scatter_sort": ("index", "scatter", "gather", "sort", "Sort"),
                "layer_norm": ("layer_norm",)}
    fam_ms = {f: 0.0 for f in (*families, "other")}
    for name, us in by_name.items():
        f = next((f for f, keys in families.items() if any(kk in name for kk in keys)),
                 "other")
        fam_ms[f] += us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms_traced": wall_ms, "kernel_ms": busy_us / 1e3,
            "idle_share_traced": 1.0 - busy_us / 1e3 / wall_ms, "device_events": n_spans,
            "kernel_ms_by_family": fam_ms,
            "top_kernels_ms": {n[:80]: v / 1e3 for n, v in top}}


def train_run(cfg=None, timed: int = TRAIN_TIMED_STEPS, label: str = "train",
              model_name: str = "GPT_6_7B widths, 4 of 32 layers") -> tuple:
    """The training path at full width: GPT_6_7B's widths (vocab 50272,
    d_model 4096, 32 heads x 128, d_ff 16384, bf16, max_seq_len 2048) at
    ``TRAIN_LAYERS`` layers, or ``cfg``, random weights from seed 0, one
    fixed batch of 4 x 2048 random tokens (and their next tokens), Adam at
    lr 1e-4 through the example's ``train_step`` (GPT.forward, the bf16
    cross-entropy and its analytic gradient, backward through K7, Adam in
    place): one warm-up step, ``timed`` steps timed on the host clock (each
    synchronised), then one step traced for the device's idle share. The
    launch counts are set to 0 just before the steps and read just after.
    Returns (the result line, each step's launches)."""
    from qgemm_tpu_torch.examples.train_gpt_lm import train_step
    from qgemm_tpu_torch.models.gpt import GPT, GPT_6_7B
    from qgemm_tpu_torch.models.optim import Adam
    from qgemm_tpu_torch.ops import cuda as kernels
    cfg = cfg or dataclasses.replace(GPT_6_7B, n_layers=TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = GPT.init(cfg, seed=0, device="cuda")
    params = [p for _, p in model.named_trainable()]
    opt = Adam(lr=TRAIN_LR)
    box = {"state": opt.init(params)}
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    seqs = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1), generator=g,
                         device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def step():
        box["state"], box["loss"] = train_step(model, params, opt, box["state"], seqs)

    losses, step_ms, per_step = [], [], []
    kernels.reset_launch_counts()
    for i in range(1 + timed + 1):
        before = kernels.launch_counts()
        if i <= timed:
            torch.cuda.synchronize()
            t = time.perf_counter()
            step()
            torch.cuda.synchronize()
            if i:
                step_ms.append((time.perf_counter() - t) * 1e3)
        else:
            prof = step_profile(step)
        losses.append(float(box["loss"]))
        per_step.append({k: v - before[k] for k, v in kernels.launch_counts().items()})
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median(step_ms))
    res = {"phase": label, "model": f"{model_name}, bf16, random weights",
           "params": sum(p.numel() for p in params), "init_s": round(init_s, 2),
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "optimizer": f"Adam lr {TRAIN_LR}",
           "losses": losses, "loss_steps": f"warm-up, {timed} timed, traced",
           "step_ms": step_ms, "step_ms_median": med,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med * 1e3,
           "peak_mem_gb": round(peak / 2**30, 2), "launches": counts,
           "launches_per_step": per_step[0], "traced_step": prof}
    del model, params, opt, box, seqs
    torch.cuda.empty_cache()
    return res, per_step


def phase_train() -> dict:
    """``train_run``, failing unless every loss is finite, the loss falls,
    and every step launched K3 and K7 once per layer and no other kernel."""
    res, per_step = train_run()
    emit(res)
    losses = res["losses"]
    train_kernel_counts(per_step, TRAIN_LAYERS, "train")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train: a loss is not finite: {losses}")
    if not (losses[TRAIN_TIMED_STEPS] < losses[1] and losses[-1] < losses[0]):
        raise AssertionError(f"train: the loss did not fall: {losses}")
    return res


def phase_train_induction() -> tuple:
    """``train_model`` to convergence on the copy task, on the card, for each
    of ``INDUCTION_RUNS``: loss first -> last, held-out copy accuracy and
    wall time, launch counts set to 0 just before each run and read just
    after (K3 and K7 once per layer per step, K3 again for the held-out
    forward). Fails if a run's accuracy is below the JAX package's at the
    same flags minus 0.05. Returns (results, the d128_h2 model)."""
    from qgemm_tpu_torch.examples.train_gpt_lm import train_model
    from qgemm_tpu_torch.ops import cuda as kernels
    results, served = {}, None
    for label, run in INDUCTION_RUNS.items():
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        model, st = train_model(steps=INDUCTION_STEPS, d_model=run["d_model"],
                                n_heads=run["n_heads"], device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = kernels.launch_counts()
        n_layers = model.cfg.n_layers
        res = {"phase": f"train_induction_{label}", "steps": INDUCTION_STEPS,
               "config": {"d_model": run["d_model"], "n_heads": run["n_heads"],
                          "head_dim": run["d_model"] // run["n_heads"], "layers": n_layers,
                          "d_ff": model.cfg.d_ff, "batch": 16, "seq_len": 128, "vocab": 64,
                          "lr": 3e-3},
               **st, "jax_cpu_heldout_acc": run["jax_cpu_acc"], "wall_s": wall,
               "steps_per_s": INDUCTION_STEPS / wall, "launches": counts}
        emit(res)
        if not (counts["flash_attention_bwd"] == n_layers * INDUCTION_STEPS
                and counts["flash_attention"] == n_layers * (INDUCTION_STEPS + 1)):
            raise AssertionError(f"{label}: launches {counts}, not {n_layers} K3 and K7 "
                                 f"per step")
        if not (np.isfinite(st["loss_last"]) and st["heldout_acc"] >= run["jax_cpu_acc"] - 0.05):
            raise AssertionError(f"{label}: held-out copy accuracy {st['heldout_acc']} below "
                                 f"the JAX package's {run['jax_cpu_acc']} - 0.05")
        results[label] = res
        if label == "d128_h2":
            served = model
        else:
            del model
    return results, served


def phase_train_serve(model) -> dict:
    """The trained copy model quantized to int8 (``.quantize()``) and served
    by ``ContinuousBatchingEngine(quantized_cache=True)``: 16 held-out copy
    sequences, each prompt the first half and the first token of the second
    half, the rest of the second half decoded greedily. Prints the served
    copy accuracy and the float model's (its greedy ``generate``), and how
    many transcripts equal the float model's. Fails unless the engine went
    through K1, K2 and K3, its transcripts equal the int8 model's own
    ``generate`` (int8 cache), and its accuracy is within 0.05 of the
    float model's."""
    from qgemm_tpu_torch.examples.train_gpt_lm import batch_iter
    from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
    seq_len, vocab = 128, 64
    half = (seq_len + 1) // 2
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    seqs = next(batch_iter(g, 16, seq_len, vocab))
    prompts, targets = seqs[:, :half + 1], seqs[:, half + 1:]
    n_new = targets.shape[1]
    qm = model.quantize()
    engine = ContinuousBatchingEngine(qm, max_slots=8, max_seq_len=model.cfg.max_seq_len,
                                      quantized_cache=True, device="cuda")
    reqs = [Request(prompt=p.tolist(), max_new_tokens=n_new) for p in prompts]
    run = drive(engine, reqs, "train_serve")
    served = torch.tensor([r.generated for r in reqs], device="cuda")
    acc = float((served == targets).float().mean())
    matched_int8 = transcripts_match_generate("train_serve", qm, reqs)
    flt = model.generate(prompts, n_new)
    float_acc = float((flt == targets).float().mean())
    same_as_float = int((flt == served).all(dim=1).sum())
    counts = run["counts"]
    res = {"phase": "train_serve", "model": "train_induction d128_h2, int8 weights",
           "requests": len(reqs), "prompt_tokens": half + 1, "new_tokens": n_new,
           "served_copy_acc_int8": acc, "float_generate_copy_acc": float_acc,
           "transcripts_equal_float_generate": same_as_float,
           "transcripts_equal_int8_generate": matched_int8,
           "launches": counts, "launches_per_decode_step": run["per_decode"],
           "stats": engine.stats,
           "transcripts_first_two": [r.generated for r in reqs[:2]]}
    emit(res)
    if not all(counts[k] > 0 for k in ("quantized_matmul", "decode_attention",
                                       "flash_attention")):
        raise AssertionError(f"train_serve: a kernel of the path never launched: {counts}")
    if not acc >= float_acc - 0.05:
        raise AssertionError(f"train_serve: served accuracy {acc} vs float {float_acc}")
    del engine, qm
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------- the long copy model (C-c)
# The copy task at a length whose decode crosses three of the decode
# kernels' 128-position splits: the second half of a 384-token sequence
# copies the first, so decoding it attends to positions up to 383, and the
# copy's source lies in the first split. ``train_model`` (the example's
# batch, vocab and lr; d_model 128, 2 heads, 2 layers) trains it for
# LONG_COPY_STEPS steps; where a length does not reach LONG_COPY_MIN_ACC
# teacher-forced held-out accuracy, the next shorter one is trained (each
# >= 257 positions, so that decoding reaches a third split).
LONG_COPY_SEQ_LENS = (384, 320, 288, 257)
LONG_COPY_MODEL = dict(d_model=128, n_heads=2, n_layers=2)
LONG_COPY_STEPS = 3000
LONG_COPY_MIN_ACC = 0.95
# a served run's copy accuracy may fall at most this far below the
# teacher-forced held-out accuracy (a bound that depends on no decode kernel)
LONG_COPY_SLACK = 0.05
LONG_COPY_REQUESTS = 16
# The engines that serve the int8 model: (options, the decode kernel's
# source, whether the transcripts must equal the int8 model's ``generate``).
# The dense int8 cache decodes through K2; int8 pools of 128-position pages
# admit a prompt in chunks (K6) and decode through K5 a page a split; int4
# pools of 32-position pages decode through K5 four pages a split (other
# numerics than generate's int8 cache: held to the accuracy bound only).
LONG_COPY_ENGINES = {
    "dense_int8": (dict(quantized_cache=True), "decode_attention", True),
    "paged_int8_page128": (dict(paged=True, page_size=128, chunked_prefill=64,
                                prefix_cache=True), "paged_decode_attention", True),
    "paged_int4_page32": (dict(paged=True, page_size=32, chunked_prefill=64, kv_bits=4),
                          "paged_decode_attention", False),
}
# The same three engines decoding in blocks of four graph replays, and the
# dense engine admitting the prompts in 64-token chunks (its chunks past the
# first attend through the bf16 product, not K3: held to the accuracy bound
# only). Every engine decodes by graph replay.
LONG_COPY_ENGINES.update({f"{k}_ms4": (dict(kw, multi_step=4), kernel, exact)
                          for k, (kw, kernel, exact) in LONG_COPY_ENGINES.items()})
LONG_COPY_ENGINES["dense_int8_chunked64"] = (dict(quantized_cache=True, chunked_prefill=64),
                                             "decode_attention", False)
# The speculative engines (PR 14): the dense int8, paged int8 and paged int4
# engines with gamma 4 and each of two drafts (``LONG_COPY_DRAFTS``), and the
# dense one with its W4A8 draft four rounds a dispatch. Each decodes through
# its decode kernel while requests wait and speculates once none does
# (dense: the verify chunk through the bf16 composition; paged: K6).
LONG_COPY_DRAFTS = {
    # the model's own W4A8 copy: most proposals accepted
    "w4a8": lambda model: model.quantize(bits=4),
    # a random-weight model of its config, int8: almost none accepted, so
    # every round takes the rejection path
    "random": lambda model: type(model).init(model.cfg, seed=1, device="cuda").quantize()}
for _base in ("dense_int8", "paged_int8_page128", "paged_int4_page32"):
    _kw, _kernel, _exact = LONG_COPY_ENGINES[_base]
    for _draft in LONG_COPY_DRAFTS:
        LONG_COPY_ENGINES[f"{_base}_spec_{_draft}"] = (
            dict(_kw, draft=_draft, spec_gamma=SPEC_GAMMA), _kernel, _exact)
LONG_COPY_ENGINES["dense_int8_spec_w4a8_ms4"] = (
    dict(quantized_cache=True, draft="w4a8", spec_gamma=SPEC_GAMMA, multi_step=4),
    "decode_attention", True)


def long_copy_model(ckpt: Path) -> tuple:
    """The long copy model, reloaded from ``ckpt`` (and the JSON beside it)
    if it exists, else trained on the card (``LONG_COPY_SEQ_LENS`` in turn,
    until one reaches ``LONG_COPY_MIN_ACC``) and saved there. Returns (the
    float model, what was trained: its sequence length, config, every
    attempt's losses, held-out accuracy and seconds)."""
    from qgemm_tpu_torch.examples.train_gpt_lm import heldout_eval, train_model
    from qgemm_tpu_torch.models.gpt import GPT, GPTConfig
    from qgemm_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    meta = ckpt.with_suffix(".json")
    if ckpt.exists():
        info = json.loads(meta.read_text())
        template = GPT.init(GPTConfig(**info["config"]), seed=0, device="cuda")
        model = load_checkpoint(str(ckpt), template)
        info["heldout_acc_reloaded"] = heldout_eval(model, info["seq_len"], 64)[1]
        return model, info
    attempts = []
    for seq_len in LONG_COPY_SEQ_LENS:
        torch.cuda.synchronize()
        t = time.perf_counter()
        model, st = train_model(steps=LONG_COPY_STEPS, seq_len=seq_len, device="cuda",
                                **LONG_COPY_MODEL)
        torch.cuda.synchronize()
        attempts.append({"seq_len": seq_len, **st, "train_s": time.perf_counter() - t})
        if st["heldout_acc"] >= LONG_COPY_MIN_ACC:
            break
        del model
    else:
        raise AssertionError(f"long copy: no length reached {LONG_COPY_MIN_ACC} held-out "
                             f"accuracy in {LONG_COPY_STEPS} steps: {attempts}")
    info = {"seq_len": seq_len, "config": dataclasses.asdict(model.cfg),
            "steps": LONG_COPY_STEPS, "attempts": attempts, "heldout_acc": st["heldout_acc"]}
    save_checkpoint(str(ckpt), model)
    meta.write_text(json.dumps(info))
    return model, info


def long_copy_readings(ckpt: Path, only: Optional[str] = None) -> dict:
    """The long copy model (``long_copy_model``) quantized to int8 and
    serving ``LONG_COPY_REQUESTS`` held-out sequences (prompt: the first half
    and one token more; the rest decoded greedily) through each of
    ``LONG_COPY_ENGINES``, launch counts set to 0 just before each run and
    read just after, and the seconds it all took. Per engine: the copy
    accuracy against the true targets, how many transcripts equal the int8
    model's own ``generate`` (dense int8 cache), and for the first request
    that differs, the step and both sides' margins there (the engine's from
    the request served alone, without its draft); a speculative engine's
    rounds and acceptance. ``only`` keeps the engines whose name holds it.
    Judges nothing: ``phase_long_copy``, ``--decode-faults`` and
    ``--spec-faults`` hold the readings to their bounds."""
    from qgemm_tpu_torch.examples.train_gpt_lm import batch_iter
    from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
    t0 = time.perf_counter()
    model, info = long_copy_model(ckpt)
    seq_len = info["seq_len"]
    half = (seq_len + 1) // 2
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    seqs = next(batch_iter(g, LONG_COPY_REQUESTS, seq_len, model.cfg.vocab_size))
    prompts, targets = seqs[:, :half + 1], seqs[:, half + 1:]
    n_new = targets.shape[1]
    qm = model.quantize()
    dense = [greedy_logits(qm, p.tolist(), n_new) for p in prompts]
    for p, (toks, _) in zip(prompts[:2], dense):
        if qm.generate(p[None], n_new, quantized_cache=True)[0].tolist() != toks:
            raise AssertionError("long copy: the dense loop is not generate's")
    dense_acc = float((torch.tensor([t for t, _ in dense], device="cuda") == targets)
                      .float().mean())
    res = {"seq_len": seq_len, "prompt_tokens": half + 1, "new_tokens": n_new,
           "training": info, "generate_int8_copy_acc": dense_acc, "engines": {}}
    drafts = {}
    for label, (kw, kernel, _) in LONG_COPY_ENGINES.items():
        if only is not None and only not in label:
            continue
        engine_kw = dict(max_slots=8, device="cuda", **kw)
        draft = engine_kw.pop("draft", None)
        spec_kw = {}
        if draft is not None:
            if draft not in drafts:
                drafts[draft] = LONG_COPY_DRAFTS[draft](model)
            spec_kw = dict(draft_model=drafts[draft], spec_gamma=engine_kw.pop("spec_gamma"))
        engine = ContinuousBatchingEngine(qm, **engine_kw, **spec_kw)
        reqs = [Request(prompt=p.tolist(), max_new_tokens=n_new) for p in prompts]
        run = drive(engine, reqs, f"long_copy {label}")
        stats = engine.stats
        del engine
        served = torch.tensor([r.generated for r in reqs], device="cuda")
        diffs = [first_difference(toks, r.generated) for (toks, _), r in zip(dense, reqs)]
        counts = run["counts"]
        row = {"copy_acc": float((served == targets).float().mean()),
               "equal_to_generate": sum(t is None for t in diffs),
               "first_difference_steps": diffs,
               "decode_launches": {k: counts[k] for k in counts if "decode_attention" in k},
               "first_difference": None}
        if draft is not None:
            row.update(spec_rounds=stats.get("spec_rounds", 0),
                       spec_acceptance=stats.get("spec_acceptance"),
                       launches_per_round={k: v for k, v in (run["per_round"] or {}).items()
                                           if v})
        i = next((i for i, t in enumerate(diffs) if t is not None), None)
        if i is not None:
            t, (toks, d_logits) = diffs[i], dense[i]
            alone, e_logits = engine_alone_logits(qm, reqs[i].prompt, n_new, engine_kw)
            a, b = toks[t], reqs[i].generated[t]
            row["first_difference"] = {
                "request": i, "step": t, "generate_token": a, "engine_token": b,
                "generate_margin": float(d_logits[t][a] - d_logits[t][b]),
                "engine_alone_equals_batched": alone == reqs[i].generated,
                "engine_alone_margin": float(e_logits[t][b] - e_logits[t][a])}
        res["engines"][label] = row
    del model, qm, drafts
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    return res


def long_copy_failures(res: dict, fault_engines=None) -> list:
    """What of ``long_copy_readings``' result breaks its bounds: each
    engine's copy accuracy at least the teacher-forced held-out accuracy
    less ``LONG_COPY_SLACK``; the transcripts of the engines so marked equal
    to ``generate``'s; each engine launched its decode kernel (K2 or K5) and
    not the other. ``fault_engines`` (a fault run) limits the check to the
    accuracy bound of those engines."""
    floor = res["training"]["heldout_acc"] - LONG_COPY_SLACK
    bad = []
    for label, row in res["engines"].items():
        kernel, exact = LONG_COPY_ENGINES[label][1:]
        if fault_engines is not None:
            if label in fault_engines and row["copy_acc"] >= floor:
                bad.append(f"{label}: copy accuracy {row['copy_acc']} >= {floor}")
            continue
        if row["copy_acc"] < floor:
            bad.append(f"{label}: copy accuracy {row['copy_acc']} < {floor}")
        if exact and row["equal_to_generate"] != LONG_COPY_REQUESTS:
            bad.append(f"{label}: {row['equal_to_generate']} of {LONG_COPY_REQUESTS} "
                       f"transcripts equal generate's ({row['first_difference']})")
        if "spec_rounds" in row and not row["spec_rounds"] > 0:
            bad.append(f"{label}: no speculative round")
        launched = row["decode_launches"]
        other = "decode_attention" if kernel != "decode_attention" else "paged_decode"
        if not (sum(v for k, v in launched.items() if k.startswith(kernel)) > 0
                and not any(v for k, v in launched.items() if k.startswith(other))):
            bad.append(f"{label}: decode launches {launched}, not through {kernel}")
    return bad


def phase_long_copy() -> dict:
    """The long copy model (C-c): trained on the card and saved to a
    temporary .npz, then ``long_copy_readings``; fails on any of
    ``long_copy_failures``."""
    with tempfile.TemporaryDirectory() as tmp:
        res = {"phase": "long_copy", **long_copy_readings(Path(tmp) / "long_copy.npz")}
    res["copy_acc_floor"] = res["training"]["heldout_acc"] - LONG_COPY_SLACK
    emit(res)
    bad = long_copy_failures(res)
    if bad:
        raise AssertionError(f"long copy: {bad}")
    return res


# ------------------------------------------------------- shape limits (C-a, C-b)
def k1_epilogue_plain(x: torch.Tensor, qt: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """K1's function in its own epilogue order, (acc * (cx / 127^2)) * cw:
    K8's plain version on one expert (the two share int8_gemm.cuh)."""
    from qgemm_tpu_torch.ops.cuda.expert_matmul import grouped_quantized_matmul_plain
    return grouped_quantized_matmul_plain(x[None], qt[None], c.reshape(1, 1, -1))[0]


def phase_shape_limits() -> dict:
    """The shapes the port's kernels once raised on (K not a multiple of 16,
    head widths other than 64 and 128, Dv != D), each kernel against its
    plain version on the card. K1 (and the dynamic K9 + K1) at k 3, 17 and
    784, the reference quantize demo's 3x3 @ 3x2 first, and K8 at K 17: the
    wrappers zero-pad K, so each equals its plain version bit for bit; K4
    at the same K (packed to 128 and 896 rows) and rows, bit for bit too. K2,
    K5 and K6 at head_dim 32 and 2 (the caches at their true width), K3 and
    K7 at head_dim 32 and 2 and at D 32 / Dv 64: the parity phase's
    tolerances and reasons for each."""
    from qgemm_tpu_torch.ops.cuda.col_quantize import col_quantize_plain
    from qgemm_tpu_torch.ops.cuda.decode_attention import (decode_attention,
                                                           decode_attention_plain)
    from qgemm_tpu_torch.ops.cuda.expert_matmul import (grouped_quantized_matmul,
                                                        grouped_quantized_matmul_plain)
    from qgemm_tpu_torch.ops.cuda.flash_attention import (flash_attention_fwd,
                                                          flash_attention_plain)
    from qgemm_tpu_torch.ops.cuda.flash_attention_bwd import (flash_attention_bwd,
                                                              flash_attention_bwd_plain)
    from qgemm_tpu_torch.ops.cuda.paged_context_attention import paged_context_attention
    from qgemm_tpu_torch.ops.cuda.paged_decode_attention import paged_decode_attention_ragged
    from qgemm_tpu_torch.ops.kv_cache import quantize_kv
    from qgemm_tpu_torch.ops.quantize import (quantize_weights, quantize_weights_int4,
                                              quantized_matmul, quantized_matmul_prequant,
                                              quantized_matmul_prequant_w4, w4a8_matmul_plain)
    from qgemm_tpu_torch.serving.paged_cache import (paged_attention_reference,
                                                     paged_context_attention_reference)
    dev, bf16 = "cuda", torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    g_gemv = torch.Generator(device=dev)
    g_gemv.manual_seed(10)
    checks = []

    def held(ok: bool, what: str, got, ref, **row):
        checks.append(dict(check=what, max_abs_err=max_err(got, ref), **row))
        if not ok:
            raise AssertionError(f"shape_limits {what} {row}: max err {max_err(got, ref)}")

    # C-a: the demo's matrices (the reference's test_quantize.cu), then random
    x = torch.tensor([[2.0, -1.0, -1.0], [0.0, 3.0, 2.0], [-1.0, -1.0, 0.0]], device=dev)
    w = torch.tensor([[-1.0, 0.0], [0.0, -2.0], [-1.0, 2.0]], device=dev)
    qt, c = col_quantize_plain(w)
    got = quantized_matmul(x, w)
    held(bits_equal(got, k1_epilogue_plain(x, qt, c)), "dynamic_k9_k1_demo", got,
         k1_epilogue_plain(x, qt, c), k=3, exact=(x @ w).tolist(), quantized=got.tolist())
    for k in (3, 17, 784):
        w = torch.randn((k, 96), generator=g, device=dev) * 0.1
        wq = quantize_weights(w)
        qt, c = col_quantize_plain(w)
        wq4 = quantize_weights_int4(w)
        # m 1 and 16 (the GEMV's edges) draw from a generator of their own,
        # so the other checks keep their inputs
        for m, dt, gen in ((3, "float32", g), (8, "bfloat16", g), (40, "float32", g),
                           (40, "bfloat16", g), (1, "bfloat16", g_gemv),
                           (16, "float32", g_gemv)):
            x = torch.randn((m, k), generator=gen, device=dev).to(getattr(torch, dt))
            got, ref = quantized_matmul_prequant(x, wq), k1_epilogue_plain(x, wq.qt, wq.c)
            held(bits_equal(got, ref), "k1", got, ref, m=m, k=k, x_dtype=dt)
            got, ref = quantized_matmul(x, w), k1_epilogue_plain(x, qt, c)
            held(bits_equal(got, ref), "dynamic_k9_k1", got, ref, m=m, k=k, x_dtype=dt)
            got, ref = quantized_matmul_prequant_w4(x, wq4), w4a8_matmul_plain(x, wq4)
            held(bits_equal(got, ref), "k4", got, ref, m=m, k=k, x_dtype=dt)
    for c_rows in (8, 40):
        x = torch.randn((4, c_rows, 17), generator=g, device=dev)
        wt = torch.randint(-127, 128, (4, 48, 17), generator=g, device=dev, dtype=torch.int8)
        cw = torch.rand((4, 1, 48), generator=g, device=dev) + 0.1
        got = grouped_quantized_matmul(x, wt, cw, relu=True)
        ref = grouped_quantized_matmul_plain(x, wt, cw, relu=True)
        held(bits_equal(got, ref), "k8", got, ref, c=c_rows, k=17)

    # C-b: K2 over an int8 and a bf16 cache, MHA and GQA
    lengths = torch.tensor([1, 37, 200, 64], device=dev, dtype=torch.int32)
    for d in (32, 2):
        for hkv, cache in ((8, "int8"), (2, "int8"), (8, "bfloat16")):
            q = torch.randn((4, 8, 1, d), generator=g, device=dev).to(bf16)
            kf, vf = (torch.randn((4, hkv, 200, d), generator=g, device=dev) for _ in range(2))
            if cache == "int8":
                (kq, kc), (vq, vc) = quantize_kv(kf), quantize_kv(vf)
                args, kw = (q, kq, vq, lengths), {"kc": kc, "vc": vc}
            else:
                args, kw = (q, kf.to(bf16), vf.to(bf16), lengths), {}
            got, ref = decode_attention(*args, **kw), decode_attention_plain(*args, **kw)
            held(excess(got, ref, 2 ** -7) <= 5e-3, "k2", got, ref, d=d, hkv=hkv, cache=cache)
        # K5 (ragged entry) and K6 on int8 and int4 pools of width d
        for bits in (8, 4):
            lens = torch.tensor([0, 1, 130, 300], device=dev, dtype=torch.int32)
            cache, _ = random_paged_cache(60 + d + bits, lens.tolist(), 4, 32, bits, pps=12, d=d)
            q = torch.randn((4, 8, 1, d), generator=g, device=dev).to(bf16)
            live = lens > 0
            got = paged_decode_attention_ragged(q, cache, lens)
            ref = paged_attention_reference(q, cache, lens, compute_dtype=bf16)
            held(excess(got[live], ref[live], 2 ** -7) <= 5e-3 and not bool(got[~live].any()),
                 "k5", got[live], ref[live], d=d, bits=bits)
            offs = [0, 77]
            lens = torch.tensor([o + 64 for o in offs], device=dev, dtype=torch.int32)
            cache, _ = random_paged_cache(70 + d + bits, lens.tolist(), 4, 32, bits, pps=6, d=d)
            q = torch.randn((2, 8, 64, d), generator=g, device=dev).to(bf16)
            off = torch.tensor(offs, device=dev)
            got = paged_context_attention(q, cache, lens, off)
            ref = paged_context_attention_reference(q, cache, lens, off, compute_dtype=bf16)
            held(excess(got, ref, 2 ** -7) <= 5e-3, "k6", got, ref, d=d, bits=bits)
    # K3 forward and K7 backward: K3's and K7's parity tolerances
    for d, dv in ((32, 32), (2, 2), (32, 64)):
        for causal, dt in ((True, "bfloat16"), (False, "bfloat16"), (True, "float32")):
            dtype = getattr(torch, dt)
            q = torch.randn((2, 4, 150, d), generator=g, device=dev).to(dtype)
            k = torch.randn((2, 4, 170, d), generator=g, device=dev).to(dtype)
            v = torch.randn((2, 4, 170, dv), generator=g, device=dev).to(dtype)
            dout = torch.randn((2, 4, 150, dv), generator=g, device=dev).to(dtype)
            o, lse = flash_attention_fwd(q, k, v, causal=causal)
            ro, rl = flash_attention_plain(q, k, v, causal=causal)
            fwd_ok = (excess(o, ro, 2 ** -7) <= 1e-2 if dt == "bfloat16"
                      else max_err(o, ro) <= 1e-5) and max_err(lse, rl) <= 1e-4
            held(fwd_ok and tuple(o.shape) == (2, 4, 150, dv), "k3", o, ro, d=d, dv=dv,
                 causal=causal, dtype=dt, lse_max_abs_err=max_err(lse, rl))
            got = flash_attention_bwd(q, k, v, o, lse, dout, causal)
            ref = flash_attention_bwd_plain(q, k, v, o, lse, dout, causal)
            for name, a, r in zip(("dq", "dk", "dv"), got, ref):
                scale = float(r.float().abs().max())
                ok = (excess(a, r, 2 ** -7) <= 1e-3 * scale if dt == "bfloat16"
                      else max_err(a, r) <= 1e-5 * scale)
                held(ok and a.shape == r.shape, "k7", a, r, grad=name, d=d, dv=dv,
                     causal=causal, dtype=dt)
    wide_shape_checks(held)
    t_last = time.perf_counter()
    last_shape_checks(held)
    torch.cuda.synchronize()
    res = {"phase": "shape_limits", "n_checks": len(checks),
           "last_shape_checks_seconds": round(time.perf_counter() - t_last, 2),
           "checks": checks}
    emit(res)
    return res


# The widened attention shapes: head widths up to 256
# (true widths 160 and 256 in the compiled D 256), GQA groups that are no
# row tile of K2 and K5 (3, 7) or wider than one (16, 32, 71: passes of 8
# rows), and pages of 8 (and 24, sub-tiles of 8 in K6)
WIDE_WIDTHS = (160, 256)
WIDE_GROUPS = (3, 7, 16, 32, 71)
WIDE_PAGES = (8, 24)


def wide_shape_checks(held) -> None:
    """Each new instance against its plain version on the card, with the
    tolerances ``phase_shape_limits`` holds the narrower ones to (K2, K5,
    K6: 5e-3 beyond one bf16 rounding; K3: 1e-2 bf16, 1e-5 f32, lse 1e-4;
    K7: 1e-3 of the largest gradient bf16, 1e-5 f32): K2 (int8 and bf16
    caches) and K5 (int8 and int4 pools) at D 256 (widths 160 and 256) and
    at ``WIDE_GROUPS``; K5 and K6 at ``WIDE_PAGES``; K6 at D 256 on both
    pools; K3 and K7 at D 256 (causal and not, bf16 and f32, Dv != D; a bf16
    gradient beyond its rule passes by ``flash_edge_checks``' float64 rule,
    and is marked ``held_by_f64``). And
    K2 equals K5 bit for bit on the same int8 rows at g 7 and 71 (and at D
    256): one split body, the same passes. Draws come from a generator of
    their own, so the older checks keep theirs."""
    from qgemm_tpu_torch.ops.cuda.decode_attention import (decode_attention,
                                                           decode_attention_plain)
    from qgemm_tpu_torch.ops.cuda.flash_attention import (flash_attention_fwd,
                                                          flash_attention_plain)
    from qgemm_tpu_torch.ops.cuda.flash_attention_bwd import (flash_attention_bwd,
                                                              flash_attention_bwd_plain)
    from qgemm_tpu_torch.ops.cuda.paged_context_attention import paged_context_attention
    from qgemm_tpu_torch.ops.cuda.paged_decode_attention import paged_decode_attention_ragged
    from qgemm_tpu_torch.ops.kv_cache import quantize_kv
    from qgemm_tpu_torch.serving.paged_cache import (gather_slot_kv, paged_attention_reference,
                                                     paged_context_attention_reference)
    dev, bf16 = "cuda", torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(20)
    # (true width d, KV heads, query heads): D 256 in MHA-like and GQA
    # groups, then every group of WIDE_GROUPS at d 64 over one KV head and
    # g 7 at d 128 over 4 (Qwen2-7B's group)
    cases = ([(d, 2, 8) for d in WIDE_WIDTHS] + [(256, 1, 8), (256, 1, 7)]
             + [(64, 1, grp) for grp in WIDE_GROUPS] + [(128, 4, 28)])
    lengths = torch.tensor([1, 37, 200, 64], device=dev, dtype=torch.int32)
    for d, hkv, hq in cases:
        for cache in ("int8", "bfloat16"):
            q = torch.randn((4, hq, 1, d), generator=g, device=dev).to(bf16)
            kf, vf = (torch.randn((4, hkv, 200, d), generator=g, device=dev) for _ in range(2))
            if cache == "int8":
                (kq, kc), (vq, vc) = quantize_kv(kf), quantize_kv(vf)
                args, kw = (q, kq, vq, lengths), {"kc": kc, "vc": vc}
            else:
                args, kw = (q, kf.to(bf16), vf.to(bf16), lengths), {}
            got, ref = decode_attention(*args, **kw), decode_attention_plain(*args, **kw)
            held(excess(got, ref, 2 ** -7) <= 5e-3, "k2_wide", got, ref, d=d, hkv=hkv, hq=hq,
                 cache=cache)
        for bits in (8, 4):
            lens = torch.tensor([0, 1, 130, 300], device=dev, dtype=torch.int32)
            pc, _ = random_paged_cache(200 + d + hq + bits, lens.tolist(), hkv, 32, bits,
                                       pps=12, d=d)
            q = torch.randn((4, hq, 1, d), generator=g, device=dev).to(bf16)
            live = lens > 0
            got = paged_decode_attention_ragged(q, pc, lens)
            ref = paged_attention_reference(q, pc, lens, compute_dtype=bf16)
            held(excess(got[live], ref[live], 2 ** -7) <= 5e-3 and not bool(got[~live].any()),
                 "k5_wide", got[live], ref[live], d=d, hkv=hkv, hq=hq, bits=bits)
            del pc
    # K6 at D 256 on both pools, and K5 and K6 at pages of 8 and 24
    for d, hkv, hq, page in ([(d, 2, 8, 32) for d in WIDE_WIDTHS] + [(64, 1, 7, 32)]
                             + [(dd, 2, 8, pg) for pg in WIDE_PAGES for dd in (128, 256)]):
        for bits in (8, 4):
            if page != 32:
                lens = torch.tensor([0, 1, 130, 300], device=dev, dtype=torch.int32)
                pc, _ = random_paged_cache(300 + d + page + bits, lens.tolist(), hkv, page,
                                           bits, pps=-(-300 // page) + 1, d=d)
                q = torch.randn((4, hq, 1, d), generator=g, device=dev).to(bf16)
                live = lens > 0
                got = paged_decode_attention_ragged(q, pc, lens)
                ref = paged_attention_reference(q, pc, lens, compute_dtype=bf16)
                held(excess(got[live], ref[live], 2 ** -7) <= 5e-3
                     and not bool(got[~live].any()), "k5_page", got[live], ref[live], d=d,
                     page=page, bits=bits)
                del pc
            offs = [0, 77]
            lens = torch.tensor([o + 64 for o in offs], device=dev, dtype=torch.int32)
            pc, _ = random_paged_cache(400 + d + page + bits, lens.tolist(), hkv, page, bits,
                                       pps=-(-141 // page) + 1, d=d)
            q = torch.randn((2, hq, 64, d), generator=g, device=dev).to(bf16)
            off = torch.tensor(offs, device=dev)
            got = paged_context_attention(q, pc, lens, off)
            ref = paged_context_attention_reference(q, pc, lens, off, compute_dtype=bf16)
            held(excess(got, ref, 2 ** -7) <= 5e-3, "k6_wide", got, ref, d=d, hq=hq, hkv=hkv,
                 page=page, bits=bits)
            del pc
    # K2 == K5 bit for bit on the same int8 rows: g 7 (d 128, 4 KV heads),
    # g 71 (d 64, one), D 256 at g 8; pages of 16 and 128
    lens = torch.tensor([0, 1, 128, 129, 300, 640, 1000, 1018], device=dev, dtype=torch.int32)
    for d, hkv, hq in ((128, 4, 28), (64, 1, 71), (256, 1, 8)):
        for page in (16, 128):
            pc, _ = random_paged_cache(500 + d + hq + page, lens.tolist(), hkv, page, 8,
                                       pps=1024 // page, d=d)
            q = torch.randn((8, hq, 1, d), generator=g, device=dev).to(bf16)
            paged = paged_decode_attention_ragged(q, pc, lens)
            kq, kc, vq, vc = gather_slot_kv(pc)
            dense = decode_attention(q, kq, vq, lens, kc=kc, vc=vc)
            held(bits_equal(dense, paged), "k2_equals_k5_wide", dense, paged, d=d, hkv=hkv,
                 hq=hq, page=page)
            del pc, kq, kc, vq, vc
    # K3 and K7 at D 256: K3's and K7's parity tolerances
    for d, dv in ((256, 256), (160, 256), (256, 160)):
        for causal in (True, False):
            for dt in ("bfloat16", "float32"):
                dtype = getattr(torch, dt)
                q = torch.randn((2, 4, 150, d), generator=g, device=dev).to(dtype)
                k = torch.randn((2, 4, 170, d), generator=g, device=dev).to(dtype)
                v = torch.randn((2, 4, 170, dv), generator=g, device=dev).to(dtype)
                dout = torch.randn((2, 4, 150, dv), generator=g, device=dev).to(dtype)
                o, lse = flash_attention_fwd(q, k, v, causal=causal)
                ro, rl = flash_attention_plain(q, k, v, causal=causal)
                fwd_ok = (excess(o, ro, 2 ** -7) <= 1e-2 if dt == "bfloat16"
                          else max_err(o, ro) <= 1e-5) and max_err(lse, rl) <= 1e-4
                held(fwd_ok and tuple(o.shape) == (2, 4, 150, dv), "k3_wide", o, ro, d=d,
                     dv=dv, causal=causal, dtype=dt, lse_max_abs_err=max_err(lse, rl))
                got = flash_attention_bwd(q, k, v, o, lse, dout, causal)
                ref = flash_attention_bwd_plain(q, k, v, o, lse, dout, causal)
                exact = attention_grads_f64(q, k, v, dout, causal) if dt == "bfloat16" else ref
                for name, a, r, x in zip(("dq", "dk", "dv"), got, ref, exact):
                    scale = float(r.float().abs().max())
                    row = dict(grad=name, d=d, dv=dv, causal=causal, dtype=dt)
                    if dt == "bfloat16":
                        ok = excess(a, r, 2 ** -7) <= 1e-3 * scale
                        if not ok:
                            # flash_edge_checks' rule for a bf16 rounding flip of dS: as
                            # exact against the float64 gradient as the plain version
                            k_err = float((a.double() - x).abs().max())
                            p_err = float((r.double() - x).abs().max())
                            ok = k_err <= p_err + 1e-3 * scale
                            row.update(held_by_f64=True, kernel_vs_f64=k_err,
                                       plain_vs_f64=p_err)
                    else:
                        ok = max_err(a, r) <= 1e-5 * scale
                    held(ok and a.shape == r.shape, "k7_wide", a, r, **row)


# The last shapes the JAX kernels take that the card once refused: row 12
# past head width 128, the attention kernels past 256 (d != dv past 256 on
# K3 and K7), pages of any size on K5 and K6, and counts past a grid y's
# 65,535 (batch * heads, splits, slots x KV heads, experts, two-pass rows)
LAST_ROW12 = ((160, 160), (256, 256), (256, 96), (384, 320), (576, 512), (1024, 1024))
LAST_WIDTHS = (384, 576)
LAST_PAGES = (1, 3, 4, 12, 272, 512)
MANY = 65600               # past 65,535


def many_slot_cache(b: int, page: int, bits: int, d: int, seed: int):
    """A paged cache on the card of ``b`` slots of one KV head, one page
    each (a shuffled physical page), random codes and positive scales, no
    step tables: K6's many-slot case, built in bulk."""
    from qgemm_tpu_torch.serving.paged_cache import PagedKVCache
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    rows = page if bits == 8 else page // 2
    lo = -127 if bits == 8 else -128
    codes = lambda: torch.randint(lo, 128, (b + 1, 1, rows, d), generator=g, device="cuda",
                                  dtype=torch.int8)
    scales = lambda: torch.rand((b + 1, 1, 1, page), generator=g, device="cuda") * 2 + 0.05
    pt = (torch.randperm(b, generator=g, device="cuda") + 1).to(torch.int32)[:, None]
    return PagedKVCache(kq=codes(), kc=scales(), vq=codes(), vc=scales(),
                        page_table=pt.contiguous(), page_size=page, kv_bits=bits)


def last_shape_checks(held) -> None:
    """Each of the last shapes against its plain version on the card, with
    the tolerances ``phase_shape_limits`` holds the narrower ones to (K2,
    K5, K6: 5e-3 beyond one bf16 rounding; K3: 1e-2 bf16, 1e-5 f32, lse
    1e-4; K7: 1e-3 of the largest gradient bf16 (``flash_edge_checks``'
    float64 rule past it), 1e-5 f32; row 12: ``ops_layer``'s 2e-3 against
    the plain version at the kernel's key tile, its pre-pass by
    ``prepass_check``; K8 and K9 bit for bit):
      - row 12 at ``LAST_ROW12`` (d, dv), int8 P and ``qk_only``;
      - K2 (int8 and bf16 caches), K5 (int8 and int4), K6 (int8 and int4),
        K3 and K7 at d ``LAST_WIDTHS`` (K3/K7 at 576 / 512 too), and each
        at 1,024 once;
      - K5 and K6 at ``LAST_PAGES`` (int4 at the even ones), and K2 == K5
        bit for bit at int8 pages of 1, 12, 272 and 512 (K5's splits K2's);
      - batch * heads ``MANY`` on K3, K7 and row 12 at short S; K6 over
        ``MANY`` slots x KV heads; K8 and K9 over ``MANY`` experts (K8's
        GEMV and tile kernels), K9's two-pass route past 65,535 row tiles;
        one K5 slot of ``MANY`` splits.
    Draws come from a generator of their own, so the older checks keep
    theirs."""
    from qgemm_tpu_torch.ops.cuda.col_quantize import col_quantize, col_quantize_plain
    from qgemm_tpu_torch.ops.cuda.decode_attention import (decode_attention,
                                                           decode_attention_plain)
    from qgemm_tpu_torch.ops.cuda.expert_matmul import (grouped_quantized_matmul,
                                                        grouped_quantized_matmul_plain)
    from qgemm_tpu_torch.ops.cuda.flash_attention import (flash_attention_fwd,
                                                          flash_attention_plain)
    from qgemm_tpu_torch.ops.cuda.flash_attention_bwd import (flash_attention_bwd,
                                                              flash_attention_bwd_plain)
    from qgemm_tpu_torch.ops.cuda.int8_flash_attention import (KERNEL_KEY_TILE,
                                                               flash_attention_int8,
                                                               flash_attention_int8_plain)
    from qgemm_tpu_torch.ops.cuda.paged_context_attention import paged_context_attention
    from qgemm_tpu_torch.ops.cuda.paged_decode_attention import paged_decode_attention_ragged
    from qgemm_tpu_torch.ops.kv_cache import quantize_kv
    from qgemm_tpu_torch.serving.paged_cache import (gather_slot_kv, paged_attention_reference,
                                                     paged_context_attention_reference)
    dev, bf16 = "cuda", torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(21)
    rnd = lambda shape, dt=bf16: torch.randn(shape, generator=g, device=dev).to(dt)
    t0 = time.perf_counter()

    def mark(what: str) -> None:   # progress on stderr: a slow or stuck group shows where
        torch.cuda.synchronize()
        print(f"last_shape_checks {what}: {time.perf_counter() - t0:.1f} s", file=sys.stderr,
              flush=True)

    def row12(q, k, v, causal, qk_only, **row):
        got = flash_attention_int8(q, k, v, causal=causal, qk_only=qk_only)
        tiles = flash_attention_int8_plain(q, k, v, causal, qk_only, block_k=KERNEL_KEY_TILE)
        ok = (excess(got, tiles, 2 ** -6) <= 2e-3 if got.dtype == bf16
              else max_err(got, tiles) <= 2e-3)
        held(ok and got.shape == tiles.shape, "row12_last", got, tiles, causal=causal,
             qk_only=qk_only, **row)

    def k3_k7(q, k, v, dout, causal, what, **row):
        dt = "bfloat16" if q.dtype == bf16 else "float32"
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        ro, rl = flash_attention_plain(q, k, v, causal=causal)
        fwd_ok = (excess(o, ro, 2 ** -7) <= 1e-2 if dt == "bfloat16"
                  else max_err(o, ro) <= 1e-5) and max_err(lse, rl) <= 1e-4
        held(fwd_ok and o.shape == ro.shape, "k3_" + what, o, ro, causal=causal, dtype=dt,
             lse_max_abs_err=max_err(lse, rl), **row)
        got = flash_attention_bwd(q, k, v, o, lse, dout, causal)
        ref = flash_attention_bwd_plain(q, k, v, o, lse, dout, causal)
        exact = attention_grads_f64(q, k, v, dout, causal) if dt == "bfloat16" else ref
        for name, a, r, x in zip(("dq", "dk", "dv"), got, ref, exact):
            scale = float(r.float().abs().max())
            info = dict(grad=name, causal=causal, dtype=dt, **row)
            if dt == "bfloat16":
                ok = excess(a, r, 2 ** -7) <= 1e-3 * scale
                if not ok:   # flash_edge_checks' rule for a bf16 rounding flip of dS
                    k_err = float((a.double() - x).abs().max())
                    p_err = float((r.double() - x).abs().max())
                    ok = k_err <= p_err + 1e-3 * scale
                    info.update(held_by_f64=True, kernel_vs_f64=k_err, plain_vs_f64=p_err)
            else:
                ok = max_err(a, r) <= 1e-5 * scale
            held(ok and a.shape == r.shape, "k7_" + what, a, r, **info)

    def k5(pc, q, lens, what, **row):
        live = lens > 0
        got = paged_decode_attention_ragged(q, pc, lens)
        ref = paged_attention_reference(q, pc, lens, compute_dtype=bf16)
        held(excess(got[live], ref[live], 2 ** -7) <= 5e-3 and not bool(got[~live].any()),
             "k5_" + what, got[live], ref[live], **row)

    def k6(pc, q, lens, off, what, **row):
        got = paged_context_attention(q, pc, lens, off)
        ref = paged_context_attention_reference(q, pc, lens, off, compute_dtype=bf16)
        held(excess(got, ref, 2 ** -7) <= 5e-3, "k6_" + what, got, ref, **row)

    # row 12 past head width 128 (code rows of 256 to 1,024 bytes, V in
    # chunks of 128 channels): the pre-pass, then the kernel
    for i, (d, dv) in enumerate(LAST_ROW12):
        for qk_only in (False, True):
            dt = torch.float32 if (d == 256 and dv == 256 and qk_only) else bf16
            q, k, v = rnd((1, 2, 100, d), dt), rnd((1, 2, 200, d), dt), rnd((1, 2, 200, dv), dt)
            prepass_check(q, k, v, qk_only, f"last_d{d}_dv{dv}")
            row12(q, k, v, i % 2 == 0, qk_only, d=d, dv=dv, dtype=str(dt))
            mark(f"row 12 d {d} dv {dv} qk_only {qk_only}")
    # K2, K5, K6 at head widths past 256, and 1,024 once each
    lengths = torch.tensor([1, 37, 200, 64], device=dev, dtype=torch.int32)
    for d, hkv, hq in [(d, 2, 8) for d in LAST_WIDTHS] + [(1024, 1, 8)]:
        caches = ("int8", "bfloat16") if d < 1024 else ("int8",)
        for cache in caches:
            q = rnd((4, hq, 1, d))
            kf, vf = (torch.randn((4, hkv, 200, d), generator=g, device=dev) for _ in range(2))
            if cache == "int8":
                (kq, kc), (vq, vc) = quantize_kv(kf), quantize_kv(vf)
                args, kw = (q, kq, vq, lengths), {"kc": kc, "vc": vc}
            else:
                args, kw = (q, kf.to(bf16), vf.to(bf16), lengths), {}
            got, ref = decode_attention(*args, **kw), decode_attention_plain(*args, **kw)
            held(excess(got, ref, 2 ** -7) <= 5e-3, "k2_last", got, ref, d=d, hkv=hkv, hq=hq,
                 cache=cache)
        for bits in ((8, 4) if d < 1024 else (4,)):
            lens = torch.tensor([0, 1, 130, 300], device=dev, dtype=torch.int32)
            pc, _ = random_paged_cache(600 + d + bits, lens.tolist(), hkv, 32, bits, pps=12, d=d)
            k5(pc, rnd((4, hq, 1, d)), lens, "last", d=d, hkv=hkv, hq=hq, bits=bits)
            offs = [0, 77]
            lens = torch.tensor([o + 64 for o in offs], device=dev, dtype=torch.int32)
            pc, _ = random_paged_cache(700 + d + bits, lens.tolist(), hkv, 32, bits, pps=6, d=d)
            k6(pc, rnd((2, hq, 64, d)), lens, torch.tensor(offs, device=dev), "last", d=d,
               hkv=hkv, hq=hq, bits=bits)
            del pc
        mark(f"K2, K5, K6 d {d}")
    # K3 and K7 past 256: d == dv, d != dv, and 1,024 once
    for d, dv in ((384, 384), (576, 512), (1024, 1024)):
        for causal, dt in (((True, bf16), (False, torch.float32)) if d < 1024
                           else ((True, bf16),)):
            q, k = rnd((1, 2, 150, d), dt), rnd((1, 2, 170, d), dt)
            v, dout = rnd((1, 2, 170, dv), dt), rnd((1, 2, 150, dv), dt)
            k3_k7(q, k, v, dout, causal, "last", d=d, dv=dv)
        mark(f"K3, K7 d {d} dv {dv}")
    # pages of any size on K5 and K6; K2 == K5 at several int8 pages
    for page in LAST_PAGES:
        for bits in ((8, 4) if page % 2 == 0 else (8,)):
            lens = torch.tensor([0, 1, 130, 600, 1100], device=dev, dtype=torch.int32)
            pc, _ = random_paged_cache(800 + page + bits, lens.tolist(), 2, page, bits,
                                       pps=-(-1100 // page) + 1, d=128)
            k5(pc, rnd((5, 8, 1, 128)), lens, "page", page=page, bits=bits)
            offs = [0, 77, 950]
            lens = torch.tensor([o + 64 for o in offs], device=dev, dtype=torch.int32)
            pc, _ = random_paged_cache(900 + page + bits, lens.tolist(), 2, page, bits,
                                       pps=-(-1014 // page) + 1, d=128)
            k6(pc, rnd((3, 8, 64, 128)), lens, torch.tensor(offs, device=dev), "page",
               page=page, bits=bits)
            del pc
            mark(f"K5, K6 page {page} bits {bits}")
    lens = torch.tensor([0, 1, 128, 129, 300, 640, 1000, 1018], device=dev, dtype=torch.int32)
    for page in (1, 12, 272, 512):
        pc, _ = random_paged_cache(1000 + page, lens.tolist(), 2, page, 8, pps=-(-1018 // page),
                                   d=128)
        q = rnd((8, 8, 1, 128))
        paged = paged_decode_attention_ragged(q, pc, lens)
        kq, kc, vq, vc = gather_slot_kv(pc)
        dense = decode_attention(q, kq, vq, lens, kc=kc, vc=vc)
        held(bits_equal(dense, paged), "k2_equals_k5_page", dense, paged, page=page)
        del pc, kq, kc, vq, vc
        mark(f"K2 == K5 page {page}")
    # counts past 65,535: batch * heads on K3, K7 and row 12 at short S
    for dt in (bf16, torch.float32):
        q, k, v, dout = (rnd((1640, 40, 8, 32), dt) for _ in range(4))
        k3_k7(q, k, v, dout, True, "many", batch_heads=MANY)
    q, k, v = (rnd((1640, 40, 16, 32)) for _ in range(3))
    row12(q, k, v, True, False, batch_heads=MANY, d=32, dv=32)
    del q, k, v, dout
    mark("batch * heads 65,600")
    # K6 over MANY slots x one KV head (pages of 16, one each)
    pc = many_slot_cache(MANY, 16, 8, 32, 1100)
    lens = torch.full((MANY,), 11, device=dev, dtype=torch.int32)
    k6(pc, rnd((MANY, 2, 4, 32)), lens, torch.full((MANY,), 7, device=dev), "many",
       slots_x_kv_heads=MANY)
    del pc
    mark("K6 slots x KV heads 65,600")
    # K8 (GEMV at C 2, tile kernel at C 20) and K9 over MANY experts
    for c_rows in (2, 20):
        x = rnd((MANY, c_rows, 16), torch.float32)
        wt = torch.randint(-127, 128, (MANY, 16, 16), generator=g, device=dev, dtype=torch.int8)
        cw = torch.rand((MANY, 1, 16), generator=g, device=dev) + 0.1
        got = grouped_quantized_matmul(x, wt, cw, relu=True)
        ref = grouped_quantized_matmul_plain(x, wt, cw, relu=True)
        held(bits_equal(got, ref), "k8_many", got, ref, experts=MANY, c=c_rows)
    for e, k_rows in ((MANY, 16), (1, 65535 * 64 + 64)):
        w = rnd((e, k_rows, 16))
        (qt, c), (rq, rc) = col_quantize(w), col_quantize_plain(w)
        held(torch.equal(qt, rq) and bits_equal(c, rc), "k9_many", c, rc, experts=e,
             k=k_rows)
    del x, wt, cw, w, qt, c, rq, rc
    mark("K8, K9 experts 65,600")
    # one K5 slot of MANY splits (pages of 128, d 8)
    n = MANY * 128 - 5
    pc, _ = random_paged_cache(1200, [n], 1, 128, 8, pps=MANY, d=8)
    k5(pc, rnd((1, 1, 1, 8)), torch.tensor([n], device=dev, dtype=torch.int32), "many",
       splits=MANY, length=n)
    del pc
    mark("K5 splits 65,600")
    torch.cuda.empty_cache()


# Three public attention geometries at full width, served by the repo's
# GPT (its blocks: LayerNorm, GELU FFN, learned positions; random int8
# weights from seed 0): each published config's vocab, d_model, query and
# KV heads and d_ff (Gemma-2B, Qwen2-7B and Falcon-7B's config.json), GQA
# groups 8, 7 and 71, head widths 256, 128 and 64. Depth is cut
# (``ATTN_GEOMETRY_LAYERS``: half of Gemma-2B's 18, a quarter of Qwen2-7B's
# 28 and of Falcon-7B's 32) so that the phase,
# three models each served by two engines, stays near 40 s and the whole
# script inside its limit; widths never are.
ATTN_GEOMETRIES = {
    "gemma2b_widths": dict(vocab_size=256000, d_model=2048, n_heads=8, n_kv_heads=1,
                           d_ff=16384),
    "qwen2_7b_widths": dict(vocab_size=152064, d_model=3584, n_heads=28, n_kv_heads=4,
                            d_ff=18944),
    "falcon7b_widths": dict(vocab_size=65024, d_model=4544, n_heads=71, n_kv_heads=1,
                            d_ff=18176),
}
ATTN_GEOMETRY_FULL_DEPTH = {"gemma2b_widths": 18, "qwen2_7b_widths": 28, "falcon7b_widths": 32}
ATTN_GEOMETRY_LAYERS = {"gemma2b_widths": 9, "qwen2_7b_widths": 7, "falcon7b_widths": 8}
# the traced decode window's middle (``profile_decode``: 300-token prompts,
# an admitting step, two warm steps and a window of 10 before it): the
# positions a slot holds there, for the K2 and K5 byte bound of a step
DECODE_WINDOW_POSITIONS = 318


def attn_geometry_config(label: str, n_layers: Optional[int] = None):
    from qgemm_tpu_torch.models.gpt import GPTConfig
    return GPTConfig(**ATTN_GEOMETRIES[label], max_seq_len=2048, dtype="bfloat16",
                     n_layers=n_layers or ATTN_GEOMETRY_LAYERS[label])


def attn_geometry_requests(vocab: int, rng) -> tuple:
    """8 greedy requests, alternating: 4 share a 256-token prefix (a prefix
    hit, K6 on the suffix) with random suffixes of 32-300 tokens; 4 are
    random prompts, two of 128-256 tokens (one chunk: a whole-prompt K3
    prefill on both tiers) and two of 257-500 (chunked on the paged tier).
    max_new_tokens 8-16. Returns (prompts, max_new, the whole-prompt
    requests' indices, a chunked one's index)."""
    prefix = rng.integers(0, vocab, size=256).tolist()
    shared = [prefix + rng.integers(0, vocab, size=int(n)).tolist()
              for n in rng.integers(32, 301, size=4)]
    plens = list(rng.integers(128, 257, size=2)) + list(rng.integers(257, 501, size=2))
    own = [rng.integers(0, vocab, size=int(n)).tolist() for n in plens]
    prompts = [p for pair in zip(shared, own) for p in pair]
    news = [int(n) for n in rng.integers(8, 17, size=8)]
    return prompts, news, (1, 3), 5


def decode_attn_bytes(cfg, slots: int, positions: int, paged: bool) -> int:
    """Bytes a decode step's K2 (or K5) launches must move at every layer:
    each slot's K and V codes and f32 scales of ``positions`` positions per
    KV head read once, q and the output (bf16) once; K5 also its page
    table rows (pages of 128) and the lengths."""
    hkv = cfg.n_kv_heads or cfg.n_heads
    d = cfg.d_model // cfg.n_heads
    per_layer = slots * hkv * 2 * positions * (d + 4) + 2 * slots * cfg.n_heads * d * 2
    if paged:
        per_layer += slots * (-(-1024 // 128) * 4 + 4)
    return cfg.n_layers * per_layer


def attn_geometry(label: str) -> dict:
    """One geometry on the main path: the int8 GPT served by the dense
    graph engine (``DENSE_ENGINE``) and the paged int8 graph engine
    (``PAGED_ENGINE``: pages of 128, prefix cache, 256-row chunks), 8
    greedy requests each (``attn_geometry_requests``), launch counts set to
    0 just before each run and read just after (``drive``). Fails unless:
    every decode step launched K2 (dense) or K5 (paged) once per layer and
    the model's 6 L + 1 GEMMs; every admission launched K3 once per layer
    per whole-prompt prefill and, on the paged tier, K6 once per layer per
    chunk, with whole prompts and chunks both present
    (``paged_prefill_launches``); the dense engine's 8 transcripts equal
    ``generate``'s (``transcripts_match_generate``); the paged engine's
    whole-prompt requests equal ``generate``'s bit for bit, logits and
    tokens (``paged_transcripts_match``: K5 and K2 share a split body); a
    chunked prompt's paged logits stay within ``PAGED_LOGIT_RTOL`` of
    ``generate``'s (``paged_logit_reading``). Each engine's steady decode
    window is profiled (``profile_decode``): device ms a step, K2's or K5's
    ms a step beside their byte bound (``decode_attn_bytes``)."""
    from qgemm_tpu_torch.models.gpt import GPT
    from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
    cfg = attn_geometry_config(label)
    L, n_gemms = cfg.n_layers, 6 * cfg.n_layers + 1
    t0 = time.perf_counter()
    model = GPT.init_quantized(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    res = {"config": {**ATTN_GEOMETRIES[label], "n_layers": L,
                      "full_depth": ATTN_GEOMETRY_FULL_DEPTH[label],
                      "head_dim": cfg.d_model // cfg.n_heads,
                      "gqa_group": cfg.n_heads // (cfg.n_kv_heads or cfg.n_heads)},
           "init_s": round(time.perf_counter() - t0, 2)}
    prompts, news, whole, chunked_i = attn_geometry_requests(cfg.vocab_size,
                                                             np.random.default_rng(20))
    k5 = ("paged_decode_attention", "paged_decode_attention_ragged")
    for tier, kw in (("dense", DENSE_ENGINE), ("paged", PAGED_ENGINE)):
        t_tier = time.perf_counter()
        reqs = [Request(prompt=p, max_new_tokens=n) for p, n in zip(prompts, news)]
        engine = ContinuousBatchingEngine(model, **kw)
        run = drive(engine, reqs, f"{label} {tier}")
        per_decode, counts = run["per_decode"], run["counts"]
        attn = ("decode_attention",) if tier == "dense" else k5
        if not (per_decode is not None and sum(per_decode[k] for k in attn) == L
                and per_decode["quantized_matmul"] == n_gemms
                and per_decode["flash_attention"] == 0 == per_decode["paged_context_attention"]
                and (tier == "paged" or sum(per_decode[k] for k in k5) == 0)
                and (tier == "dense" or per_decode["decode_attention"] == 0)):
            raise AssertionError(f"{label} {tier}: launches per decode step {per_decode}")
        prefill = paged_prefill_launches(run, per_decode, L, n_gemms, f"{label} {tier}")
        if not (prefill["whole_prompt_prefills"] > 0
                and (prefill["chunks"] > 0) == (tier == "paged")
                and prefill["whole_prompt_prefills"] + prefill["chunks"] >= len(reqs)):
            raise AssertionError(f"{label} {tier}: prefills {prefill}")
        out = {"launches": counts, "launches_per_decode_step": per_decode,
               "prefill_launches": prefill, "stats": engine.stats,
               "decode_step_ms_median": float(np.median(run["step_ms"])),
               "graph": run["graph"]}
        if tier == "dense":
            out["transcripts_match_generate"] = transcripts_match_generate(
                f"{label} dense", model, reqs)
        else:
            match = paged_transcripts_match(f"{label} paged", model,
                                            [reqs[i] for i in whole])
            chunked = paged_logit_reading(model, reqs[chunked_i].prompt,
                                          reqs[chunked_i].max_new_tokens)
            chunked = {k: v for k, v in chunked.items() if k not in ("generate", "paged_alone")}
            if not chunked["logit_rel_diff_max"] <= PAGED_LOGIT_RTOL:
                raise AssertionError(f"{label} paged: a chunked prompt's logits differ from "
                                     f"generate's beyond {PAGED_LOGIT_RTOL}: {chunked}")
            iso = [model.generate(torch.tensor([r.prompt], device="cuda"), r.max_new_tokens,
                                  quantized_cache=True)[0].tolist() for r in reqs]
            out.update(transcripts_match_generate=match["equal_to_generate"],
                       paged_logit_reading=chunked, paged_logit_rtol=PAGED_LOGIT_RTOL,
                       transcripts_equal_generate_all=sum(
                           r.generated == w for r, w in zip(reqs, iso)))
        prof = profile_decode(engine, np.random.default_rng(21))
        fam = "dense_decode" if tier == "dense" else "paged_decode"
        bms = bound(decode_attn_bytes(cfg, engine.max_slots, DECODE_WINDOW_POSITIONS,
                                      tier == "paged"), 0, BF16_FLOPS)[0]
        out.update(decode_profile=prof, kernel_ms_per_step=prof["kernel_ms_per_step"],
                   attention_ms_per_step=prof["family_ms_per_step"][fam],
                   attention_bound_ms_per_step=bms,
                   attention_bound_note=f"bytes at {DECODE_WINDOW_POSITIONS} positions a "
                                        "slot, every layer",
                   seconds=round(time.perf_counter() - t_tier, 2))
        res[tier] = out
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    return res


def attn_geometry_train() -> dict:
    """One training step of the ``train`` phase's shape (4 x 2048 tokens,
    bf16, Adam) at ``gemma2b_widths`` (head_dim 256) and 4 layers: a
    warm-up step, one timed step and one traced, each launching K3 and K7
    once per layer and no other kernel of the port. Its wall time and its
    K3 and K7 ms (the traced step's device time by family)."""
    cfg = attn_geometry_config("gemma2b_widths", n_layers=TRAIN_LAYERS)
    res, per_step = train_run(cfg, timed=1, label="attn_geometries_train",
                              model_name=f"gemma2b_widths, {TRAIN_LAYERS} of 18 layers")
    train_kernel_counts(per_step, TRAIN_LAYERS, "attn_geometries_train")
    if not all(np.isfinite(res["losses"])):
        raise AssertionError(f"attn_geometries_train: a loss is not finite: {res['losses']}")
    fam = res["traced_step"]["kernel_ms_by_family"]
    res.update(k3_ms=fam["k3_flash_fwd"], k7_ms=fam["k7_flash_bwd"],
               launches_per_step=per_step[0])
    return res


# The paged tier at the pages the card once refused, on GPT_6_7B's widths
# at 4 of its 32 layers (the pages are what is new, not the depth): int8
# pools in pages of 12 (K6 sub-tiles of 1) and 512, K5's splits K2's
# 128 positions at both, int4 pools in pages of 4
WIDE_PAGE_LAYERS = 4
WIDE_PAGE_TIERS = {"int8_page12": dict(page_size=12), "int8_page512": dict(page_size=512),
                   "int4_page4": dict(page_size=4, kv_bits=4)}


def wide_page_requests(vocab: int, rng) -> tuple:
    """8 greedy requests, alternating: 4 share a 256-token prefix (a prefix
    hit at pages of 12 and 4) with random suffixes of 32-300 tokens; 4 are
    random prompts, two of 128-256 tokens (whole-prompt prefills) and two of
    600-900 (admitted in chunks at every page: the engine's chunks are
    page-granular, 512 tokens at pages of 512). max_new_tokens 8-16.
    Returns (prompts, max_new, the whole-prompt requests' indices, a
    chunked one's index)."""
    prefix = rng.integers(0, vocab, size=256).tolist()
    shared = [prefix + rng.integers(0, vocab, size=int(n)).tolist()
              for n in rng.integers(32, 301, size=4)]
    plens = list(rng.integers(128, 257, size=2)) + list(rng.integers(600, 901, size=2))
    own = [rng.integers(0, vocab, size=int(n)).tolist() for n in plens]
    prompts = [p for pair in zip(shared, own) for p in pair]
    news = [int(n) for n in rng.integers(8, 17, size=8)]
    return prompts, news, (1, 3), 5


def alone_logit_reading(model, prompt: list, n_new: int, kw: dict, ref_kw: dict) -> dict:
    """A request's greedy run alone through the paged engine with ``kw``
    against its run alone with ``ref_kw`` (``engine_alone_logits``, eager):
    the tokens, the first differing step, and over the shared history the
    largest |difference| of the logits relative to the reference step's
    largest |logit|, and whether they are equal bit for bit."""
    ref, r_logits = engine_alone_logits(model, prompt, n_new, ref_kw)
    got, g_logits = engine_alone_logits(model, prompt, n_new, kw)
    t = first_difference(ref, got)
    shared = n_new if t is None else t + 1
    rel = [float((r_logits[i] - g_logits[i]).abs().max() / r_logits[i].abs().max())
           for i in range(shared)]
    return {"reference": ref, "tokens": got, "first_difference": t,
            "logit_rel_diff_max": max(rel),
            "logits_equal": all(bits_equal(r_logits[i], g_logits[i]) for i in range(shared))}


def phase_wide_pages() -> dict:
    """The paged engine (``PAGED_ENGINE``'s options but the page, and int4
    pools for ``int4_page4``) serving ``wide_page_requests``' 8 greedy
    requests on int8 GPT_6_7B at ``WIDE_PAGE_LAYERS`` layers, at each of
    ``WIDE_PAGE_TIERS``, the launch counts set to 0 just before each run
    and read just after (``drive``). Fails unless every decode step
    launched K5 once per layer and the 6 L + 1 GEMMs, and every admission
    K3 once per layer per whole-prompt prefill and K6 once per layer per
    chunk, both present (``paged_prefill_launches``); every pool page came
    back. int8 tiers: the whole-prompt requests' transcripts and logits
    equal ``generate``'s bit for bit (K5's splits are K2's at these pages,
    ``paged_plan.aligned``), and a chunked prompt's logits stay within
    ``PAGED_LOGIT_RTOL`` of its; each whole-prompt transcript equals the
    request served alone by its engine. int4 (no dense int4 path to hold it to):
    each whole-prompt request and the chunked one served alone at pages of
    4 against the int4 engine at pages of 128, within ``PAGED_LOGIT_RTOL``
    (K5's splits and K6's key tiles are the same positions at both pages:
    the bits are recorded), and the whole-prompt transcripts equal the
    requests served alone. Then ``last_timing``."""
    from qgemm_tpu_torch.models.gpt import GPT, GPT_6_7B
    from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
    t0 = time.perf_counter()
    cfg = dataclasses.replace(GPT_6_7B, n_layers=WIDE_PAGE_LAYERS)
    L, n_gemms = cfg.n_layers, 6 * cfg.n_layers + 1
    model = GPT.init_quantized(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    res = {"phase": "wide_pages", "model": f"GPT_6_7B int8 weights, {L} of 32 layers",
           "init_s": round(time.perf_counter() - t0, 2)}
    prompts, news, whole, chunked_i = wide_page_requests(cfg.vocab_size,
                                                         np.random.default_rng(23))
    k5 = ("paged_decode_attention", "paged_decode_attention_ragged")
    for tier, extra in WIDE_PAGE_TIERS.items():
        t_tier = time.perf_counter()
        kw = dict(PAGED_ENGINE, **extra)
        reqs = [Request(prompt=p, max_new_tokens=n) for p, n in zip(prompts, news)]
        engine = ContinuousBatchingEngine(model, **kw)
        run = drive(engine, reqs, f"wide_pages {tier}")
        per_decode, counts = run["per_decode"], run["counts"]
        if not (per_decode is not None and sum(per_decode[k] for k in k5) == L
                and per_decode["quantized_matmul"] == n_gemms
                and per_decode["decode_attention"] == 0 == per_decode["flash_attention"]
                and per_decode["paged_context_attention"] == 0):
            raise AssertionError(f"wide_pages {tier}: launches per decode step {per_decode}")
        prefill = paged_prefill_launches(run, per_decode, L, n_gemms, f"wide_pages {tier}")
        if not (prefill["whole_prompt_prefills"] > 0 and prefill["chunks"] > 0
                and prefill["whole_prompt_prefills"] + prefill["chunks"] >= len(reqs)):
            raise AssertionError(f"wide_pages {tier}: prefills {prefill}")
        if any(c.page_size != kw["page_size"] or c.kv_bits != kw.get("kv_bits", 8)
               for c in engine.caches):
            raise AssertionError(f"wide_pages {tier}: the pools are not the tier's")
        if engine.stats["pages_in_use"] != 0:
            raise AssertionError(f"wide_pages {tier}: pages left in use {engine.stats}")
        readings = {}
        for i in list(whole) + [chunked_i]:
            r = reqs[i]
            if kw.get("kv_bits", 8) == 8:
                w = paged_logit_reading(model, r.prompt, r.max_new_tokens, kw)
                alone, ok = w["paged_alone"], (w["logit_rel_diff_max"] <= PAGED_LOGIT_RTOL
                                               and (i == chunked_i
                                                    or (w["first_difference"] is None
                                                        and w["logits_equal"])))
            else:
                w = alone_logit_reading(model, r.prompt, r.max_new_tokens, kw,
                                        dict(PAGED_ENGINE, kv_bits=4))
                alone, ok = w["tokens"], w["logit_rel_diff_max"] <= PAGED_LOGIT_RTOL
            readings[f"request_{i}"] = {k: v for k, v in w.items()
                                        if k not in ("generate", "paged_alone", "reference",
                                                     "tokens")}
            readings[f"request_{i}"]["whole_prompt"] = i != chunked_i
            if i != chunked_i and alone != r.generated:
                raise AssertionError(f"wide_pages {tier}: request {i}: engine {r.generated} "
                                     f"!= the request served alone {alone}")
            if not ok:
                raise AssertionError(f"wide_pages {tier}: request {i}: {readings[f'request_{i}']}")
        res[tier] = {"engine": {k: v for k, v in kw.items() if k != "device"},
                     "launches": counts, "launches_per_decode_step": per_decode,
                     "prefill_launches": prefill, "stats": engine.stats,
                     "decode_step_ms_median": float(np.median(run["step_ms"])),
                     "graph": run["graph"], "readings": readings,
                     "paged_logit_rtol": PAGED_LOGIT_RTOL,
                     "seconds": round(time.perf_counter() - t_tier, 2)}
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    res["serving_seconds"] = round(time.perf_counter() - t0, 2)
    res["timing"] = last_timing()
    res["seconds"] = round(time.perf_counter() - t0, 2)
    emit(res)
    return res


# ``last_timing``'s rows by the kernel whose entry of the ``kernels`` line
# carries them
LAST_TIMING_KEYS = {
    "int8_flash_attention": ("int8_flash_attention_d256",),
    "decode_attention": ("decode_attention_d512",),
    "paged_decode_attention": ("paged_decode_attention_d512", "paged_decode_attention_page12",
                               "paged_decode_attention_page512"),
    "flash_attention": ("flash_attention_d512",),
    "flash_attention_bwd": ("flash_attention_bwd_d512",),
    "paged_context_attention": ("paged_context_attention_d512",
                                "paged_context_attention_page12",
                                "paged_context_attention_page512"),
}


def last_timing() -> dict:
    """The kernels at the last shapes, by ``phase_timing``'s protocol
    (bench_ms; plain versions; byte and operation bounds by its formulas;
    SDPA beside row 12, K3 and K7): row 12 at B 1, H 32, S 2048, D 256,
    causal, bf16 (int8 P; its wrapper with the pre-pass); K2 and K5 (int8,
    pages of 128) at d 512, Hq 8 over 2 KV heads, 8 slots of row 5's
    lengths 150-550; K3 and K7 at B 1, H 8, S 2048, d 512, causal, bf16 (the
    wide route); K6 at C 256 after 768, d 512, Hq 8 over 2; and K5 (B 8, H
    32, d 128, row 5's lengths) and K6 (B 1, H 32, C 256 after 768, d 128)
    at pages of 12 and 512, int8."""
    import torch.nn.functional as F

    from qgemm_tpu_torch.ops.cuda.decode_attention import (decode_attention,
                                                           decode_attention_plain)
    from qgemm_tpu_torch.ops.cuda.flash_attention import (flash_attention_fwd,
                                                          flash_attention_plain)
    from qgemm_tpu_torch.ops.cuda.flash_attention_bwd import (flash_attention_bwd,
                                                              flash_attention_bwd_plain)
    from qgemm_tpu_torch.ops.cuda.int8_flash_attention import (KERNEL_KEY_TILE,
                                                               flash_attention_int8,
                                                               flash_attention_int8_plain)
    from qgemm_tpu_torch.ops.cuda.paged_context_attention import paged_context_attention
    from qgemm_tpu_torch.ops.cuda.paged_decode_attention import paged_decode_attention_ragged
    from qgemm_tpu_torch.serving.paged_cache import (gather_slot_kv, paged_attention_reference,
                                                     paged_context_attention_reference)
    from qgemm_tpu_torch.utils.profiling import bench_ms
    g = torch.Generator(device="cuda")
    g.manual_seed(24)
    bf16, out = torch.bfloat16, {}
    rnd = lambda shape: torch.randn(shape, generator=g, device="cuda").to(bf16)
    # row 12 at D 256
    b, h, s, d = 1, 32, 2048, 256
    q, k, v = (rnd((b, h, s, d)) for _ in range(3))
    pairs = b * h * s * (s + 1) // 2
    r12 = bench_ms(lambda: flash_attention_int8(q, k, v, causal=True))
    br = bound(3 * b * h * s * d * 2 + b * h * s * d * 2, 4 * d * pairs, INT8_OPS)
    out["int8_flash_attention_d256"] = {
        "ms": r12, "plain_ms": bench_queued_or_not(lambda: flash_attention_int8_plain(
            q, k, v, True, False, block_k=KERNEL_KEY_TILE))[0],
        "library_ms": bench_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)),
        "bound_ms": br[0], "bound_by": br[1],
        "shape": f"B={b} H={h} S={s} D={d} causal bf16, int8 P, wrapper with the pre-pass"}
    del q, k, v
    # K2 and K5 at d 512
    lengths = [150, 210, 260, 330, 400, 450, 500, 550]
    lens = torch.tensor(lengths, device="cuda", dtype=torch.int32)
    tot = sum(lengths)
    hq, hkv, d, page, pps = 8, 2, 512, 128, 8
    cache, _ = random_paged_cache(1300, lengths, hkv, page, 8, pps, d=d)
    kq, kc, vq, vc = gather_slot_kv(cache)
    q = rnd((8, hq, 1, d))
    ops = tot * hq * 4 * d
    b2 = bound(8 * hq * d * 2 * 2 + tot * hkv * (2 * d + 8), ops, BF16_FLOPS)
    b5 = bound(2 * 8 * hq * d * 2 + 8 * (pps * 4 + 4)
               + paged_kv_bytes(lengths, hkv, d, page, 8), ops, BF16_FLOPS)
    shape = f"B=8 Hq={hq} Hkv={hkv} D={d} lengths={lengths}"
    out["decode_attention_d512"] = {
        "ms": bench_ms(lambda: decode_attention(q, kq, vq, lens, kc=kc, vc=vc)),
        "plain_ms": bench_ms(lambda: decode_attention_plain(q, kq, vq, lens, kc=kc, vc=vc)),
        "library_ms": None, "bound_ms": b2[0], "bound_by": b2[1],
        "shape": shape + f" S={kq.shape[2]} int8"}
    out["paged_decode_attention_d512"] = {
        "ms": bench_ms(lambda: paged_decode_attention_ragged(q, cache, lens)),
        "plain_ms": bench_ms(lambda: paged_attention_reference(q, cache, lens,
                                                               compute_dtype=bf16),
                             queue_ahead=False),
        "library_ms": None, "bound_ms": b5[0], "bound_by": b5[1],
        "shape": shape + " page=128 int8 (ragged)"}
    del cache, kq, kc, vq, vc
    # K5 at pages of 12 and 512 (d 128, MHA)
    hq = hkv = 32
    d = 128
    q = rnd((8, hq, 1, d))
    for page in (12, 512):
        pps = -(-550 // page)
        cache, _ = random_paged_cache(1400 + page, lengths, hkv, page, 8, pps, d=d)
        b5 = bound(2 * 8 * hq * d * 2 + 8 * (pps * 4 + 4)
                   + paged_kv_bytes(lengths, hkv, d, page, 8), tot * hq * 4 * d, BF16_FLOPS)
        out[f"paged_decode_attention_page{page}"] = {
            "ms": bench_ms(lambda: paged_decode_attention_ragged(q, cache, lens)),
            "plain_ms": bench_ms(lambda: paged_attention_reference(q, cache, lens,
                                                                   compute_dtype=bf16),
                                 queue_ahead=False),
            "library_ms": None, "bound_ms": b5[0], "bound_by": b5[1],
            "shape": f"B=8 H={hq} D={d} lengths={lengths} page={page} int8 (ragged)"}
        del cache
    # K3 and K7 at d 512 (the wide route)
    b, h, s, d = 1, 8, 2048, 512
    q, k, v, dout = (rnd((b, h, s, d)) for _ in range(4))
    flops = 4 * d * b * h * s * (s + 1) // 2
    b3 = bound(4 * b * h * s * d * 2 + b * h * s * 4, flops, BF16_FLOPS)
    k3 = bench_ms(lambda: flash_attention_fwd(q, k, v, causal=True))
    out["flash_attention_d512"] = {
        "ms": k3, "plain_ms": bench_ms(lambda: flash_attention_plain(q, k, v, causal=True)),
        "library_ms": bench_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                                      is_causal=True)),
        "bound_ms": b3[0], "bound_by": b3[1], "achieved_tflops": flops / k3 / 1e9,
        "shape": f"B={b} H={h} S={s} D={d} causal bf16 (wide route)"}
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    k7 = bench_ms(lambda: flash_attention_bwd(q, k, v, o, lse, dout, True))
    qg_, kg_, vg_ = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg_, kg_, vg_, is_causal=True)
    lib, _ = bench_queued_or_not(
        lambda: torch.autograd.grad(sdpa_out, (qg_, kg_, vg_), dout, retain_graph=True))
    flops7 = 10 * d * b * h * s * (s + 1) // 2
    b7 = bound(8 * b * h * s * d * 2 + b * h * s * 4, flops7, BF16_FLOPS)
    out["flash_attention_bwd_d512"] = {
        "ms": k7, "plain_ms": bench_ms(lambda: flash_attention_bwd_plain(q, k, v, o, lse, dout,
                                                                         True)),
        "library_ms": lib, "bound_ms": b7[0], "bound_by": b7[1],
        "achieved_tflops": flops7 / k7 / 1e9,
        "shape": f"B={b} H={h} S={s} D={d} causal bf16 (wide route)"}
    del q, k, v, dout, o, lse, qg_, kg_, vg_, sdpa_out
    torch.cuda.empty_cache()
    # K6 at d 512 (the wide kernel), and at pages of 12 and 512 (d 128)
    c, off = 256, 768
    lens = torch.tensor([off + c], device="cuda", dtype=torch.int32)
    cpairs = c * off + c * (c + 1) // 2
    for key, (hq, hkv, d, page) in (("d512", (8, 2, 512, 128)), ("page12", (32, 32, 128, 12)),
                                    ("page512", (32, 32, 128, 512))):
        pps = -(-(off + c) // page)
        q = rnd((1, hq, c, d))
        cache, _ = random_paged_cache(1500 + page + d, lens.tolist(), hkv, page, 8, pps, d=d)
        moved = 2 * c * hq * d * 2 + pps * 4 + 8 + paged_kv_bytes(lens.tolist(), hkv, d, page, 8)
        b6 = bound(moved, hq * cpairs * 4 * d, BF16_FLOPS)
        out[f"paged_context_attention_{key}"] = {
            "ms": bench_ms(lambda: paged_context_attention(q, cache, lens, off)),
            "plain_ms": bench_ms(lambda: paged_context_attention_reference(
                q, cache, lens, off, compute_dtype=bf16), queue_ahead=False),
            "library_ms": None, "bound_ms": b6[0], "bound_by": b6[1],
            "shape": f"B=1 Hq={hq} Hkv={hkv} C={c} D={d} offset={off} page={page} int8"}
        del cache
    torch.cuda.empty_cache()
    return out


def phase_attn_geometries() -> dict:
    """``attn_geometry`` at each of ``ATTN_GEOMETRIES``, the D 256 training
    step (``attn_geometry_train``) and the new shapes' kernel times
    (``wide_timing``)."""
    t0 = time.perf_counter()
    res = {"phase": "attn_geometries", "layers": ATTN_GEOMETRY_LAYERS,
           "full_depth": ATTN_GEOMETRY_FULL_DEPTH}
    for label in ATTN_GEOMETRIES:
        res[label] = attn_geometry(label)
    res["train_gemma2b_widths"] = attn_geometry_train()
    res["serving_seconds"] = round(time.perf_counter() - t0, 2)
    res["timing"] = wide_timing()
    res["seconds"] = round(time.perf_counter() - t0, 2)
    emit(res)
    return res


# ``wide_timing``'s rows by the kernel whose entry of the ``kernels`` line
# carries them
WIDE_TIMING_KEYS = {
    "decode_attention": ("decode_attention_d256_g8", "decode_attention_d64_g71"),
    "paged_decode_attention": ("paged_decode_attention_d256_g8",
                               "paged_decode_attention_d64_g71"),
    "flash_attention": ("flash_attention_d256",),
    "flash_attention_bwd": ("flash_attention_bwd_d256",),
    "paged_context_attention": ("paged_context_attention_d256_int8",
                                "paged_context_attention_d256_int4"),
}


def wide_timing() -> dict:
    """The attention kernels at their widened shapes, by
    ``phase_timing``'s protocol (bench_ms; plain versions, byte and
    operation bounds by its formulas; SDPA beside K3 and K7): K2 and K5
    (int8, pages of 128) at D 256 (Hq 8 over one KV head: Gemma-2B's
    group) and at g 71 (Falcon-7B's, d 64), 8 slots of row 5's lengths
    150-550; K3 and K7 at B 4, H 8, S 2048, D 256, causal, bf16; K6 at C
    256 after 768, D 256, Hq 8 over one KV head, int8 and int4."""
    import torch.nn.functional as F

    from qgemm_tpu_torch.ops.cuda.decode_attention import (decode_attention,
                                                           decode_attention_plain)
    from qgemm_tpu_torch.ops.cuda.flash_attention import (flash_attention_fwd,
                                                          flash_attention_plain)
    from qgemm_tpu_torch.ops.cuda.flash_attention_bwd import (flash_attention_bwd,
                                                              flash_attention_bwd_plain)
    from qgemm_tpu_torch.ops.cuda.paged_context_attention import paged_context_attention
    from qgemm_tpu_torch.ops.cuda.paged_decode_attention import paged_decode_attention_ragged
    from qgemm_tpu_torch.serving.paged_cache import (gather_slot_kv, paged_attention_reference,
                                                     paged_context_attention_reference)
    from qgemm_tpu_torch.utils.profiling import bench_ms
    g = torch.Generator(device="cuda")
    g.manual_seed(22)
    bf16, out = torch.bfloat16, {}
    lengths = [150, 210, 260, 330, 400, 450, 500, 550]
    lens = torch.tensor(lengths, device="cuda", dtype=torch.int32)
    tot, page, pps = sum(lengths), 128, 8
    for key, (hq, hkv, d) in (("d256_g8", (8, 1, 256)), ("d64_g71", (71, 1, 64))):
        cache, _ = random_paged_cache(60 + hq, lengths, hkv, page, 8, pps, d=d)
        kq, kc, vq, vc = gather_slot_kv(cache)
        q = torch.randn((8, hq, 1, d), generator=g, device="cuda").to(bf16)
        k2 = bench_ms(lambda: decode_attention(q, kq, vq, lens, kc=kc, vc=vc))
        k5 = bench_ms(lambda: paged_decode_attention_ragged(q, cache, lens))
        k2_plain = bench_ms(lambda: decode_attention_plain(q, kq, vq, lens, kc=kc, vc=vc))
        k5_plain = bench_ms(lambda: paged_attention_reference(q, cache, lens,
                                                              compute_dtype=bf16),
                            queue_ahead=False)
        ops = tot * hq * 4 * d
        b2 = bound(8 * hq * d * 2 * 2 + tot * hkv * (2 * d + 8), ops, BF16_FLOPS)
        b5 = bound(2 * 8 * hq * d * 2 + 8 * (pps * 4 + 4)
                   + paged_kv_bytes(lengths, hkv, d, page, 8), ops, BF16_FLOPS)
        shape = f"B=8 Hq={hq} Hkv={hkv} D={d} lengths={lengths}"
        out[f"decode_attention_{key}"] = {"ms": k2, "plain_ms": k2_plain, "library_ms": None,
                                          "bound_ms": b2[0], "bound_by": b2[1],
                                          "shape": shape + " S=1024 int8"}
        out[f"paged_decode_attention_{key}"] = {"ms": k5, "plain_ms": k5_plain,
                                                "library_ms": None, "bound_ms": b5[0],
                                                "bound_by": b5[1],
                                                "shape": shape + " page=128 int8 (ragged)"}
        del cache, kq, kc, vq, vc
    b, h, s, d = 4, 8, 2048, 256
    q, k, v, dout = (torch.randn((b, h, s, d), generator=g, device="cuda").to(bf16)
                     for _ in range(4))
    flops = 4 * d * b * h * s * (s + 1) // 2
    b3 = bound(4 * b * h * s * d * 2 + b * h * s * 4, flops, BF16_FLOPS)
    k3 = bench_ms(lambda: flash_attention_fwd(q, k, v, causal=True))
    out["flash_attention_d256"] = {
        "ms": k3, "plain_ms": bench_ms(lambda: flash_attention_plain(q, k, v, causal=True)),
        "library_ms": bench_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                                      is_causal=True)),
        "bound_ms": b3[0], "bound_by": b3[1], "achieved_tflops": flops / k3 / 1e9,
        "shape": f"B={b} H={h} S={s} D={d} causal bf16"}
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    k7 = bench_ms(lambda: flash_attention_bwd(q, k, v, o, lse, dout, True))
    qg_, kg_, vg_ = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg_, kg_, vg_, is_causal=True)
    lib, _ = bench_queued_or_not(
        lambda: torch.autograd.grad(sdpa_out, (qg_, kg_, vg_), dout, retain_graph=True))
    flops7 = 10 * d * b * h * s * (s + 1) // 2
    b7 = bound(8 * b * h * s * d * 2 + b * h * s * 4, flops7, BF16_FLOPS)
    out["flash_attention_bwd_d256"] = {
        "ms": k7, "plain_ms": bench_ms(lambda: flash_attention_bwd_plain(q, k, v, o, lse, dout,
                                                                         True)),
        "library_ms": lib, "bound_ms": b7[0], "bound_by": b7[1],
        "achieved_tflops": flops7 / k7 / 1e9,
        "shape": f"B={b} H={h} S={s} D={d} causal bf16"}
    del q, k, v, dout, o, lse, qg_, kg_, vg_, sdpa_out
    torch.cuda.empty_cache()
    c, off, hq, hkv, d = 256, 768, 8, 1, 256
    q = torch.randn((1, hq, c, d), generator=g, device="cuda").to(bf16)
    lens = torch.tensor([off + c], device="cuda", dtype=torch.int32)
    pairs = c * off + c * (c + 1) // 2
    for bits in (8, 4):
        cache, _ = random_paged_cache(70 + bits, lens.tolist(), hkv, page, bits, pps, d=d)
        ms = bench_ms(lambda: paged_context_attention(q, cache, lens, off))
        plain = bench_ms(lambda: paged_context_attention_reference(
            q, cache, lens, off, compute_dtype=bf16), queue_ahead=False)
        moved = 2 * c * hq * d * 2 + pps * 4 + 8 + paged_kv_bytes(lens.tolist(), hkv, d, page,
                                                                   bits)
        b6 = bound(moved, hq * pairs * 4 * d, BF16_FLOPS)
        out[f"paged_context_attention_d256_int{bits}"] = {
            "ms": ms, "plain_ms": plain, "library_ms": None, "bound_ms": b6[0],
            "bound_by": b6[1], "shape": f"B=1 Hq={hq} Hkv={hkv} C={c} D={d} offset={off} "
                                        f"page={page} kv_bits={bits}"}
        del cache
    torch.cuda.empty_cache()
    return out


# K3 and K7 edge cases on the bf16 route: lengths at the tensor-core
# kernels' tile edges (16-row warps, 64-row blocks and key tiles, 128-row
# query blocks), every pair of them (Sq != Sk both ways), at each compiled
# head width, causal and not
FLASH_EDGE_LENGTHS = (1, 63, 64, 65, 129)


def attention_grads_f64(q, k, v, dout, causal: bool) -> tuple:
    """dQ, dK, dV of sum(attention(q, k, v) * dout) in float64 through torch
    autograd: the gradient without any of the kernels' bf16 roundings."""
    q, k, v = (t.double().requires_grad_() for t in (q, k, v))
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        keep = (torch.arange(sk, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        s = s.masked_fill(~keep, float("-inf"))
    o = torch.matmul(torch.softmax(s, dim=-1), v)
    return torch.autograd.grad((o * dout.double()).sum(), (q, k, v))


def flash_edge_checks() -> dict:
    """K3 and K7 (bf16) against their plain versions at every (Sq, Sk) of
    ``FLASH_EDGE_LENGTHS``, D 32, 64 and 128, causal and not (B 2, H 3),
    at the parity phase's bf16 tolerances: O beyond 2^-7 relative at most
    1e-2 and lse at most 1e-4 (``k3_checks``); dQ, dK and dV beyond 2^-7
    relative at most 1e-3 * max|ref| (``k7_checks``).

    Two cases need more than that rule. Where every row attends one key
    (Sk 1, or causal at Sq 1) dQ and dK are 0 in exact arithmetic and a
    tolerance relative to their own max means nothing: there both sides'
    |dQ| and |dK| must stay under 1e-3 * max|dV|. In short causal rows P is
    O(1), so one bf16 rounding flip of a dS entry (both sides round dS from
    f32 values summed in different orders) moves dQ or dK by more than
    1e-3 * max|ref|: a gradient beyond the rule passes only if its max error
    against the float64 gradient (``attention_grads_f64``) is no larger than
    the plain version's plus 1e-3 * max|ref|, i.e. the kernel is as exact as
    the plain version. Each such pass is listed."""
    from qgemm_tpu_torch.ops.cuda.flash_attention import (flash_attention_fwd,
                                                          flash_attention_plain)
    from qgemm_tpu_torch.ops.cuda.flash_attention_bwd import (flash_attention_bwd,
                                                              flash_attention_bwd_plain)
    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    bf16, worst, failed, by_f64, n = torch.bfloat16, {}, [], [], 0
    for d in (32, 64, 128):
        for sq in FLASH_EDGE_LENGTHS:
            for sk in FLASH_EDGE_LENGTHS:
                for causal in (True, False):
                    q = torch.randn((2, 3, sq, d), generator=g, device="cuda").to(bf16)
                    k, v = (torch.randn((2, 3, sk, d), generator=g, device="cuda").to(bf16)
                            for _ in range(2))
                    dout = torch.randn((2, 3, sq, d), generator=g, device="cuda").to(bf16)
                    o, lse = flash_attention_fwd(q, k, v, causal=causal)
                    ro, rl = flash_attention_plain(q, k, v, causal=causal)
                    errs = {"o": (excess(o, ro, 2 ** -7), 1e-2), "lse": (max_err(lse, rl), 1e-4)}
                    got = flash_attention_bwd(q, k, v, o, lse, dout, causal)
                    ref = flash_attention_bwd_plain(q, k, v, o, lse, dout, causal)
                    exact = attention_grads_f64(q, k, v, dout, causal)
                    one_key = sk == 1 or (causal and sq == 1)
                    dv_scale = float(ref[2].float().abs().max())
                    case = {"sq": sq, "sk": sk, "d": d, "causal": causal}
                    for name, a, r, x in zip(("dq", "dk", "dv"), got, ref, exact):
                        if one_key and name != "dv":
                            errs[name] = (max(float(a.float().abs().max()),
                                              float(r.float().abs().max())), 1e-3 * dv_scale)
                            continue
                        tol = 1e-3 * float(r.float().abs().max())
                        errs[name] = (excess(a, r, 2 ** -7), tol)
                        if errs[name][0] > tol:
                            k_err = float((a.double() - x).abs().max())
                            p_err = float((r.double() - x).abs().max())
                            if k_err <= p_err + tol:
                                by_f64.append(dict(case, out=name, err=errs[name][0], tol=tol,
                                                   kernel_vs_f64=k_err, plain_vs_f64=p_err))
                                errs[name] = (k_err - p_err, tol)
                    for name, (e, tol) in errs.items():
                        n += 1
                        worst[name] = max(worst.get(name, float("-inf")), e - tol)
                        if not e <= tol:
                            failed.append(dict(case, out=name, err=e, tol=tol))
    return {"phase": "flash_edges", "checks": n, "lengths": list(FLASH_EDGE_LENGTHS),
            "worst_err_minus_tol": worst, "held_by_f64": by_f64, "failed": failed}


def phase_flash_edges() -> dict:
    """``flash_edge_checks``, failing if any check failed."""
    res = flash_edge_checks()
    emit(res)
    if res["failed"]:
        raise AssertionError(f"flash_edges: {len(res['failed'])} of {res['checks']} checks "
                             f"failed, first {res['failed'][0]}")
    return res


# ------------------------------------------------------------ the op layer
# GPT_6_7B's widths: 8192 tokens of d_model 4096 (scripts/sol_report.py's
# row-op shape), its 32 heads of 128 on a 2048-token prompt
# the share of K codes the pre-pass kernel may give off by 1 from the torch
# pre-pass's (its mean sums in another order: a few f32 ulps, which flip a
# code only where the centered value sits within them of a rounding edge):
# between the sound kernel's largest reading and the planted mean-over-(S-1)
# fault's (PERF.md section 6 gives both)
PREPASS_K_FLIP_SHARE = 1e-4
# K's row scales: the absmax of the centered K, a few ulps of K apart
PREPASS_SK_RTOL = 1e-5


def int8_flash_bounds(b: int, h: int, s: int, d: int, qk_only: bool) -> dict:
    """Bounds (ms) of row 12 at B, H, S, D (causal): the main kernel reads
    the codes (Q and K rows, V int8 or bf16) and scales once and writes a
    bf16 output, or does its two products over the causal pairs (int8 on
    the tensor cores; P V in bf16 with ``qk_only``); the pre-pass reads
    bf16 Q and K once and writes their codes and row scales, and with int8
    P also reads V once and writes its codes and channel scales (with
    ``qk_only`` V stays as it is: its read is the main kernel's)."""
    pairs = h * s * (s + 1) // 2 * b
    n = b * h * s * d
    v_bytes = (2 if qk_only else 1) * n
    t_bytes = (2 * n + v_bytes + n * 2 + 2 * b * h * s * 4) / HBM_BPS * 1e3
    t_ops = (2 * pairs * d / INT8_OPS
             + 2 * pairs * d / (BF16_FLOPS if qk_only else INT8_OPS)) * 1e3
    qk = 2 * n * 2 + 2 * n + 2 * b * h * s * 4   # Q, K read; their codes and scales written
    v_pre = 0 if qk_only else n * 2 + n + b * h * d * 4
    pre = (qk + v_pre) / HBM_BPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes_bound_ms": t_bytes, "ops_bound_ms": t_ops, "prepass_bound_ms": pre}


def nan_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape and dtype, NaN where the other is NaN (whatever its bits),
    and the same bits elsewhere."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and bits_equal(torch.where(na, torch.zeros_like(a), a),
                                              torch.where(nb, torch.zeros_like(b), b))


def prepass_check(q, k, v, qk_only: bool, label: str) -> dict:
    """The pre-pass kernel against the torch pre-pass on the card: Q's
    codes and scales, V's codes (or qk_only's bf16 V) and channel scales
    bit for bit (neither sums anything); K's codes within 1, at most
    ``PREPASS_K_FLIP_SHARE`` of them off by 1, and K's row scales within
    ``PREPASS_SK_RTOL`` (the mean over the sequence sums in the kernel's
    order); the padding of the code rows, of V's transposed tile and of K's
    scales zero. A NaN or inf in q, k or v: the scales NaN or inf where the
    torch pre-pass's are, and codes compared only on rows (Q, K) and
    channels (V) of finite scale (a NaN or inf scale makes the codes NaN,
    whose int8 cast torch leaves undefined; the kernel writes 0). Raises on
    a failure; returns the readings."""
    from qgemm_tpu_torch.ops.cuda.int8_flash_attention import (inputs_from_codes,
                                                               int8_flash_prepass,
                                                               int8_flash_prepass_cuda,
                                                               vt_in_key_order)
    codes = int8_flash_prepass_cuda(q, k, v, qk_only)
    got, want = inputs_from_codes(codes), int8_flash_prepass(q, k, v, qk_only)
    fq, fk = torch.isfinite(want.sq), torch.isfinite(want.sk)
    kd = torch.where(fk, (got.k8.int() - want.k8.int()).abs(), 0)
    compared = max(1, int(fk.sum()) * k.shape[3])
    sk_rel = float(torch.where(fk, (got.sk - want.sk).abs() / want.sk, 0).max())
    d, dv, sk_len = q.shape[3], v.shape[3], k.shape[2]
    pad_zero = not (bool(codes.q8[..., d:].any()) or bool(codes.k8[..., d:].any())
                    or bool(codes.sk[..., sk_len:].any()))
    if codes.vc is not None:
        pad_zero = pad_zero and not (bool(codes.v[:, :, dv:].any())
                                     or bool(vt_in_key_order(codes)[..., sk_len:].any()))
        fv = torch.isfinite(want.vc)
        v_equal = (torch.equal(torch.where(fv, got.v8, 0), torch.where(fv, want.v8, 0))
                   and nan_equal(got.vc, want.vc))
    else:
        pad_zero = pad_zero and not bool(codes.v[..., dv:].float().any())
        v_equal = nan_equal(got.v8, want.v8) and got.vc is None and want.vc is None
    row = {"case": label, "qk_only": qk_only, "shape": [list(q.shape), list(k.shape),
                                                       list(v.shape)],
           "q8_sq_equal": nan_equal(got.sq, want.sq) and torch.equal(
               torch.where(fq, got.q8, 0), torch.where(fq, want.q8, 0)),
           "v8_vc_equal": v_equal,
           "sk_nonfinite_equal": torch.equal(torch.isfinite(got.sk), fk)
           and torch.equal(torch.isnan(got.sk), torch.isnan(want.sk)),
           "nonfinite_scales": int((~fq).sum() + (~fk).sum()) + (
               0 if want.vc is None else int((~torch.isfinite(want.vc)).sum())),
           "k8_max_abs_err": float(kd.max()),
           "k8_share_off_by_1": float((kd == 1).sum()) / compared,
           "k8_flip_share_bound": PREPASS_K_FLIP_SHARE, "sk_max_rel_err": sk_rel,
           "sk_rtol": PREPASS_SK_RTOL, "padding_zero": pad_zero}
    emit({"phase": "int8_flash_prepass_check", **row})
    if not (row["q8_sq_equal"] and row["v8_vc_equal"] and row["sk_nonfinite_equal"]
            and row["k8_max_abs_err"] <= 1
            and row["k8_share_off_by_1"] <= PREPASS_K_FLIP_SHARE and sk_rel <= PREPASS_SK_RTOL
            and pad_zero):
        raise AssertionError(f"int8_flash_prepass check failed: {row}")
    return row


def nonfinite_inputs(q, k, v, with_inf: bool):
    """Copies of q, k, v [B, H >= 6, S, D] with a NaN in head 0's Q row 3,
    head 2's K row 10 (all of that head's centered K) and head 4's V
    channel 6; ``with_inf`` adds +inf to head 1's Q row 7, -inf to head 3's
    K and +inf to head 5's V channel 7."""
    q, k, v = q.clone(), k.clone(), v.clone()
    nan, inf = float("nan"), float("inf")
    q[0, 0, 3, 5], k[0, 2, 10, 4], v[0, 4, 20, 6] = nan, nan, nan
    if with_inf:
        q[0, 1, 7, 2], k[0, 3, 11, 1], v[0, 5, 30, 7] = inf, -inf, inf
    return q, k, v


ROW_SHAPE = (8192, 4096)
RAGGED_ROW_SHAPE = (33, 4100)
ATTN_SHAPE = (1, 32, 2048, 128)


def phase_ops_layer() -> dict:
    """The op layer's kernels (rows 14, 13 and 12) driven through their
    entry points at GPT_6_7B's widths, launch counts set to 0 just before
    and read just after; then each output held against its plain version
    and each kernel timed beside its bound, its plain version and the
    library call. Tolerances: softmax and LayerNorm in f32 at the JAX tests'
    own (rtol 1e-5 / atol 1e-6; rtol 1e-4 / atol 1e-5), in bf16 one bf16
    rounding on each side (2^-7 relative) beyond them. The int8 flash
    kernel against its plain version at the kernel's 64-key tiles (the same
    P codes up to an exp rounding; two bf16 roundings of the output, 2^-6
    relative, plus 2e-3), and, at JAX's key block and against f32
    attention, within JAX's own 5e-2 beyond the two bf16 roundings of a
    bf16 output (2^-7 relative), or, where the reference algorithm itself
    (the plain version at JAX's key block) is further off f32 attention on
    the same inputs, no further off than it; at the JAX tests' own case,
    5e-2 as they hold it."""
    import torch.nn.functional as F

    from qgemm_tpu_torch.ops import cuda as kernels
    from qgemm_tpu_torch.ops.cuda.flash_attention import (flash_attention_fwd,
                                                          flash_attention_plain)
    from qgemm_tpu_torch.ops.cuda.int8_flash_attention import (
        KERNEL_KEY_TILE, flash_attention_int8, flash_attention_int8_plain,
        int8_flash_attention_cuda, int8_flash_prepass, int8_flash_prepass_cuda)
    from qgemm_tpu_torch.ops.cuda.layernorm import layernorm_residual, layernorm_residual_plain
    from qgemm_tpu_torch.ops.cuda.softmax import softmax, softmax_plain
    from qgemm_tpu_torch.utils.profiling import bench_ms
    dev, bf16 = "cuda", torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    rows = {}
    for shape in (ROW_SHAPE, RAGGED_ROW_SHAPE):
        x = torch.randn(shape, generator=g, device=dev) * 3.0
        r = torch.randn(shape, generator=g, device=dev)
        gam = torch.randn(shape[-1], generator=g, device=dev)
        bet = torch.randn(shape[-1], generator=g, device=dev)
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            rows[(shape, dt)] = (x.to(dtype), r.to(dtype), gam, bet)
    b, h, s, d = ATTN_SHAPE
    q, k, v = (torch.randn((b, h, s, d), generator=g, device=dev).to(bf16) for _ in range(3))
    rq = torch.randn((1, 8, 100, 32), generator=g, device=dev)
    rk = torch.randn((1, 8, 130, 32), generator=g, device=dev)
    rv = torch.randn((1, 8, 130, 64), generator=g, device=dev)
    # tests/test_pallas_kernels.py's int8 flash case, its inputs as it makes
    # them: 1 x 2 x 256 x 64 f32 from numpy's generator at seed 5, then K
    # with a heavy per-channel mean
    rng = np.random.default_rng(5)
    jq, jk, jv = (torch.from_numpy(rng.normal(size=(1, 2, 256, 64)).astype(np.float32)).to(dev)
                  for _ in range(3))
    jk_off = jk + torch.from_numpy(rng.normal(size=(1, 1, 1, 64)) * 8.0).float().to(dev)
    jax_cases = [(jq, jk, jv, False), (jq, jk, jv, True), (jq, jk_off, jv, True)]
    # bf16 heads of 32 (V read as it is, half of the bf16 P V's N of 64
    # kept), and a V of 20 channels beside a D of 48 (V copied to bf16 rows
    # of 24; S on the code rows' first two k32 slices)
    narrow = [tuple(torch.randn(shape, generator=g, device=dev).to(bf16) for shape in shapes)
              + (causal,)
              for shapes, causal in ((((1, 4, 200, 32),) * 3, True),
                                     (((1, 2, 150, 48), (1, 2, 150, 48), (1, 2, 150, 20)), False))]

    # the path: every call through the op layer's entry points
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    outs = {}
    for key, (x, r, gam, bet) in rows.items():
        outs[("softmax",) + key] = softmax(x)
        outs[("layernorm_full",) + key] = layernorm_residual(x, r, gam, bet)
        outs[("layernorm_bare",) + key] = layernorm_residual(x)
    for qk_only in (False, True):
        outs[("int8_flash", qk_only)] = flash_attention_int8(q, k, v, causal=True,
                                                             qk_only=qk_only)
        for causal in (True, False):
            outs[("int8_flash_ragged", qk_only, causal)] = flash_attention_int8(
                rq, rk, rv, causal=causal, qk_only=qk_only)
    for i, (jq_, jk_, jv_, causal) in enumerate(jax_cases):
        outs[("int8_flash_jax_case", i)] = flash_attention_int8(jq_, jk_, jv_, causal=causal)
    for i, (nq_, nk_, nv_, causal) in enumerate(narrow):
        for qk_only in (False, True):
            outs[("int8_flash_narrow", i, qk_only)] = flash_attention_int8(
                nq_, nk_, nv_, causal=causal, qk_only=qk_only)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {name: 0 for name in counts}
    calls = 6 + len(jax_cases) + 2 * len(narrow)
    # the pre-pass: two launches a call (the column pass, then the row pass)
    want.update(softmax=len(rows), layernorm=2 * len(rows),
                int8_flash_prepass=2 * calls, int8_flash_attention=calls)
    if counts != want:
        raise AssertionError(f"ops_layer launches {counts}, expected {want}")

    # the pre-pass kernel against the torch pre-pass first, so that a fault
    # of its own fails here and not in the attention checks after it
    prepass = [prepass_check(qq, kk, vv, qk_only, label)
               for label, (qq, kk, vv) in (("gpt_6_7b", (q, k, v)), ("ragged", (rq, rk, rv)),
                                           ("jax_case", (jq, jk, jv)),
                                           ("jax_case_heavy_k_mean", (jq, jk_off, jv)),
                                           ("narrow_d32", narrow[0][:3]),
                                           ("d48_dv20", narrow[1][:3]),
                                           ("nonfinite", nonfinite_inputs(rq, rk, rv, True)))
               for qk_only in (False, True)]

    checks = []
    errs = {n: {"max_abs_err": 0.0, "max_rel_err": 0.0}
            for n in ("softmax", "layernorm", "int8_flash_attention")}

    def held(name, ok, got, ref, **row):
        e, rel = max_err(got, ref), rel_err(got, ref)
        errs[name]["max_abs_err"] = max(errs[name]["max_abs_err"], e)
        errs[name]["max_rel_err"] = max(errs[name]["max_rel_err"], rel)
        checks.append(dict(kernel=name, max_abs_err=e, **row))
        if not (ok and bool(torch.isfinite(got.float()).all())):
            raise AssertionError(f"ops_layer {name} {row}: max err {e}")

    def rowop_ok(got, ref, dt, rtol, atol):
        if dt == "float32":
            return excess(got, ref, rtol) <= atol
        return excess(got, ref, 2 ** -7 + rtol) <= atol

    for (shape, dt), (x, r, gam, bet) in rows.items():
        got, ref = outs[("softmax", shape, dt)], softmax_plain(x)
        held("softmax", rowop_ok(got, ref, dt, 1e-5, 1e-6), got, ref, shape=list(shape), dtype=dt)
        for kind, args in (("full", (x, r, gam, bet)), ("bare", (x,))):
            got, ref = outs[("layernorm_" + kind, shape, dt)], layernorm_residual_plain(*args)
            held("layernorm", rowop_ok(got, ref, dt, 1e-4, 1e-5), got, ref, shape=list(shape),
                 dtype=dt, residual_gamma_beta=kind == "full")

    def flash_checks(qq, kk, vv, causal, qk_only, got, **row):
        tiles = flash_attention_int8_plain(qq, kk, vv, causal, qk_only, block_k=KERNEL_KEY_TILE)
        default = flash_attention_int8_plain(qq, kk, vv, causal, qk_only)
        f32, _ = flash_attention_plain(qq.float(), kk.float(), vv.float(), causal)
        tight = excess(got, tiles, 2 ** -6) <= 2e-3 if got.dtype == bf16 \
            else max_err(got, tiles) <= 2e-3
        held("int8_flash_attention", tight, got, tiles, against="plain_at_kernel_key_tile",
             causal=causal, qk_only=qk_only, **row)
        # JAX's 5e-2 is for f32 outputs; a bf16 output rounds once in the
        # kernel and once in the epilogue (2^-7 relative together). Against
        # f32 attention, the int8 rounding's tail over millions of outputs
        # can pass 5e-2 in the reference algorithm itself (the plain
        # version at JAX's key block): the kernel may not be further off
        # than that, and its own tests' case below holds 5e-2 as they do
        rtol = 2 ** -7 if got.dtype == bf16 else 0.0
        held("int8_flash_attention", excess(got, default, rtol) < 5e-2, got, default,
             against="plain_at_jax_key_block", causal=causal, qk_only=qk_only, **row)
        jax_err = excess(default, f32, rtol)
        held("int8_flash_attention", excess(got, f32, rtol) < max(5e-2, jax_err), got, f32,
             against="f32_attention", causal=causal, qk_only=qk_only,
             plain_at_jax_key_block_excess=jax_err, **row)

    for qk_only in (False, True):
        flash_checks(q, k, v, True, qk_only, outs[("int8_flash", qk_only)],
                     shape=list(ATTN_SHAPE), dtype="bfloat16")
        for causal in (True, False):
            flash_checks(rq, rk, rv, causal, qk_only,
                         outs[("int8_flash_ragged", qk_only, causal)],
                         shape="B1 H8 Sq100 Sk130 D32 Dv64", dtype="float32")
    for i, (nq_, nk_, nv_, causal) in enumerate(narrow):
        for qk_only in (False, True):
            flash_checks(nq_, nk_, nv_, causal, qk_only, outs[("int8_flash_narrow", i, qk_only)],
                         shape=[list(nq_.shape), list(nv_.shape)], dtype="bfloat16")
    # a NaN in q, k or v reaches the output where it reaches the plain
    # version's (non-causal, so that every row meets every key in both)
    nan_q, nan_k, nan_v = nonfinite_inputs(rq, rk, rv, False)
    for qk_only in (False, True):
        got = flash_attention_int8(nan_q, nan_k, nan_v, causal=False, qk_only=qk_only)
        tiles = flash_attention_int8_plain(nan_q, nan_k, nan_v, False, qk_only,
                                           block_k=KERNEL_KEY_TILE)
        fin = torch.isfinite(tiles)
        same_nan = torch.equal(torch.isnan(got), torch.isnan(tiles))
        checks.append({"kernel": "int8_flash_attention", "against": "plain_nan_positions",
                       "qk_only": qk_only, "nan_outputs": int(torch.isnan(tiles).sum()),
                       "same_nan_positions": same_nan,
                       "finite_max_abs_err": max_err(got[fin], tiles[fin])})
        if not (same_nan and max_err(got[fin], tiles[fin]) <= 2e-3):
            raise AssertionError(f"ops_layer int8_flash_attention with NaN inputs: {checks[-1]}")
    for i, (jq_, jk_, jv_, causal) in enumerate(jax_cases):
        got = outs[("int8_flash_jax_case", i)]
        f32, _ = flash_attention_plain(jq_, jk_, jv_, causal)
        held("int8_flash_attention", max_err(got, f32) < 5e-2, got, f32, against="f32_attention",
             case="tests/test_pallas_kernels.py's", causal=causal, k_mean=i == 2)
    del outs

    # timing at GPT_6_7B's widths
    x, r, gam, bet = rows[(ROW_SHAPE, "float32")]
    n_el = x.numel()
    t_sm = {"ms": bench_ms(lambda: softmax(x)), "plain_ms": bench_ms(lambda: softmax_plain(x)),
            "library_ms": bench_ms(lambda: torch.softmax(x, dim=-1))}
    xb = rows[(ROW_SHAPE, "bfloat16")][0]
    t_sm.update(bf16_ms=bench_ms(lambda: softmax(xb)),
                bf16_library_ms=bench_ms(lambda: torch.softmax(xb, dim=-1)))
    bms, by = bound(2 * n_el * 4, 5 * n_el, BF16_FLOPS)
    t_sm.update(bound_ms=bms, bound_by=by, bf16_bound_ms=bound(2 * n_el * 2, 0, 1)[0],
                library_note="torch.softmax over the last axis",
                shape=f"[{ROW_SHAPE[0]}, {ROW_SHAPE[1]}] f32", **errs["softmax"])
    n = ROW_SHAPE[1]
    t_ln = {"ms": bench_ms(lambda: layernorm_residual(x, r, gam, bet)),
            "plain_ms": bench_ms(lambda: layernorm_residual_plain(x, r, gam, bet)),
            "library_ms": bench_ms(lambda: F.layer_norm(x, (n,), gam, bet)),
            "library_add_then_ln_ms": bench_ms(lambda: F.layer_norm(x + r, (n,), gam, bet)),
            "no_residual_ms": bench_ms(lambda: layernorm_residual(x, None, gam, bet))}
    bms, by = bound(3 * n_el * 4 + 2 * n * 4, 10 * n_el, BF16_FLOPS)
    t_ln.update(bound_ms=bms, bound_by=by,
                no_residual_bound_ms=bound(2 * n_el * 4 + 2 * n * 4, 0, 1)[0],
                library_note="F.layer_norm without the residual (one call); "
                             "library_add_then_ln_ms is F.layer_norm(x + r), two calls",
                shape=f"[{ROW_SHAPE[0]}, {ROW_SHAPE[1]}] f32, residual, gamma and beta",
                **errs["layernorm"])
    scale = 1.0 / math.sqrt(d)
    t_fa = {}
    for qk_only in (False, True):
        prep = int8_flash_prepass_cuda(q, k, v, qk_only)
        kern = bench_ms(lambda: int8_flash_attention_cuda(prep, True, scale, bf16))
        pre = bench_ms(lambda: int8_flash_prepass_cuda(q, k, v, qk_only))
        torch_pre = bench_ms(lambda: int8_flash_prepass(q, k, v, qk_only))
        whole = bench_ms(lambda: flash_attention_int8(q, k, v, True, qk_only))
        plain = bench_ms(lambda: flash_attention_int8_plain(q, k, v, True, qk_only),
                         queue_ahead=False)
        bounds = int8_flash_bounds(b, h, s, d, qk_only)
        t_fa[qk_only] = {"ms": kern, "prepass_ms": pre, "torch_prepass_ms": torch_pre,
                         "wrapper_ms": whole, "plain_ms": plain, **bounds}
        del prep
    t_fa = dict(t_fa[False], qk_only=t_fa[True])
    t_fa.update(library_ms=bench_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                                           is_causal=True)),
                library_note="F.scaled_dot_product_attention, causal, bf16: a yardstick of the "
                             "same attention in other numerics (bf16 products, no quantization)",
                k3_ms_same_shape=bench_ms(lambda: flash_attention_fwd(q, k, v, causal=True)),
                plain_timing="not queued ahead (host launches inside), at JAX's key block",
                shape=f"B={b} H={h} S={s} D={d} causal bf16", **errs["int8_flash_attention"])
    t_pre = {k_: t_fa[k_] for k_ in ("prepass_ms", "torch_prepass_ms", "prepass_bound_ms")}
    t_pre.update(ms=t_fa["prepass_ms"], bound_ms=t_fa["prepass_bound_ms"], bound_by="bytes",
                 plain_ms=t_fa["torch_prepass_ms"], library_ms=None,
                 qk_only_ms=t_fa["qk_only"]["prepass_ms"],
                 qk_only_bound_ms=t_fa["qk_only"]["prepass_bound_ms"],
                 plain_note="the torch pre-pass (int8_flash_prepass), the kernel's plain version",
                 library_note="no single PyTorch call computes the pre-pass",
                 shape=t_fa["shape"], checks=prepass,
                 max_abs_err=max(r["k8_max_abs_err"] for r in prepass),
                 max_rel_err=max(r["sk_max_rel_err"] for r in prepass))
    res = {"phase": "ops_layer", "launches": counts, "checks": checks,
           "softmax": t_sm, "layernorm": t_ln, "int8_flash_attention": t_fa,
           "int8_flash_prepass": t_pre}
    emit(res)
    return res


def use_tree(tree: str) -> Path:
    """Put checkout ``tree``'s qgemm_tpu_torch first on the import path and
    check that it is the one imported."""
    root = Path(tree).resolve()
    sys.path.insert(0, str(root))
    import qgemm_tpu_torch
    if Path(qgemm_tpu_torch.__file__).resolve().parents[1] != root:
        raise AssertionError(f"imported {qgemm_tpu_torch.__file__}, not {root}'s package")
    return root


def dense_step_child(tree: str) -> None:
    """One side of ``--dense-step-ab``: ``serve``'s int8 run (the same
    model, engine and 16 requests, without its checks of launches and
    transcripts) and its steady decode windows (``profile_decode``), with
    the kernels and the qgemm_tpu_torch package of checkout ``tree``.
    Prints one JSON line."""
    root = use_tree(tree)
    from qgemm_tpu_torch.models.gpt import GPT, GPT_6_7B
    from qgemm_tpu_torch.ops.cuda import _build
    from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
    _build.build()
    model = GPT.init_quantized(GPT_6_7B, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=p, max_new_tokens=n) for p, n in dense_requests(GPT_6_7B, rng)]
    engine = ContinuousBatchingEngine(model, max_slots=8, max_seq_len=1024,
                                      quantized_cache=True, device="cuda")
    run = drive(engine, reqs, f"dense_step {root}")
    stats = engine.stats
    emit({"tree": str(root), "decode_step_ms_mean": float(np.mean(run["step_ms"])),
          "decode_step_ms_median": float(np.median(run["step_ms"])), "stats": stats,
          "decode_profile": profile_decode(engine, rng)})


def ab_runs(child: str, label: str, other: str, rounds: int, timeout: int) -> tuple:
    """Run ``chip_smoke.py CHILD TREE`` for checkout ``other`` (an earlier
    commit, unpacked by ``git archive``) and this one, each in its own
    process, in turns (other, this, this, other, ``rounds`` times) so that
    drift of the host's or the card's speed falls on both alike. Emits each
    run (the child's last line) as a JSON line of phase ``label``; fails if
    a run fails.
    Returns (the two trees, the order, each side's runs)."""
    here = Path(__file__).resolve()
    trees = {"other": Path(other).resolve(), "this": here.parent}
    runs = {"other": [], "this": []}
    order = ["other", "this", "this", "other"] * rounds
    for name in order:
        proc = subprocess.run([sys.executable, str(here), child, str(trees[name])],
                              capture_output=True, text=True, timeout=timeout, check=False)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            raise AssertionError(f"{child} run of {trees[name]} exited {proc.returncode}")
        runs[name].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        emit({"phase": label, "side": name, **runs[name][-1]})
    return {k: str(v) for k, v in trees.items()}, order, runs


def dense_step_ab(other: str, rounds: int = 1) -> None:
    """The dense int8 serving run of checkout ``other`` against this one's
    (``dense_step_child`` in ``ab_runs``' turns). Prints each run and the
    means, medians and their ratios as JSON lines."""
    trees, order, runs = ab_runs("--dense-step-child", "dense_step_run", other, rounds, 600)
    keys = {"decode_step_ms_mean": lambda r: r["decode_step_ms_mean"],
            "steady_wall_ms_per_step": lambda r: r["decode_profile"]["wall_ms_per_step_untraced"],
            "steady_kernel_ms_per_step": lambda r: r["decode_profile"]["kernel_ms_per_step"],
            "tokens_per_s": lambda r: r["stats"]["tokens_per_s"]}
    res = {"phase": "dense_step_ab", "order": order, "trees": trees}
    for stat in ("mean", "median"):
        agg = {side: {k: float(getattr(np, stat)([f(r) for r in rs])) for k, f in keys.items()}
               for side, rs in runs.items()}
        res[stat] = agg
        res[f"ratio_this_over_other_{stat}"] = {k: agg["this"][k] / agg["other"][k]
                                                for k in keys}
    emit(res)


def flash_child(tree: str) -> None:
    """One side of ``--flash-ab``: with the kernels and the qgemm_tpu_torch
    package of checkout ``tree``, K3 at B 1, H 32, S 512 and at B 4, H 32,
    S 2048 (D 128, causal, bf16), K7 at the latter, the ``train`` step
    (``train_run``: median wall time of the timed steps and the traced
    step's device time) and the bf16 edge grid (``flash_edge_checks``,
    reported, not raised), and the sha256 of K3's and K7's outputs
    (``flash_hashes``). Prints one JSON line."""
    root = use_tree(tree)
    from qgemm_tpu_torch.ops.cuda import _build
    from qgemm_tpu_torch.ops.cuda.flash_attention import flash_attention_fwd
    from qgemm_tpu_torch.ops.cuda.flash_attention_bwd import flash_attention_bwd
    from qgemm_tpu_torch.utils.profiling import bench_ms
    _build.build(["flash_attention", "flash_attention_bwd"])
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    res = {"tree": str(root)}
    for b, s in ((1, 512), (4, 2048)):
        q, k, v, dout = (torch.randn((b, 32, s, 128), generator=g, device="cuda")
                         .to(torch.bfloat16) for _ in range(4))
        res[f"k3_ms_b{b}_s{s}"] = bench_ms(lambda: flash_attention_fwd(q, k, v, causal=True))
        if s == 2048:
            o, lse = flash_attention_fwd(q, k, v, causal=True)
            res["k7_ms_b4_s2048"] = bench_ms(
                lambda: flash_attention_bwd(q, k, v, o, lse, dout, True))
            del o, lse
        del q, k, v, dout
    torch.cuda.empty_cache()
    res["sha256"] = flash_hashes()
    train, _ = train_run()
    res.update(train_step_wall_ms_median=train["step_ms_median"],
               train_step_device_ms=train["traced_step"]["kernel_ms"],
               train_step_wall_ms_traced=train["traced_step"]["wall_ms_traced"],
               train_kernel_ms_by_family=train["traced_step"]["kernel_ms_by_family"],
               train_losses=train["losses"])
    edges = flash_edge_checks()
    res["edges"] = {k: edges[k] for k in ("checks", "worst_err_minus_tol", "held_by_f64",
                                          "failed")}
    emit(res)


def flash_hashes() -> dict:
    """sha256 of K3's (O, lse) and K7's (dQ, dK, dV) outputs, by head width
    32, 64 and 128 and dtype, over seeded inputs at Sq 129, Sk 65 and Sq =
    Sk = 200, causal and not, Dv = D: the shapes that ran before D 256,
    compared bit for bit between two checkouts by ``--flash-ab``."""
    from qgemm_tpu_torch.ops.cuda.flash_attention import flash_attention_fwd
    from qgemm_tpu_torch.ops.cuda.flash_attention_bwd import flash_attention_bwd
    g = torch.Generator(device="cuda")
    g.manual_seed(13)
    out = {}
    for d in (32, 64, 128):
        for dt in (torch.bfloat16, torch.float32):
            outs = []
            for sq, sk in ((129, 65), (200, 200)):
                for causal in (True, False):
                    q, dout = (torch.randn((2, 3, sq, d), generator=g, device="cuda").to(dt)
                               for _ in range(2))
                    k, v = (torch.randn((2, 3, sk, d), generator=g, device="cuda").to(dt)
                            for _ in range(2))
                    o, lse = flash_attention_fwd(q, k, v, causal=causal)
                    outs += [o, lse, *flash_attention_bwd(q, k, v, o, lse, dout, causal)]
            out[f"d{d}_{str(dt).split('.')[-1]}"] = sha256_of(*outs)
    return out


def flash_ab(other: str, rounds: int = 1) -> None:
    """K3, K7 and the ``train`` step of checkout ``other`` against this
    one's (``flash_child`` in ``ab_runs``' turns). Prints each run, the
    medians and the speed-ups, and whether K3's and K7's outputs were equal
    bit for bit in every run of both sides (``flash_hashes``; the train
    losses too); fails if they were not."""
    trees, order, runs = ab_runs("--flash-child", "flash_run", other, rounds, 900)
    keys = ("k3_ms_b1_s512", "k3_ms_b4_s2048", "k7_ms_b4_s2048", "train_step_wall_ms_median",
            "train_step_device_ms")
    med = {side: {k: float(np.median([r[k] for r in rs])) for k in keys}
           for side, rs in runs.items()}
    same, hashes = equal_hashes(runs, "sha256")
    same_loss, losses = equal_hashes(runs, "train_losses")
    emit({"phase": "flash_ab", "order": order, "trees": trees, "median": med,
          "speedup_other_over_this": {k: med["other"][k] / med["this"][k] for k in keys},
          "outputs_equal_bits": same, "sha256": hashes, "train_losses_equal": same_loss,
          "train_losses": losses})
    if not (same and same_loss):
        raise AssertionError("K3's or K7's outputs, or the train losses, differ between the "
                             "two checkouts")


GEMV_AB_ROWS = (1, 8, 16)
DECODE_KEYS = ("kernel_ms_per_step", "wall_ms_per_step_untraced", "idle_share_untraced")


def gemv_child(tree: str) -> None:
    """One side of ``--gemv-ab``: with the kernels and the qgemm_tpu_torch
    package of checkout ``tree``, bench_ms of K1 and K4 at the GPT_6_7B
    decode shapes (``GEMM_SHAPES``) and m 1, 8, 16 (bf16 x), of K8 at its two
    decode shapes (E 8, C 8, f32 x, five of eight rows empty, as
    ``k8_k9_timing``), and the int8 and W4A8 engines' steady decode windows
    (``profile_decode``: full-depth GPT_6_7B, 8 busy slots). Prints one JSON
    line."""
    root = use_tree(tree)
    from qgemm_tpu_torch.models.gpt import GPT, GPT_6_7B
    from qgemm_tpu_torch.ops.cuda import _build
    from qgemm_tpu_torch.ops.cuda.col_quantize import col_quantize
    from qgemm_tpu_torch.ops.cuda.expert_matmul import grouped_quantized_matmul
    from qgemm_tpu_torch.ops.quantize import (quantize_weights, quantize_weights_int4,
                                              quantized_matmul_prequant,
                                              quantized_matmul_prequant_w4)
    from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine
    from qgemm_tpu_torch.utils.profiling import bench_ms
    _build.build()
    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    res = {"tree": str(root), "k1_ms": {}, "k4_ms": {}, "k8_ms": {}}
    for k, n in GEMM_SHAPES:
        w = torch.randn((k, n), generator=g, device="cuda") * 0.02
        wq, wq4 = quantize_weights(w), quantize_weights_int4(w)
        del w
        for m in GEMV_AB_ROWS:
            x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
            res["k1_ms"][f"m{m}_k{k}_n{n}"] = bench_ms(lambda: quantized_matmul_prequant(x, wq))
            res["k4_ms"][f"m{m}_k{k}_n{n}"] = bench_ms(
                lambda: quantized_matmul_prequant_w4(x, wq4))
        del wq, wq4
    e = MOE_CFG["n_experts"]
    for k, n in MOE_GEMMS:
        wt, cw = col_quantize(torch.randn((e, k, n), generator=g, device="cuda") * 0.02)
        x = torch.randn((e, 8, k), generator=g, device="cuda")
        x[:, 3:] = 0.0
        relu = k == MOE_CFG["d_model"]
        res["k8_ms"][f"e{e}_c8_k{k}_n{n}"] = bench_ms(
            lambda: grouped_quantized_matmul(x, wt, cw, relu=relu))
        del wt, cw
    for label, qkw in (("int8", {}), ("w4a8", {"bits": 4})):
        model = GPT.init_quantized(GPT_6_7B, seed=0, device="cuda", **qkw)
        engine = ContinuousBatchingEngine(model, max_slots=8, max_seq_len=1024,
                                          quantized_cache=True, device="cuda")
        prof = profile_decode(engine, np.random.default_rng(0))
        res[f"decode_{label}"] = {**{k: prof[k] for k in DECODE_KEYS},
                                  **{f"{f}_ms_per_step": v
                                     for f, v in prof["family_ms_per_step"].items()}}
        del engine, model
        torch.cuda.empty_cache()
    emit(res)


def gemv_bounds() -> dict:
    """Byte bounds (ms) of ``gemv_child``'s timed shapes, by the timing
    phases' formulas: bf16 x, weights and scales read once, f32 out."""
    out = {}
    for k, n in GEMM_SHAPES:
        for m in GEMV_AB_ROWS:
            key = f"m{m}_k{k}_n{n}"
            out[f"k1_ms {key}"] = bound(m * k * 2 + k * n + n * 4 + m * n * 4, 0, INT8_OPS)[0]
            out[f"k4_ms {key}"] = bound(m * k * 2 + k * n // 2 + (k // 128) * n * 4 + m * n * 4,
                                        0, INT8_OPS)[0]
    e = MOE_CFG["n_experts"]
    for k, n in MOE_GEMMS:
        out[f"k8_ms e{e}_c8_k{k}_n{n}"] = bound(e * 8 * k * 4 + e * n * k + e * n * 4
                                                + e * 8 * n * 4, 0, INT8_OPS)[0]
    return out


def gemv_ab(other: str, rounds: int = 1) -> None:
    """K1, K4 and K8 at the decode shapes and the int8 and W4A8 decode steps
    of checkout ``other`` against this one's (``gemv_child`` in ``ab_runs``'
    turns). Prints each run, the medians, the speed-ups and each side's
    share of the byte bounds."""
    trees, order, runs = ab_runs("--gemv-child", "gemv_run", other, rounds, 900)

    def flat(r: dict) -> dict:
        return {f"{fam} {key}": v for fam in ("k1_ms", "k4_ms", "k8_ms", "decode_int8",
                                              "decode_w4a8") for key, v in r[fam].items()}

    med = {side: {key: float(np.median([flat(r)[key] for r in rs])) for key in flat(rs[0])}
           for side, rs in runs.items()}
    bounds = gemv_bounds()
    emit({"phase": "gemv_ab", "order": order, "trees": trees, "median": med,
          "speedup_other_over_this": {k: med["other"][k] / med["this"][k]
                                      for k in med["this"] if med["this"][k]},
          "bound_ms": bounds,
          "share_of_bound": {side: {k: b / med[side][k] for k, b in bounds.items()}
                             for side in med}})


TILE_AB_ROWS = (32, 128, 512)
PREFILL_BUCKETS = (128, 256, 512)
# kernel families of a prefill, by substrings of the kernels' names (the
# tile kernels' names before and after their redesign, so an A/B can read
# either tree; at 128 rows and more no GEMV runs)
PREFILL_FAMILIES = {"gemm_tiles": ("qmm_wgmma_kernel", "w4a8_wgmma_kernel", "qmm_mma_kernel",
                                   "w4a8_mma_kernel"),
                    "gemm_prepass": ("row_quantize_kernel",)}


def profile_prefill(model, bucket: int, runs: int = 5) -> dict:
    """One full-depth prefill of a ``bucket``-token prompt into a fresh
    int8 KV cache: the median wall time of ``runs`` prefills (each between
    synchronisations), and one traced by torch.profiler (CUDA activity):
    the device time (union of kernel intervals), the GEMM tile kernels' and
    pre-pass's time, and the device operations."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device="cuda")
    g.manual_seed(bucket)
    tokens = torch.randint(0, model.cfg.vocab_size, (1, bucket), generator=g, device="cuda")
    caches = model.init_cache(1, 1024, quantized=True)
    model.prefill(tokens, caches)       # warm
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.prefill(tokens, caches)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.prefill(tokens, caches)
        torch.cuda.synchronize()
    busy_us, by_name, n_spans = device_spans(prof)
    fams = {f: sum(us for name, us in by_name.items() if any(pt in name for pt in pats)) / 1e3
            for f, pats in PREFILL_FAMILIES.items()}
    return {"wall_ms": float(np.median(walls)), "wall_ms_runs": walls,
            "device_ms": busy_us / 1e3, "device_ops": n_spans,
            **{f"{f}_ms": v for f, v in fams.items()}}


def tile_child(tree: str) -> None:
    """One side of ``--tile-ab``: with the kernels and the qgemm_tpu_torch
    package of checkout ``tree``, bench_ms of K1 and K4 at the GPT_6_7B
    shapes (``GEMM_SHAPES``) and m 32, 128, 512 (bf16 x), of K8 at its two
    MoE products at C 168 and 328 (E 8, f32 x), of row 3's dynamic 2048^3
    (K9 + K1 on f32 operands), and one prefill of each bucket (128, 256, 512
    tokens) of the full-depth GPT_6_7B with int8 and with W4A8 weights
    (``profile_prefill``). Prints one JSON line."""
    root = use_tree(tree)
    from qgemm_tpu_torch.models.gpt import GPT, GPT_6_7B
    from qgemm_tpu_torch.ops.cuda import _build
    from qgemm_tpu_torch.ops.cuda.col_quantize import col_quantize
    from qgemm_tpu_torch.ops.cuda.expert_matmul import grouped_quantized_matmul
    from qgemm_tpu_torch.ops.quantize import (quantize_weights, quantize_weights_int4,
                                              quantized_matmul, quantized_matmul_prequant,
                                              quantized_matmul_prequant_w4)
    from qgemm_tpu_torch.utils.profiling import bench_ms
    _build.build()
    g = torch.Generator(device="cuda")
    g.manual_seed(13)
    res = {"tree": str(root), "k1_ms": {}, "k4_ms": {}, "k8_ms": {}}
    for k, n in GEMM_SHAPES:
        w = torch.randn((k, n), generator=g, device="cuda") * 0.02
        wq, wq4 = quantize_weights(w), quantize_weights_int4(w)
        del w
        for m in TILE_AB_ROWS:
            x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
            res["k1_ms"][f"m{m}_k{k}_n{n}"] = bench_ms(lambda: quantized_matmul_prequant(x, wq))
            res["k4_ms"][f"m{m}_k{k}_n{n}"] = bench_ms(
                lambda: quantized_matmul_prequant_w4(x, wq4))
        del wq, wq4
    e = MOE_CFG["n_experts"]
    for k, n in MOE_GEMMS:
        wt, cw = col_quantize(torch.randn((e, k, n), generator=g, device="cuda") * 0.02)
        relu = k == MOE_CFG["d_model"]
        for c in K8_TILE_ROWS[1:]:
            x = torch.randn((e, c, k), generator=g, device="cuda")
            res["k8_ms"][f"e{e}_c{c}_k{k}_n{n}"] = bench_ms(
                lambda: grouped_quantized_matmul(x, wt, cw, relu=relu))
        del wt, cw
    x = torch.rand((2048, 2048), generator=g, device="cuda") * 2 - 1
    w = torch.rand((2048, 2048), generator=g, device="cuda") * 2 - 1
    res["row3_ms"] = {"m2048_k2048_n2048": bench_ms(lambda: quantized_matmul(x, w))}
    del x, w
    for label, qkw in (("int8", {}), ("w4a8", {"bits": 4})):
        model = GPT.init_quantized(GPT_6_7B, seed=0, device="cuda", **qkw)
        res[f"prefill_{label}"] = {f"s{b}": profile_prefill(model, b) for b in PREFILL_BUCKETS}
        del model
        torch.cuda.empty_cache()
    emit(res)


def tile_bounds() -> dict:
    """Bounds (ms) of ``tile_child``'s timed kernels, by the timing phases'
    formulas: each input read once and each output written once over 3.35
    TB/s, or 2 m n k int8 operations over 1,979 TOP/s."""
    out = {}
    for k, n in GEMM_SHAPES:
        for m in TILE_AB_ROWS:
            key = f"m{m}_k{k}_n{n}"
            out[f"k1_ms {key}"] = bound(m * k * 2 + k * n + n * 4 + m * n * 4, 2 * m * n * k,
                                        INT8_OPS)[0]
            out[f"k4_ms {key}"] = bound(m * k * 2 + k * n // 2 + (k // 128) * n * 4 + m * n * 4,
                                        2 * m * n * k, INT8_OPS)[0]
    e = MOE_CFG["n_experts"]
    for k, n in MOE_GEMMS:
        for c in K8_TILE_ROWS[1:]:
            out[f"k8_ms e{e}_c{c}_k{k}_n{n}"] = bound(
                e * c * k * 4 + e * n * k + e * n * 4 + e * c * n * 4, 2 * e * c * n * k,
                INT8_OPS)[0]
    out["row3_ms m2048_k2048_n2048"] = bound(4 * 3 * 2048 * 2048, 2 * 2048 ** 3, INT8_OPS)[0]
    return out


def tile_ab(other: str, rounds: int = 1) -> None:
    """The tile kernels (K1, K4, K8 at m > 16, row 3) and the GPT_6_7B
    prefills of checkout ``other`` against this one's (``tile_child`` in
    ``ab_runs``' turns). Prints each run, the medians, the speed-ups and
    each side's share of the kernels' bounds."""
    trees, order, runs = ab_runs("--tile-child", "tile_run", other, rounds, 900)

    def flat(r: dict) -> dict:
        out = {f"{fam} {key}": v for fam in ("k1_ms", "k4_ms", "k8_ms", "row3_ms")
               for key, v in r[fam].items()}
        for label in ("int8", "w4a8"):
            for b, pr in r[f"prefill_{label}"].items():
                for stat in ("wall_ms", "device_ms", "gemm_tiles_ms", "gemm_prepass_ms"):
                    out[f"prefill_{label} {b} {stat}"] = pr[stat]
        return out

    med = {side: {key: float(np.median([flat(r)[key] for r in rs])) for key in flat(rs[0])}
           for side, rs in runs.items()}
    bounds = tile_bounds()
    emit({"phase": "tile_ab", "order": order, "trees": trees, "median": med,
          "speedup_other_over_this": {k: med["other"][k] / med["this"][k]
                                      for k in med["this"]},
          "bound_ms": bounds,
          "share_of_bound": {side: {k: b / med[side][k] for k, b in bounds.items()}
                             for side in med}})


# K5's timed lengths: row 9's (8 slots of 150-550 positions) and the steady
# decode window's (``profile_decode``: 8 slots of 300-token prompts, ~316
# positions in its traced window)
PAGED_AB_K5 = {"row9": [150, 210, 260, 330, 400, 450, 500, 550], "profile": [316] * 8}
PAGED_AB_CHUNK = 256        # K6's chunk rows, and the prompt's admission chunk
PAGED_AB_PROMPT = 1024      # the chunked prompt's tokens


def profile_chunked_prompt(model, runs: int = 3) -> dict:
    """One full-depth prompt of ``PAGED_AB_PROMPT`` tokens admitted into an
    int8 paged cache (pages of 128) in ``PAGED_AB_CHUNK``-row chunks, as the
    engine's chunked admission runs them (``GPT.prefill_chunk`` at offsets
    0, 256, ...; K6 in every layer of every chunk): the median wall time of
    ``runs`` prompts (each between synchronisations), and one traced by
    torch.profiler: device time (union of kernel intervals), K6's time and
    the device operations."""
    from torch.profiler import ProfilerActivity, profile

    from qgemm_tpu_torch.serving.paged_cache import init_paged_cache
    cfg = model.cfg
    ps = 128
    pps = PAGED_AB_PROMPT // ps
    hkv = cfg.n_kv_heads or cfg.n_heads
    caches = [init_paged_cache(hkv, cfg.d_model // cfg.n_heads, pps + 1, 1, pps, page_size=ps,
                               device="cuda") for _ in range(cfg.n_layers)]
    table = torch.arange(1, pps + 1, dtype=torch.int32, device="cuda")[None]
    for c in caches:
        c.page_table.copy_(table)
    g = torch.Generator(device="cuda")
    g.manual_seed(PAGED_AB_PROMPT)
    tokens = torch.randint(0, cfg.vocab_size, (1, PAGED_AB_PROMPT), generator=g, device="cuda")

    def prompt():
        for c0 in range(0, PAGED_AB_PROMPT, PAGED_AB_CHUNK):
            model.prefill_chunk(tokens[:, c0:c0 + PAGED_AB_CHUNK], c0, caches)

    prompt()        # warm
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        prompt()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prompt()
        torch.cuda.synchronize()
    busy_us, by_name, n_spans = device_spans(prof)
    k6_us = sum(us for name, us in by_name.items() if "paged_context" in name)
    return {"wall_ms": float(np.median(walls)), "wall_ms_runs": walls,
            "device_ms": busy_us / 1e3, "device_ops": n_spans, "paged_context_ms": k6_us / 1e3}


def paged_child(tree: str) -> None:
    """One side of ``--paged-ab``: with the kernels and the qgemm_tpu_torch
    package of checkout ``tree``, bench_ms of K5 (ragged entry; int8 and
    int4 pools of pages of 128; B 8, H 32, D 128, bf16 q) at
    ``PAGED_AB_K5``'s lengths, of K6 (B 1, H 32, C 256, D 128; int8 and int4;
    Hkv 32 and a GQA Hkv 8) after 0 and after 768 resident positions, the
    paged int8 engine's steady decode window (``profile_decode``: device
    time, K5's family, wall time, idle share) and one chunked GPT_6_7B
    prompt (``profile_chunked_prompt``), with the sha256 of each timed K5
    and K6 case's output (compared between the two sides). Prints one
    JSON line."""
    root = use_tree(tree)
    from qgemm_tpu_torch.models.gpt import GPT, GPT_6_7B
    from qgemm_tpu_torch.ops.cuda import _build
    from qgemm_tpu_torch.ops.cuda.paged_context_attention import paged_context_attention
    from qgemm_tpu_torch.ops.cuda.paged_decode_attention import paged_decode_attention_ragged
    from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine
    from qgemm_tpu_torch.utils.profiling import bench_ms
    _build.build()
    g = torch.Generator(device="cuda")
    g.manual_seed(10)
    res = {"tree": str(root), "k5_ms": {}, "k6_ms": {}, "sha256": {}}
    for label, lengths in PAGED_AB_K5.items():
        lens = torch.tensor(lengths, device="cuda", dtype=torch.int32)
        q = torch.randn((8, 32, 1, 128), generator=g, device="cuda").to(torch.bfloat16)
        for bits in (8, 4):
            cache, _ = random_paged_cache(30 + bits, lengths, 32, 128, bits, 8)
            res["k5_ms"][f"{label}_int{bits}"] = bench_ms(
                lambda: paged_decode_attention_ragged(q, cache, lens))
            res["sha256"][f"k5 {label}_int{bits}"] = sha256_of(
                paged_decode_attention_ragged(q, cache, lens))
            del cache
    for hkv in (32, 8):
        for off in (0, 768):
            lens = torch.tensor([off + PAGED_AB_CHUNK], device="cuda", dtype=torch.int32)
            q = torch.randn((1, 32, PAGED_AB_CHUNK, 128), generator=g,
                            device="cuda").to(torch.bfloat16)
            for bits in (8, 4):
                cache, _ = random_paged_cache(40 + bits, lens.tolist(), hkv, 128, bits, 8)
                res["k6_ms"][f"hkv{hkv}_off{off}_int{bits}"] = bench_ms(
                    lambda: paged_context_attention(q, cache, lens, off))
                res["sha256"][f"k6 hkv{hkv}_off{off}_int{bits}"] = sha256_of(
                    paged_context_attention(q, cache, lens, off))
                del cache
    torch.cuda.empty_cache()
    model = GPT.init_quantized(GPT_6_7B, seed=0, device="cuda")
    engine = ContinuousBatchingEngine(model, **PAGED_ENGINE)
    prof = profile_decode(engine, np.random.default_rng(0))
    res["decode_paged_int8"] = {**{k: prof[k] for k in DECODE_KEYS},
                                **{f"{f}_ms_per_step": v
                                   for f, v in prof["family_ms_per_step"].items()}}
    del engine
    torch.cuda.empty_cache()
    res["chunked_prompt"] = profile_chunked_prompt(model)
    emit(res)


def paged_bounds() -> dict:
    """Bounds (ms) of ``paged_child``'s timed kernels, by the timing phase's
    formulas: the K/V bytes the lengths need read once (``paged_kv_bytes``),
    q, the page table, the lengths and the output (bf16), or the bf16
    products (4 d operations per query head and attended position)."""
    out, h, d, page, pps = {}, 32, 128, 128, 8
    for label, lengths in PAGED_AB_K5.items():
        tot = sum(lengths)
        for bits in (8, 4):
            moved = 2 * 8 * h * d * 2 + 8 * (pps * 4 + 4) + paged_kv_bytes(lengths, h, d, page,
                                                                           bits)
            out[f"k5_ms {label}_int{bits}"] = bound(moved, tot * h * 4 * d, BF16_FLOPS)[0]
    c = PAGED_AB_CHUNK
    for hkv in (32, 8):
        for off in (0, 768):
            pairs = c * off + c * (c + 1) // 2
            for bits in (8, 4):
                moved = 2 * c * h * d * 2 + pps * 4 + 8 + paged_kv_bytes([off + c], hkv, d,
                                                                         page, bits)
                out[f"k6_ms hkv{hkv}_off{off}_int{bits}"] = bound(moved, h * pairs * 4 * d,
                                                                   BF16_FLOPS)[0]
    return out


def paged_ab(other: str, rounds: int = 1) -> None:
    """K5, K6, the paged decode step and a chunked prompt of checkout
    ``other`` against this one's (``paged_child`` in ``ab_runs``' turns).
    Prints each run, the medians, the speed-ups, each side's share of the
    kernels' bounds, and whether every timed K5 and K6 case gave the same
    bits in every run of both sides; fails if one did not."""
    trees, order, runs = ab_runs("--paged-child", "paged_run", other, rounds, 900)

    def flat(r: dict) -> dict:
        out = {f"{fam} {key}": v for fam in ("k5_ms", "k6_ms", "decode_paged_int8")
               for key, v in r[fam].items()}
        out.update({f"chunked_prompt {k}": r["chunked_prompt"][k]
                    for k in ("wall_ms", "device_ms", "paged_context_ms")})
        return out

    med = {side: {key: float(np.median([flat(r)[key] for r in rs])) for key in flat(rs[0])}
           for side, rs in runs.items()}
    bounds = paged_bounds()
    same, hashes = equal_hashes(runs, "sha256")
    emit({"phase": "paged_ab", "order": order, "trees": trees, "median": med,
          "speedup_other_over_this": {k: med["other"][k] / med["this"][k]
                                      for k in med["this"] if med["this"][k]},
          "bound_ms": bounds,
          "share_of_bound": {side: {k: b / med[side][k] for k, b in bounds.items()}
                             for side in med},
          "outputs_equal_bits": same, "sha256": hashes})
    if not same:
        raise AssertionError("K5's or K6's outputs differ between the two checkouts")


# K2's and K5's timed lengths in ``--decode-ab``: row 5's (8 slots of
# 150-550 positions, a cache extent of 1024) and 8 slots of 1,000
DECODE_AB_ROWS = {"row5": [150, 210, 260, 330, 400, 450, 500, 550], "s1000": [1000] * 8}
# K5's cases whose outputs ``--decode-ab`` compares bit for bit between the
# two checkouts (and K2's on the int8 cases' rows, int8 and bf16 caches):
# (page, KV heads, kv_bits)
DECODE_AB_K5_BITS = [(128, 32, 8), (128, 32, 4), (32, 8, 8), (16, 8, 4)]


def sha256_of(*tensors) -> str:
    """One sha256 over the bytes of ``tensors`` (as float32 on the host):
    the A/B modes compare a kernel's outputs between two checkouts bit for
    bit."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def equal_hashes(runs: dict, key: str) -> tuple:
    """Whether every run of both sides gave the same ``key`` hashes, and
    those of the first run."""
    hashes = [r[key] for rs in runs.values() for r in rs]
    return all(h == hashes[0] for h in hashes), hashes[0]


def host_us(fn, calls: int = 200) -> float:
    """The host's microseconds per call of ``fn``, a wrapper that only
    queues device work: ``calls`` calls back to back, timed on the host
    clock up to the last enqueue (the launch queue holds them all), the
    median of 5 such runs, each after the device went idle."""
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t) * 1e6 / calls)
    torch.cuda.synchronize()
    return float(np.median(runs))


def decode_child(tree: str) -> None:
    """One side of ``--decode-ab``: with the kernels and the qgemm_tpu_torch
    package of checkout ``tree``, bench_ms of K2 (int8 cache, B 8, H 32, S
    1024, D 128, bf16 q) and of K5 (ragged entry, int8 pools of pages of
    128, the same rows) at ``DECODE_AB_ROWS``' lengths; the sha256 of K5's and K2's
    outputs on ``DECODE_AB_K5_BITS``' seeded pools (compared between the
    two sides); the host's microseconds per wrapper call at row 5's shape
    (``host_us``); and the steady decode windows (``profile_decode``: device
    time, the K2 family, device operations, wall time, idle share) of the
    dense int8 engine on the full-depth GPT_6_7B and on the MoE GPT
    (``MOE_CFG``). Prints one JSON line."""
    import hashlib
    root = use_tree(tree)
    from qgemm_tpu_torch.models.gpt import GPT, GPT_6_7B, GPTConfig
    from qgemm_tpu_torch.ops.cuda import _build
    from qgemm_tpu_torch.ops.cuda.decode_attention import decode_attention
    from qgemm_tpu_torch.ops.cuda.paged_decode_attention import paged_decode_attention_ragged
    from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine
    from qgemm_tpu_torch.serving.paged_cache import gather_slot_kv
    from qgemm_tpu_torch.utils.profiling import bench_ms
    _build.build()
    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    res = {"tree": str(root), "k2_ms": {}, "k5_ms": {}, "k5_sha256": {}}
    for label, lengths in DECODE_AB_ROWS.items():
        lens = torch.tensor(lengths, device="cuda", dtype=torch.int32)
        q = torch.randn((8, 32, 1, 128), generator=g, device="cuda").to(torch.bfloat16)
        cache, _ = random_paged_cache(50, lengths, 32, 128, 8, 8)
        kq, kc, vq, vc = gather_slot_kv(cache)
        res["k2_ms"][label] = bench_ms(lambda: decode_attention(q, kq, vq, lens, kc=kc, vc=vc))
        res["k5_ms"][label] = bench_ms(lambda: paged_decode_attention_ragged(q, cache, lens))
        if label == "row5":
            res["k2_host_us"] = host_us(lambda: decode_attention(q, kq, vq, lens, kc=kc, vc=vc))
            res["k5_host_us"] = host_us(lambda: paged_decode_attention_ragged(q, cache, lens))
        del cache, kq, kc, vq, vc
    lens = torch.tensor([0, 1, 128, 129, 300, 640, 1000, 1024], device="cuda",
                        dtype=torch.int32)
    res["k2_sha256"] = {}
    for page, hkv, bits in DECODE_AB_K5_BITS:
        cache, _ = random_paged_cache(90 + page + bits, lens.tolist(), hkv, page, bits,
                                      1024 // page)
        q = torch.randn((8, 32, 1, 128), generator=g, device="cuda").to(torch.bfloat16)
        out = paged_decode_attention_ragged(q, cache, lens)
        res["k5_sha256"][f"page{page}_hkv{hkv}_int{bits}"] = hashlib.sha256(
            out.float().cpu().numpy().tobytes()).hexdigest()
        if bits == 8:   # K2 on the same rows: its int8 route, and a bf16 cache
            kq, kc, vq, vc = gather_slot_kv(cache)
            res["k2_sha256"][f"page{page}_hkv{hkv}_int8"] = sha256_of(
                decode_attention(q, kq, vq, lens, kc=kc, vc=vc))
            kf, vf = ((t.float() * c / 127).to(torch.bfloat16) for t, c in ((kq, kc), (vq, vc)))
            res["k2_sha256"][f"page{page}_hkv{hkv}_bf16_cache"] = sha256_of(
                decode_attention(q, kf, vf, lens))
            del kq, kc, vq, vc, kf, vf
        del cache
    torch.cuda.empty_cache()
    for label, cfg in (("int8", GPT_6_7B), ("moe_int8", GPTConfig(**MOE_CFG))):
        model = GPT.init_quantized(cfg, seed=0, device="cuda")
        engine = ContinuousBatchingEngine(model, max_slots=8, max_seq_len=1024,
                                          quantized_cache=True, device="cuda")
        prof = profile_decode(engine, np.random.default_rng(0))
        res[f"decode_{label}"] = {
            **{k: prof[k] for k in DECODE_KEYS},
            "device_events_per_step": prof["device_events_per_step"],
            **{f"{f}_ms_per_step": v for f, v in prof["family_ms_per_step"].items()}}
        del engine, model
        torch.cuda.empty_cache()
    emit(res)


def decode_bounds() -> dict:
    """Bounds (ms) of ``decode_child``'s timed kernels, by the timing
    phase's formulas: q and the output (bf16), and K and V codes and scales
    of every attended position read once (K5: ``paged_kv_bytes`` and its
    page table and lengths), or the bf16 products."""
    out, h, d = {}, 32, 128
    for label, lengths in DECODE_AB_ROWS.items():
        tot = sum(lengths)
        out[f"k2_ms {label}"] = bound(8 * h * d * 2 * 2 + tot * h * (2 * d + 8),
                                      tot * h * 4 * d, BF16_FLOPS)[0]
        out[f"k5_ms {label}"] = bound(2 * 8 * h * d * 2 + 8 * (8 * 4 + 4)
                                      + paged_kv_bytes(lengths, h, d, 128, 8),
                                      tot * h * 4 * d, BF16_FLOPS)[0]
    return out


def decode_kernels_ab(other: str, rounds: int = 1) -> None:
    """K2, K5 and the dense int8 and MoE decode steps of checkout ``other``
    against this one's (``decode_child`` in ``ab_runs``' turns). Prints each
    run, the medians, the speed-ups, each side's share of the kernels'
    bounds, and whether K5's outputs were equal bit for bit in every run of
    both sides; fails if they were not."""
    phase_device()
    trees, order, runs = ab_runs("--decode-child", "decode_run", other, rounds, 900)

    def flat(r: dict) -> dict:
        out = {f"{fam} {key}": v for fam in ("k2_ms", "k5_ms", "decode_int8", "decode_moe_int8")
               for key, v in r[fam].items()}
        out.update({k: r[k] for k in ("k2_host_us", "k5_host_us")})
        return out

    med = {side: {key: float(np.median([flat(r)[key] for r in rs])) for key in flat(rs[0])}
           for side, rs in runs.items()}
    bounds = decode_bounds()
    same, k5_hash = equal_hashes(runs, "k5_sha256")
    same2, k2_hash = equal_hashes(runs, "k2_sha256")
    emit({"phase": "decode_ab", "order": order, "trees": trees, "median": med,
          "speedup_other_over_this": {k: med["other"][k] / med["this"][k]
                                      for k in med["this"] if med["this"][k]},
          "bound_ms": bounds,
          "share_of_bound": {side: {k: b / med[side][k] for k, b in bounds.items()}
                             for side in med},
          "k5_outputs_equal_bits": same, "k5_sha256": k5_hash,
          "k2_outputs_equal_bits": same2, "k2_sha256": k2_hash})
    if not (same and same2):
        raise AssertionError("K5's or K2's outputs differ between the two checkouts")


# Faults that ``--decode-faults`` plants, each in its own copy of the
# checkout's package: a line of the split merge and its faulty form (the
# first split's state left out of the sums, the last split's, or the states
# summed without their exp(m_s - m) rescale). The merge lives in the first
# of DECODE_FAULT_SOURCES that the checkout has: the split body K2 and K5
# share or, in an earlier checkout, K5's own source.
DECODE_FAULT_SOURCES = ("split_decode.cuh", "paged_decode_attention.cu")
MERGE_LOOP = "    for (int s = 0; s < nsplit_live; ++s) {\n"
DECODE_FAULTS = {
    "drop_first_split": (MERGE_LOOP, "    for (int s = 1; s < nsplit_live; ++s) {\n"),
    "drop_last_split": (MERGE_LOOP, "    for (int s = 0; s < nsplit_live - 1; ++s) {\n"),
    "merge_without_rescale": ("      const float f = expf(__ldcg(ss + G * D + g) - mx);\n",
                              "      const float f = 1.f;\n"),
}
# the faults the long copy model's accuracy bound must catch on every engine
# whose decode kernel carries them
LONG_COPY_CATCHES = ("drop_first_split", "drop_last_split")


def carries_fault(csrc: Path, source: str, kernel: str) -> bool:
    """Whether ``csrc/<kernel>.cu`` is the fault's ``source`` or includes it."""
    return (kernel + ".cu" == source
            or f'#include "{source}"' in (csrc / f"{kernel}.cu").read_text())


def paged_logits(n: int) -> None:
    """``--paged-logits``: ``paged_logit_reading`` for the two short prompts
    of ``paged_requests`` and ``n`` more random prompts of 128-500 tokens
    (those past 256 admitted in 256-row chunks, through K6), max_new_tokens
    16-48, on the full-depth int8 GPT_6_7B. Prints one JSON line per
    request, then the largest readings (of all, and of the two short
    prompts) beside ``PAGED_LOGIT_RTOL``."""
    from qgemm_tpu_torch.models.gpt import GPT, GPT_6_7B
    from qgemm_tpu_torch.ops.cuda import _build
    _build.build()
    model = GPT.init_quantized(GPT_6_7B, seed=0, device="cuda")
    vocab = GPT_6_7B.vocab_size
    prompts, news, short = paged_requests(vocab, np.random.default_rng(7))
    rng = np.random.default_rng(11)
    todo = [(prompts[i], news[i]) for i in short]
    for _ in range(n):
        plen, m = int(rng.integers(128, 501)), int(rng.integers(16, 49))
        todo.append((rng.integers(0, vocab, size=plen).tolist(), m))
    worst = []
    for k, (prompt, m) in enumerate(todo):
        w = paged_logit_reading(model, prompt, m)
        emit({"phase": "paged_logits", "request": k, "short": k < len(short),
              **{key: v for key, v in w.items() if key not in ("generate", "paged_alone")}})
        worst.append(w["logit_rel_diff_max"])
    emit({"phase": "paged_logits_summary", "requests": len(todo),
          "logit_rel_diff_max": max(worst), "short_prompts_max": max(worst[:len(short)]),
          "by_request": worst, "rtol": PAGED_LOGIT_RTOL})


def long_copy_child(ckpt: str, only: Optional[str] = None) -> None:
    """``--long-copy CKPT [ONLY]``: ``long_copy_readings`` of the model in
    ``CKPT`` (trained and saved there first if it is missing; the engines
    whose name holds ``ONLY``), one JSON line."""
    from qgemm_tpu_torch.ops.cuda import _build
    _build.build()
    emit({"phase": "long_copy", **long_copy_readings(Path(ckpt), only)})


def package_copy(tmp: str, src: Path, name: str, patch: Optional[tuple] = None) -> Path:
    """A copy of this script beside checkout ``src``'s qgemm_tpu_torch in
    ``tmp``/``name`` (with the libraries of the copy named "sound", once it
    has built them), and ``patch`` (a path under the package, its sound
    text, the faulty text) applied once. Returns the copied script."""
    here = Path(__file__).resolve()
    root = Path(tmp) / name
    shutil.copytree(src / "qgemm_tpu_torch", root / "qgemm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    built = Path(tmp) / "sound" / "build"
    if built.exists():
        shutil.copytree(built, root / "build")
    shutil.copy2(here, root / here.name)
    if patch is not None:
        path, old, new = patch
        f = root / "qgemm_tpu_torch" / path
        text = f.read_text()
        if text.count(old) != 1:
            raise AssertionError(f"fault {name}: its line is not once in {path}")
        f.write_text(text.replace(old, new))
    return root / here.name


def decode_faults(n: int, tree: Optional[str] = None) -> None:
    """``--decode-faults``: with the kernels of checkout ``tree`` (default
    this one), in a copy of its package beside this script, ``--long-copy``
    (which trains the long copy model once and saves it in a temporary
    directory) and ``--paged-logits n``; then, for each of ``DECODE_FAULTS``
    planted in another such copy (the libraries the fault leaves alone
    copied as built), the parity of each decode kernel
    that carries the fault (``--only paged`` for K5, ``--only k2`` for K2),
    ``--long-copy`` on the saved model and ``--paged-logits n``, one
    process each. Prints each run's lines, then every reading beside its
    bound: the long copy's accuracy floor and ``PAGED_LOGIT_RTOL`` (on the
    two short prompts, those ``serve_paged`` checks), with whether each
    bound lies between the sound and the faulty readings. Fails if the
    sound run breaks a bound, a fault passes a carrying kernel's parity,
    or one of ``LONG_COPY_CATCHES`` passes the accuracy bound of an engine
    whose kernel carries it."""
    phase_device()
    here = Path(__file__).resolve()
    src = Path(tree).resolve() if tree else here.parent
    csrc = src / "qgemm_tpu_torch" / "csrc"
    source = next(f for f in DECODE_FAULT_SOURCES if (csrc / f).exists())
    logits, copies, parity = {}, {}, {}

    def run(name: str, script: Path, *args: str) -> subprocess.CompletedProcess:
        proc = subprocess.run([sys.executable, str(script), *args], capture_output=True,
                              text=True, timeout=1200, check=False)
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                emit({"fault": name, "mode": args[0] + (" " + args[1] if args[0] == "--only"
                                                         else ""), **json.loads(line)})
        return proc

    def last_line(name: str, script: Path, *args: str) -> dict:
        proc = run(name, script, *args)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            raise AssertionError(f"{args[0]} of {name} exited {proc.returncode}")
        return json.loads(proc.stdout.strip().splitlines()[-1])

    engines = [k for k, v in LONG_COPY_ENGINES.items() if carries_fault(csrc, source, v[1])]
    kernels = {k: phase for k, phase in (("paged_decode_attention", "paged"),
                                         ("decode_attention", "k2"))
               if carries_fault(csrc, source, k)}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "long_copy.npz")
        script = package_copy(tmp, src, "sound")
        copies["sound"] = last_line("sound", script, "--long-copy", ckpt)
        logits["sound"] = last_line("sound", script, "--paged-logits", str(n))
        for name, (old, new) in DECODE_FAULTS.items():
            script = package_copy(tmp, src, name, (f"csrc/{source}", old, new))
            parity[name] = {}
            for kernel, phase in kernels.items():
                proc = run(name, script, "--only", phase)
                tail = proc.stderr.strip().splitlines()
                parity[name][kernel] = {"exit": proc.returncode,
                                        "error": tail[-1] if tail else ""}
            copies[name] = last_line(name, script, "--long-copy", ckpt)
            logits[name] = last_line(name, script, "--paged-logits", str(n))
    sound_copy = copies.pop("sound")
    floor = sound_copy["training"]["heldout_acc"] - LONG_COPY_SLACK
    acc = lambda r: {k: v["copy_acc"] for k, v in r["engines"].items()}
    sound_logits = logits.pop("sound")
    short = {k: v["short_prompts_max"] for k, v in logits.items()}
    emit({"phase": "decode_faults", "tree": str(src), "fault_source": source,
          "engines_carrying": engines, "kernels_carrying": list(kernels),
          "long_copy": {"floor": floor, "sound": acc(sound_copy),
                        "sound_equal_to_generate": {k: v["equal_to_generate"] for k, v in
                                                    sound_copy["engines"].items()},
                        "faults": {k: acc(v) for k, v in copies.items()},
                        "floor_separates": {e: {k: acc(v)[e] < floor <= acc(sound_copy)[e]
                                                for k, v in copies.items()} for e in engines}},
          "paged_logits": {"rtol": PAGED_LOGIT_RTOL,
                           "sound_short_prompts_max": sound_logits["short_prompts_max"],
                           "sound_max": sound_logits["logit_rel_diff_max"],
                           "fault_short_prompts_max": short,
                           "fault_max": {k: v["logit_rel_diff_max"] for k, v in logits.items()},
                           "rtol_separates": {k: sound_logits["logit_rel_diff_max"]
                                              <= PAGED_LOGIT_RTOL < v for k, v in short.items()}},
          "fault_parity": parity})
    bad = long_copy_failures(sound_copy)
    if not sound_logits["logit_rel_diff_max"] <= PAGED_LOGIT_RTOL:
        bad.append(f"sound paged logits {sound_logits['logit_rel_diff_max']} > "
                   f"{PAGED_LOGIT_RTOL}")
    bad += [f"{name} passed the parity of {k}" for name, r in parity.items()
            for k, v in r.items() if v["exit"] == 0]
    bad += [f"{name}: {b}" for name in LONG_COPY_CATCHES
            for b in long_copy_failures(copies[name], engines)]
    if bad:
        raise AssertionError(f"decode faults: {bad}")


# K9's timed shapes in ``--quant-ab``: k8_k9_timing's (the MoE model's two
# expert weights and the dynamic GEMM's 2048^2 f32)
QUANT_AB_K9 = ((MOE_CFG["n_experts"], 2048, 4096, "bfloat16"),
               (MOE_CFG["n_experts"], 4096, 2048, "bfloat16"), (1, 2048, 2048, "float32"))


def quant_child(tree: str) -> None:
    """One side of ``--quant-ab``: with the kernels and the qgemm_tpu_torch
    package of checkout ``tree``, bench_ms of K9 at ``QUANT_AB_K9``' shapes,
    of the dynamic GEMM at 2048^3 (``gemm_protocol``'s ``int8_dynamic_ms``),
    and of row 12 at ``ATTN_SHAPE`` (causal, bf16; int8 P and ``qk_only``):
    its main kernel on a pre-pass's codes, its pre-pass (the pre-pass kernel,
    or in a checkout without one the torch pre-pass) and the whole wrapper.
    The MoE load's K9 total is the model's 24 layers times the two expert
    weights' times. The outputs' hashes (``sha256``: K9's codes and scales,
    the dynamic GEMM's output, K8's at a GEMV and a tile shape, row 12's
    wrapper output), which ``--quant-ab`` holds equal between the two
    checkouts. Prints one JSON line."""
    root = use_tree(tree)
    from qgemm_tpu_torch.ops.cuda import _build
    from qgemm_tpu_torch.ops.cuda import int8_flash_attention as fa
    from qgemm_tpu_torch.ops.cuda.col_quantize import col_quantize
    from qgemm_tpu_torch.ops.cuda.expert_matmul import grouped_quantized_matmul
    from qgemm_tpu_torch.ops.quantize import quantized_matmul
    from qgemm_tpu_torch.utils.profiling import bench_ms
    _build.build()
    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    res = {"tree": str(root), "k9_ms": {}, "sha256": {}}
    for e, k, n, dt in QUANT_AB_K9:
        w = (torch.randn((e, k, n), generator=g, device="cuda") * 0.02).to(getattr(torch, dt))
        w = w[0] if e == 1 else w
        res["k9_ms"][f"{e}x{k}x{n} {dt}"] = bench_ms(lambda: col_quantize(w))
        res["sha256"][f"k9 {e}x{k}x{n} {dt}"] = sha256_of(*col_quantize(w))
        del w
    up, down = (res["k9_ms"][f"{e}x{k}x{n} {dt}"] for e, k, n, dt in QUANT_AB_K9[:2])
    res["k9_moe_load_ms"] = MOE_CFG["n_layers"] * (up + down)
    x = torch.rand((2048, 2048), generator=g, device="cuda") * 2 - 1
    w = torch.rand((2048, 2048), generator=g, device="cuda") * 2 - 1
    res["int8_dynamic_ms"] = bench_ms(lambda: quantized_matmul(x, w))
    res["sha256"]["dynamic 2048^3"] = sha256_of(quantized_matmul(x, w))
    del x, w
    for c_rows in (8, 168):   # K8's GEMV and tile kernel
        x = torch.randn((8, c_rows, 2048), generator=g, device="cuda").to(torch.bfloat16)
        wt = torch.randint(-127, 128, (8, 4096, 2048), generator=g, device="cuda",
                           dtype=torch.int8)
        cw = torch.rand((8, 1, 4096), generator=g, device="cuda") * 0.01 + 1e-3
        res["sha256"][f"k8 C{c_rows}"] = sha256_of(grouped_quantized_matmul(x, wt, cw,
                                                                            relu=True))
        del x, wt, cw
    b, h, s_, d = ATTN_SHAPE
    q, k, v = (torch.randn((b, h, s_, d), generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    prepass = getattr(fa, "int8_flash_prepass_cuda", fa.int8_flash_prepass)
    scale = 1.0 / math.sqrt(d)
    for qk_only in (False, True):
        tag = "qk_only" if qk_only else "int8_p"
        prep = prepass(q, k, v, qk_only)
        res[f"row12_kernel_ms {tag}"] = bench_ms(
            lambda: fa.int8_flash_attention_cuda(prep, True, scale, torch.bfloat16))
        res[f"row12_prepass_ms {tag}"] = bench_ms(lambda: prepass(q, k, v, qk_only))
        res[f"row12_wrapper_ms {tag}"] = bench_ms(
            lambda: fa.flash_attention_int8(q, k, v, True, qk_only))
        res["sha256"][f"row12 {tag}"] = sha256_of(fa.flash_attention_int8(q, k, v, True,
                                                                          qk_only))
        del prep
    emit(res)


def quant_bounds() -> dict:
    """Bounds (ms) of ``quant_child``'s timed work, by the timing phases'
    formulas: K9 reads w once and writes its codes and scales; the dynamic
    GEMM ``gemm_protocol``'s; row 12 ``int8_flash_bounds``."""
    out = {}
    for e, k, n, dt in QUANT_AB_K9:
        el = e * k * n
        out[f"k9_ms {e}x{k}x{n} {dt}"] = bound(el * (4 if dt == "float32" else 2) + el
                                               + e * n * 4, 0, INT8_OPS)[0]
    out["k9_moe_load_ms"] = MOE_CFG["n_layers"] * sum(
        out[f"k9_ms {e}x{k}x{n} {dt}"] for e, k, n, dt in QUANT_AB_K9[:2])
    m = 2048
    out["int8_dynamic_ms"] = bound(4 * 3 * m * m, 2 * m ** 3, INT8_OPS)[0]
    for qk_only, tag in ((False, "int8_p"), (True, "qk_only")):
        bd = int8_flash_bounds(*ATTN_SHAPE, qk_only)
        out[f"row12_kernel_ms {tag}"] = bd["bound_ms"]
        out[f"row12_prepass_ms {tag}"] = bd["prepass_bound_ms"]
        out[f"row12_wrapper_ms {tag}"] = bd["bound_ms"] + bd["prepass_bound_ms"]
    return out


def quant_ab(other: str, rounds: int = 1) -> None:
    """K9, the dynamic GEMM and row 12 of checkout ``other`` against this
    one's (``quant_child`` in ``ab_runs``' turns). Prints each run, the
    medians, the speed-ups and each side's share of the bounds."""
    smi = phase_device()
    trees, order, runs = ab_runs("--quant-child", "quant_run", other, rounds, 600)

    def flat(r: dict) -> dict:
        out = {f"k9_ms {key}": v for key, v in r["k9_ms"].items()}
        out.update({k: v for k, v in r.items()
                    if k not in ("k9_ms", "sha256", "tree", "phase", "side")})
        return out

    med = {side: {key: float(np.median([flat(r)[key] for r in rs])) for key in flat(rs[0])}
           for side, rs in runs.items()}
    bounds = quant_bounds()
    same, hashes = equal_hashes(runs, "sha256")
    emit({"phase": "quant_ab", "card": smi, "order": order, "trees": trees, "median": med,
          "speedup_other_over_this": {k: med["other"][k] / med["this"][k] for k in med["this"]
                                      if med["this"][k]},
          "bound_ms": bounds,
          "share_of_bound": {side: {k: b / med[side][k] for k, b in bounds.items()}
                             for side in med},
          "outputs_equal_bits": same, "sha256": hashes})
    if not same:
        raise AssertionError("K9's, the dynamic GEMM's, K8's or row 12's outputs differ "
                             "between the two checkouts")


def row12_trace() -> None:
    """``--row12-trace``: row 12 at ``ATTN_SHAPE`` (causal, bf16; int8 P and
    ``qk_only``): five calls of its pre-pass kernel and of its main kernel
    under ``torch.profiler``, each device kernel's time a call (the
    pre-pass's column and row passes apart). Prints one JSON line."""
    from torch.profiler import ProfilerActivity, profile

    from qgemm_tpu_torch.ops.cuda.int8_flash_attention import (int8_flash_attention_cuda,
                                                               int8_flash_prepass_cuda)
    smi = phase_device()
    phase_build()
    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    b, h, s_, d = ATTN_SHAPE
    q, k, v = (torch.randn((b, h, s_, d), generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    spans = {}
    for qk_only in (False, True):
        codes = int8_flash_prepass_cuda(q, k, v, qk_only)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                int8_flash_prepass_cuda(q, k, v, qk_only)
                int8_flash_attention_cuda(codes, True, 1.0 / math.sqrt(d), torch.bfloat16)
            torch.cuda.synchronize()
        spans["qk_only" if qk_only else "int8_p"] = {
            e.key[:60]: e.device_time_total / 5e3 for e in prof.key_averages()
            if e.device_time_total > 0}
    emit({"phase": "row12_trace", "card": smi, "shape": list(ATTN_SHAPE),
          "kernel_ms_a_call": spans})


# Faults that ``--quant-faults`` plants, each in its own copy of the
# checkout's package: (source, its line, the faulty line, the phases whose
# checks must fail, what the failure must name)
QUANT_FAULTS = {
    "k9_without_cluster_merge": (
        "col_quantize.cu", "    for (int p = 0; p < cs; ++p)\n",
        "    for (int p = rank; p == rank; ++p)\n",
        {"k9": "not bit-equal", "gemm_protocol": "gemm_protocol:"}),
    "prepass_mean_over_s_minus_1": (
        "int8_flash_attention.cu",
        "        mean[tid] = __fdiv_rn(s, static_cast<float>(sk));\n",
        "        mean[tid] = __fdiv_rn(s, static_cast<float>(sk - 1));\n",
        {"ops_layer": "int8_flash_prepass check failed"}),
    "flash_without_alpha_rescale": (
        "int8_flash_attention.cu",
        "        oi = __fadd_rn(__fmul_rn(oi, (i & 2) ? al1 : al0), pv_f32(pacc[i]));\n",
        "        oi = __fadd_rn(oi, pv_f32(pacc[i]));\n",
        {"ops_layer": "plain_at_kernel_key_tile"}),
}


def quant_faults(tree: Optional[str] = None) -> None:
    """``--quant-faults``: with the kernels of checkout ``tree`` (default
    this one), in a copy of its package beside this script, the phases
    ``k9``, ``gemm_protocol`` and ``ops_layer`` (one process each), which
    must pass; then, for each of ``QUANT_FAULTS`` planted in another such
    copy (the sound copy's libraries copied as built), the phases the fault
    must fail, each of which must exit nonzero with a failure naming its
    check. Prints every run's readings: the K9 and pre-pass checks' lines,
    and each failure's message. Fails if the sound tree fails a phase or a
    fault passes one, or fails another check than its own."""
    phase_device()
    here = Path(__file__).resolve()
    src = Path(tree).resolve() if tree else here.parent
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        def run(name: str, script: Path, phase: str) -> dict:
            proc = subprocess.run([sys.executable, str(script), "--only", phase],
                                  capture_output=True, text=True, timeout=900, check=False)
            lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
            readings = [x for x in lines if x.get("phase") in (
                "int8_flash_prepass_check", "k9_nonfinite", "gemm_protocol")]
            for x in lines:
                if x.get("phase") == "ops_layer":
                    readings.append({"phase": "ops_layer_tight_checks", "max_abs_err": [
                        c["max_abs_err"] for c in x["checks"]
                        if c.get("against") == "plain_at_kernel_key_tile"]})
                if x.get("phase") == "k9":
                    readings.append({"phase": "k9", "max_abs_err": max(
                        c["max_abs_err"] for c in x["checks"])})
            tail = [x for x in proc.stderr.strip().splitlines() if x.startswith("AssertionError")]
            row = {"exit": proc.returncode, "error": tail[-1][:600] if tail else "",
                   "readings": readings}
            emit({"phase": "quant_fault_run", "fault": name, "checks": phase, **row})
            if proc.returncode != 0 and not tail:
                print(proc.stdout[-2000:], proc.stderr[-6000:], file=sys.stderr)
            return row

        script = package_copy(tmp, src, "sound")
        results["sound"] = {ph: run("sound", script, ph)
                            for ph in ("k9", "gemm_protocol", "ops_layer")}
        for name, (source, old, new, phases) in QUANT_FAULTS.items():
            script = package_copy(tmp, src, name, (f"csrc/{source}", old, new))
            results[name] = {ph: run(name, script, ph) for ph in phases}
    bad = [f"sound {ph} exited {r['exit']}: {r['error']}"
           for ph, r in results["sound"].items() if r["exit"] != 0]
    for name, (_, _, _, phases) in QUANT_FAULTS.items():
        for ph, want in phases.items():
            r = results[name][ph]
            if r["exit"] == 0 or want not in r["error"]:
                bad.append(f"{name} in {ph}: exit {r['exit']}, {r['error'][:200]!r}")
    emit({"phase": "quant_faults", "tree": str(src),
          "caught": {name: {ph: results[name][ph]["exit"] != 0 and want in
                            results[name][ph]["error"] for ph, want in phases.items()}
                     for name, (_, _, _, phases) in QUANT_FAULTS.items()},
          "sound_passed": all(r["exit"] == 0 for r in results["sound"].values())})
    if bad:
        raise AssertionError(f"quant faults: {bad}")


# ``--graph-ab``: each run's readings per engine, from ``profile_decode``
GRAPH_AB_KEYS = ("wall_ms_per_step_untraced", "kernel_ms_per_step",
                 "wall_ms_per_token_untraced", "kernel_ms_per_token", "idle_share_untraced",
                 "host_issued_ops_per_step", "device_events_per_step", "itl_p50_ms",
                 "itl_p95_ms", "tokens_per_s_untraced")


def graph_child(tree: str, route: str) -> None:
    """One run of ``--graph-ab``: with the qgemm_tpu_torch package and
    kernels of checkout ``tree``, the full-depth int8 GPT_6_7B's steady
    decode windows (``profile_decode`` with its host window) through the
    dense int8 and the paged int8 engines of ``graph_cases`` on one of
    ``GRAPH_ROUTES`` (an earlier checkout's engine decodes eagerly and
    takes only "eager"). Prints one JSON line."""
    root = use_tree(tree)
    from qgemm_tpu_torch.models.gpt import GPT, GPT_6_7B
    from qgemm_tpu_torch.ops.cuda import _build
    _build.build()
    model = GPT.init_quantized(GPT_6_7B, seed=0, device="cuda")
    res = {"tree": str(root), "route": route}
    for label, (kw, _, _) in graph_cases(GPT_6_7B).items():
        engine = graph_engine(model, route, kw)
        prof = profile_decode(engine, np.random.default_rng(8), host_window=True)
        res[label] = {**{k: prof[k] for k in GRAPH_AB_KEYS},
                      "family_ms_per_step": prof["family_ms_per_step"],
                      "host_issued_by_name_per_step": prof["host_issued_by_name_per_step"]}
        del engine
        torch.cuda.empty_cache()
    emit(res)


def graph_ab(other: str, rounds: int = 1) -> None:
    """``--graph-ab``: ``graph_child`` for checkout ``other`` (an earlier
    commit, unpacked by ``git archive``; eager) and this one's three routes,
    one process each, in turns (other, eager, graph, graph_ms4, then back,
    ``rounds`` times). Prints each run and the medians of each side's
    readings, with each route's ratio to the other checkout's."""
    here = Path(__file__).resolve()
    trees = {"other": Path(other).resolve(), "this": here.parent}
    sides = [("other", "eager"), ("this", "eager"), ("this", "graph"), ("this", "graph_ms4")]
    order = (sides + sides[::-1]) * rounds
    runs = {f"{t}_{r}": [] for t, r in sides}
    for tree, route in order:
        proc = subprocess.run([sys.executable, str(here), "--graph-child", str(trees[tree]),
                               route], capture_output=True, text=True, timeout=900,
                              check=False)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            raise AssertionError(f"--graph-child {tree} {route} exited {proc.returncode}")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[f"{tree}_{route}"].append(run)
        emit({"phase": "graph_run", "side": f"{tree}_{route}", **run})
    med = {side: {eng: {k: float(np.median([r[eng][k] for r in rs])) for k in GRAPH_AB_KEYS}
                  for eng in ("dense_int8", "paged_int8")} for side, rs in runs.items()}
    ratio = {side: {eng: {k: med[side][eng][k] / med["other_eager"][eng][k]
                          for k in GRAPH_AB_KEYS if med["other_eager"][eng][k]}
                    for eng in m} for side, m in med.items() if side != "other_eager"}
    emit({"phase": "graph_ab", "trees": {k: str(v) for k, v in trees.items()},
          "order": [f"{t}_{r}" for t, r in order], "runs_per_side": 2 * rounds,
          "median": med, "ratio_to_other_eager": ratio})


# ``--graph-transcripts``' model: a random-weight GPT whose greedy tokens
# depend on the token fed back at every step (the long copy model copies by
# position and does not see a stale token), at the kernels' head width 128
GRAPH_CHECK_MODEL = dict(vocab_size=512, d_model=256, n_heads=2, d_ff=1024, n_layers=2,
                         max_seq_len=512)
GRAPH_CHECK_ENGINES = {"dense_int8": dict(quantized_cache=True),
                       "paged_int8_page128": dict(paged=True, page_size=128)}


def graph_transcripts() -> dict:
    """``--graph-transcripts``: ``GRAPH_CHECK_MODEL`` with random weights
    (seed 0), int8, serving 16 random prompts of 32-120 tokens (one chunk,
    prefilled whole) for 48 new tokens through each of
    ``GRAPH_CHECK_ENGINES`` by graph replay, one step and four a dispatch:
    how many transcripts equal ``generate``'s (int8 cache; K5 and K2 share
    their split body, so the paged ones must too). Judges nothing; prints
    one JSON line."""
    from qgemm_tpu_torch.models.gpt import GPT, GPTConfig
    from qgemm_tpu_torch.ops.cuda import _build
    from qgemm_tpu_torch.serving.engine import Request
    _build.build()
    model = GPT.init(GPTConfig(**GRAPH_CHECK_MODEL), seed=0, device="cuda").quantize()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, GRAPH_CHECK_MODEL["vocab_size"], size=int(n)).tolist()
               for n in rng.integers(32, 121, size=16)]
    want = [model.generate(torch.tensor([p], device="cuda"), 48,
                           quantized_cache=True)[0].tolist() for p in prompts]
    res = {"phase": "graph_transcripts", "model": GRAPH_CHECK_MODEL, "requests": len(prompts),
           "equal_to_generate": {}}
    for label, kw in GRAPH_CHECK_ENGINES.items():
        for route in ("graph", "graph_ms4"):
            engine = graph_engine(model, route, dict(max_slots=8, device="cuda", **kw))
            reqs = [Request(prompt=p, max_new_tokens=48) for p in prompts]
            drive(engine, reqs, f"graph_transcripts {label} {route}")
            res["equal_to_generate"][f"{label}_{route}"] = sum(
                r.generated == w for r, w in zip(reqs, want))
    emit(res)
    return res


# Faults that ``--graph-faults`` plants, each in its own copy of the package:
# (file under qgemm_tpu_torch/, the sound text, the faulty text, the checks
# that must catch it). The page tables go into a fresh tensor at every
# upload (the first kept alive, so the graph reads valid but stale pages);
# the decode step does not feed its tokens back (the long copy model copies
# by position, so only the transcripts can catch it); it does not advance
# the positions.
GRAPH_FAULTS = {
    "page_table_fresh_tensor": (
        "serving/engine.py",
        "        self._pt_dev.copy_(src, non_blocking=True)\n",
        "        self._pt_dev = torch.empty_like(self._pt_dev).copy_(src, non_blocking=True)\n"
        "        self._pt_kept = getattr(self, '_pt_kept', []) + [self._pt_dev]\n"
        "        for c in self.caches:\n"
        "            c.page_table = self._pt_dev\n", ("transcripts", "floor")),
    "tokens_not_fed_back": ("serving/engine.py",
                            "        self.cur_tokens.copy_(nxt[:, None])\n", "",
                            ("transcripts",)),
    "positions_not_advanced": ("serving/engine.py",
                               "        self.positions.add_(self._active_dev)\n", "",
                               ("transcripts", "floor")),
}


def graph_faults() -> None:
    """``--graph-faults``: ``--long-copy`` (which trains the long copy model
    once and saves it in a temporary directory) and ``--graph-transcripts``
    with this checkout's package, then with each of ``GRAPH_FAULTS`` planted
    in a copy of the package (the kernels copied as built), one process
    each. A fault fails the transcript check where an engine held to
    ``generate``'s transcripts (the long copy's int8 engines, every engine
    of ``--graph-transcripts``) gives another, and the floor where a long
    copy engine copies below its accuracy floor. Prints every reading
    beside its bound; fails if the sound run breaks a bound or a fault
    passes a check named for it."""
    phase_device()
    src = Path(__file__).resolve().parent
    copies, transcripts = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "long_copy.npz")

        def last_line(name: str, script: Path, *args: str) -> dict:
            proc = subprocess.run([sys.executable, str(script), *args], capture_output=True,
                                  text=True, timeout=1200, check=False)
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
                raise AssertionError(f"{args[0]} of {name} exited {proc.returncode}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            emit({"fault": name, **res})
            return res

        for name, fault in [("sound", None), *GRAPH_FAULTS.items()]:
            script = package_copy(tmp, src, name, fault and fault[:3])
            copies[name] = last_line(name, script, "--long-copy", ckpt)
            transcripts[name] = last_line(name, script, "--graph-transcripts")
    sound = copies.pop("sound")
    sound_tr = transcripts.pop("sound")
    floor = sound["training"]["heldout_acc"] - LONG_COPY_SLACK
    exact = [k for k, v in LONG_COPY_ENGINES.items() if v[2]]
    acc = lambda r: {k: v["copy_acc"] for k, v in r["engines"].items()}
    equal = lambda r: {k: r["engines"][k]["equal_to_generate"] for k in exact}
    caught = {name: {"transcripts": any(n < LONG_COPY_REQUESTS for n in equal(r).values())
                     or any(n < transcripts[name]["requests"]
                            for n in transcripts[name]["equal_to_generate"].values()),
                     "floor": any(a < floor for a in acc(r).values())}
              for name, r in copies.items()}
    emit({"phase": "graph_faults", "floor": floor, "requests": LONG_COPY_REQUESTS,
          "sound": {"copy_acc": acc(sound), "equal_to_generate": equal(sound),
                    "random_model_equal_to_generate": sound_tr["equal_to_generate"]},
          "faults": {name: {"copy_acc": acc(r), "equal_to_generate": equal(r),
                            "random_model_equal_to_generate":
                                transcripts[name]["equal_to_generate"],
                            "must_catch": list(GRAPH_FAULTS[name][3])}
                     for name, r in copies.items()},
          "caught": caught})
    bad = long_copy_failures(sound)
    bad += [f"sound --graph-transcripts: {k} {n} of {sound_tr['requests']}"
            for k, n in sound_tr["equal_to_generate"].items() if n != sound_tr["requests"]]
    bad += [f"{name} passed the {check} check" for name, c in caught.items()
            for check in GRAPH_FAULTS[name][3] if not c[check]]
    if bad:
        raise AssertionError(f"graph faults: {bad}")


# ``--spec-tv``'s model: a random-weight GPT with 8 tokens (so that a few
# thousand draws pin each slot's distribution), head width 32; its draft
# another such model, far from it
SPEC_TV_MODEL = dict(vocab_size=8, d_model=64, n_heads=2, d_ff=128, n_layers=2,
                     max_seq_len=32)
SPEC_TV_ROUNDS = 4096
# per-slot knobs: temperature, top-k, top-p
SPEC_TV_KNOBS = ((1.0, 0, 1.0), (0.7, 0, 0.9), (1.3, 3, 1.0), (1.0, 0, 0.8))
# 4,096 draws over 8 tokens: the expected total variation is about 0.016
SPEC_TV_BOUND = 0.05


def spec_tv() -> dict:
    """``--spec-tv``: the sampled speculative round on the card against the
    target's warped distribution (the port of tests/test_gpt_serving.py's
    ``test_engine_spec_round_matches_target_distribution``): a 4-slot
    engine over ``SPEC_TV_MODEL`` (seed 21) with a draft of seed 22, gamma 3,
    every slot at one state (prompt [1, 2, 3], token 4 at position 3) with
    its own knobs (``SPEC_TV_KNOBS``), replays its "spec_sampled" graph
    ``SPEC_TV_ROUNDS`` times from that state; each slot's first token of
    each round is one draw. Per slot: the total variation between the
    draws and the target's analytic distribution (``warped_probs`` of its
    logits there) and between the draft's and the target's. One JSON
    line; ``ok`` when every slot is within ``SPEC_TV_BOUND`` and under half
    its draft's distance, with the draft at least 0.2 away (so that the
    check can tell)."""
    from qgemm_tpu_torch.models.gpt import GPT, GPTConfig
    from qgemm_tpu_torch.ops.cuda import _build
    from qgemm_tpu_torch.ops.sampling import warped_probs
    from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine
    _build.build()
    cfg = GPTConfig(**SPEC_TV_MODEL)
    target = GPT.init(cfg, seed=21, device="cuda")
    draft = GPT.init(cfg, seed=22, device="cuda")
    eng = ContinuousBatchingEngine(target, max_slots=4, max_seq_len=16, device="cuda",
                                   draft_model=draft, spec_gamma=3, seed=9)
    prompt = torch.tensor([[1, 2, 3]], device="cuda")
    for s in range(4):
        eng._prefill_impl(prompt, 3, s, 0.0, 1.0, 0)
        eng._draft_prefill_impl(prompt, s)
    temps, topks, topps = (torch.tensor(k, device="cuda") for k in zip(*SPEC_TV_KNOBS))
    eng._temps_dev.copy_(temps)
    eng._topks_dev.copy_(topks)
    eng._topps_dev.copy_(topps)
    eng._active_dev.fill_(1)
    first = []
    for _ in range(SPEC_TV_ROUNDS):
        eng.positions.fill_(3)
        eng.cur_tokens.fill_(4)
        eng._ring_idx.zero_()
        eng._graphs.run("spec_sampled", 1)
        first.append(eng._spec_ring[0, :, 0].clone())
    draws = torch.stack(first).to(torch.int64).cpu()

    def dist(m) -> torch.Tensor:
        cache = m.init_cache(1, 16)
        m.prefill(prompt, cache)
        lg, _ = m.decode_step(torch.tensor([[4]], device="cuda"), 3, cache)
        return torch.cat([warped_probs(lg, t, k, p) for t, k, p in SPEC_TV_KNOBS]).cpu()

    p, q = dist(target), dist(draft)
    emp = torch.stack([torch.bincount(draws[:, s], minlength=8) for s in range(4)]) \
        / SPEC_TV_ROUNDS
    tv = (0.5 * (emp - p).abs().sum(-1)).tolist()
    tv_draft = (0.5 * (q - p).abs().sum(-1)).tolist()
    ok = all(t < SPEC_TV_BOUND and t < 0.5 * d and d > 0.2 for t, d in zip(tv, tv_draft))
    res = {"phase": "spec_tv", "rounds": SPEC_TV_ROUNDS, "bound": SPEC_TV_BOUND,
           "knobs": SPEC_TV_KNOBS, "tv": tv, "tv_draft": tv_draft, "ok": ok,
           "graph": {"captures": eng._graphs.captures, "replays": eng._graphs.replays}}
    emit(res)
    return res


# Faults that ``--spec-faults`` plants, each in its own copy of the package:
# (file under qgemm_tpu_torch/, the sound text, the faulty text, the check
# that must catch it). The greedy acceptance takes one proposal past the
# first rejection (only the random draft's rounds reject); the target
# verifies its chunk one position late; the leftover distribution is the
# target's p, not max(0, p - q).
SPEC_FAULTS = {
    "accept_past_rejection": (
        "serving/engine.py",
        "    n_acc = torch.cumprod((d == g[:, :-1]).to(torch.int64), dim=1).sum(dim=1)\n",
        "    n_acc = (torch.cumprod((d == g[:, :-1]).to(torch.int64), dim=1).sum(dim=1)\n"
        "             + 1).clamp_max(d.shape[1])\n", "random_transcripts"),
    "verify_offset_plus_one": (
        "serving/engine.py",
        "        return self.model.prefill_chunk(seq, self.positions, self.caches)[0]\n",
        "        return self.model.prefill_chunk(seq, self.positions + 1, self.caches)[0]\n",
        "copy"),
    "leftover_p": ("serving/engine.py",
                   "    resid = torch.clamp_min(p_at - q_at, 0.0)\n", "    resid = p_at\n",
                   "tv"),
}


def spec_faults() -> None:
    """``--spec-faults``: ``--long-copy`` on the speculative engines (which
    trains the long copy model once and saves it in a temporary directory)
    and ``--spec-tv`` with this checkout's package, then with each of
    ``SPEC_FAULTS`` planted in a copy of the package (the kernels copied as
    built), one process each. The checks: ``random_transcripts`` fails where
    an int8 engine with the random draft gives other transcripts than
    ``generate``; ``copy`` where a speculative engine copies below its
    accuracy floor or an int8 one gives other transcripts; ``tv`` where
    ``--spec-tv`` is not ok. Prints every reading beside its bound; fails if
    the sound run fails a check or a fault passes the check named for it."""
    phase_device()
    src = Path(__file__).resolve().parent
    copies, tvs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "long_copy.npz")

        def last_line(name: str, script: Path, *args: str) -> dict:
            proc = subprocess.run([sys.executable, str(script), *args], capture_output=True,
                                  text=True, timeout=1200, check=False)
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
                raise AssertionError(f"{args[0]} of {name} exited {proc.returncode}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            emit({"fault": name, **res})
            return res

        for name, fault in [("sound", None), *SPEC_FAULTS.items()]:
            script = package_copy(tmp, src, name, fault and fault[:3])
            copies[name] = last_line(name, script, "--long-copy", ckpt, "_spec_")
            tvs[name] = last_line(name, script, "--spec-tv")
    floor = copies["sound"]["training"]["heldout_acc"] - LONG_COPY_SLACK
    exact = [k for k, v in LONG_COPY_ENGINES.items() if v[2] and "_spec_" in k]
    equal = lambda r: {k: r["engines"][k]["equal_to_generate"] for k in exact}
    acc = lambda r: {k: v["copy_acc"] for k, v in r["engines"].items()}
    caught = {name: {"random_transcripts": any(n < LONG_COPY_REQUESTS for k, n in
                                               equal(r).items() if "_random" in k),
                     "copy": any(a < floor for a in acc(r).values())
                     or any(n < LONG_COPY_REQUESTS for n in equal(r).values()),
                     "tv": not tvs[name]["ok"]}
              for name, r in copies.items()}
    emit({"phase": "spec_faults", "floor": floor, "requests": LONG_COPY_REQUESTS,
          "tv_bound": SPEC_TV_BOUND,
          "runs": {name: {"copy_acc": acc(r), "equal_to_generate": equal(r),
                          "acceptance": {k: v.get("spec_acceptance")
                                         for k, v in r["engines"].items()},
                          "tv": tvs[name]["tv"], "tv_draft": tvs[name]["tv_draft"],
                          "must_catch": SPEC_FAULTS[name][3] if name in SPEC_FAULTS else None}
                   for name, r in copies.items()},
          "caught": caught})
    bad = long_copy_failures(copies["sound"])
    bad += [f"sound run: {check} failed" for check, hit in caught["sound"].items() if hit]
    bad += [f"{name} passed the {fault[3]} check" for name, fault in SPEC_FAULTS.items()
            if not caught[name][fault[3]]]
    if bad:
        raise AssertionError(f"spec faults: {bad}")


# ------------------------------------------------------ encoder-decoder (A.8)
# S2S_1_5B (scripts/bench_seq2seq.py's defaults: 12 + 12 layers, d_model 2048)
# served in int8 by Seq2SeqEngine: 8 slots, sources of 16-64 tokens,
# decoder budget 128; 16 requests of 32-128 new tokens. The phase runs it at
# full width and ``S2S_LAYERS`` + ``S2S_LAYERS`` layers (the whole script's
# time limit); its launch counts follow the layers.
S2S_LAYERS = 6
S2S_SLOTS = 8
S2S_MAX_SRC = 64
S2S_MAX_NEW = 128
S2S_REQUESTS = 16
# the engines of the served phase: options, routes (eager: the private
# ``_graphs = None``; graph; graph_ms4: graph with multi_step=4; every route
# held to the first), the draft. The int4 pools run K5 as the int8 ones do,
# and the paged round runs the dense round's body with K6 for its verify,
# so those two serve the requests on the graph route alone, and hold their
# eager route to it on the short list (the eager step is ~10x slower)
S2S_ENGINES = {
    "dense_int8": (dict(quantized_cache=True), ("eager", "graph", "graph_ms4"), False),
    "paged_int8": (dict(quantized_cache=True, paged=True, page_size=128), ("eager", "graph"),
                   False),
    "paged_int4": (dict(quantized_cache=True, paged=True, page_size=32, kv_bits=4),
                   ("graph",), False),
    "spec_dense_int8": (dict(quantized_cache=True), ("eager", "graph"), True),
    "spec_paged_int8": (dict(quantized_cache=True, paged=True, page_size=128), ("graph",),
                        True),
}
# the short list: the first 8 requests, at most 24 new tokens each; every
# engine's sampled routes, and the greedy ones of those served on the
# graph route alone, are held equal on it
S2S_SHORT_REQUESTS = 8
S2S_SHORT_NEW = 24
S2S_BEAM = dict(beam_size=4, sources=2, new_tokens=32)


def s2s_requests(vocab: int, rng) -> list:
    """The served phase's requests as (source, max_new_tokens)."""
    plens = rng.integers(16, S2S_MAX_SRC + 1, size=S2S_REQUESTS)
    news = rng.integers(32, S2S_MAX_NEW + 1, size=S2S_REQUESTS)
    return [(rng.integers(3, vocab, size=int(p)).tolist(), int(n)) for p, n in zip(plens, news)]


def s2s_engine(model, route: str, kw: dict, draft=None):
    """A Seq2SeqEngine with options ``kw`` on ``route``; with ``draft`` a
    speculative one (gamma ``SPEC_GAMMA``)."""
    from qgemm_tpu_torch.serving.seq2seq import Seq2SeqEngine
    opts = dict(max_slots=S2S_SLOTS, max_src_len=S2S_MAX_SRC, max_new_tokens=S2S_MAX_NEW,
                device="cuda", **kw)
    if draft is not None:
        opts.update(draft_model=draft, spec_gamma=SPEC_GAMMA)
    if route.endswith("ms4"):
        opts["multi_step"] = 4
    engine = Seq2SeqEngine(model, **opts)
    if route == "eager":
        engine._graphs = None
    return engine


def s2s_launches_expected(n_layers: int, paged: bool, spec: bool) -> dict:
    """Launches per decode step (``spec`` False) or per speculative round.
    A step: K1 on the decoder's 8 GEMMs a layer (self q, k, v, o; cross q,
    o; up, down) and the head, K2 (dense int8 self-cache) or K5 (paged) once
    a layer, no K3 (the cross read is the plain composition). A round: the
    W4A8 draft's gamma + 1 steps on K4 (its caches float: no attention
    kernel), the verify chunk's GEMMs on K1 and, paged, its attention on
    K6."""
    n_gemms = 8 * n_layers + 1
    if spec:
        return {"w4a8_matmul": (SPEC_GAMMA + 1) * n_gemms, "quantized_matmul": n_gemms,
                "paged_context_attention": n_layers if paged else 0, "decode_attention": 0,
                "paged_decode_attention": 0, "paged_decode_attention_ragged": 0,
                "flash_attention": 0}
    return {"quantized_matmul": n_gemms, "decode_attention": 0 if paged else n_layers,
            "paged_decode_attention": 0, "paged_decode_attention_ragged": n_layers if paged else 0,
            "paged_context_attention": 0, "flash_attention": 0, "w4a8_matmul": 0}


def s2s_admission_launches(n_layers: int, spec: bool) -> dict:
    """What one admission launches: the encoder's 6 GEMMs a layer, the
    cross K/V projections' 2 a layer and the BOS step's 8 a layer + head
    on K1 (the W4A8 draft's the same on K4), and K3 three times a layer a
    model: the encoder's self-attention, the BOS step's self-attention
    (position 0 of a one-position cache: the prefill branch, Sq = Sk = 1)
    and its cross read (unmasked, Sq 1)."""
    per_model = 16 * n_layers + 1
    return {"quantized_matmul": per_model, "w4a8_matmul": per_model if spec else 0,
            "flash_attention": 3 * n_layers * (2 if spec else 1), "decode_attention": 0,
            "paged_decode_attention_ragged": 0}


def s2s_step_bytes(model) -> int:
    """The bytes a decode step must read at least: the int8 codes and scales
    of the decoder's GEMMs that run in a step and of the head (not the
    encoder's, nor the cross K/V projections, which run at admission)."""
    mods = [model.lm_head]
    for blk in model.dec_blocks:
        mods += [getattr(blk.self_attn, n) for n in ("wqkv_q", "wqkv_k", "wqkv_v", "w_o")]
        mods += [blk.cross_attn.wqkv_q, blk.cross_attn.w_o, blk.ffn.up, blk.ffn.down]
    return sum(b.numel() * b.element_size() for m in mods for b in (m.qt, m.c))


def s2s_source(rng, vocab: int) -> list:
    """A steady window's source: 48 random tokens past BOS and EOS."""
    return rng.integers(3, vocab, size=48).tolist()


def s2s_cross_read_ms(model, engine_kw: dict) -> dict:
    """The cross read alone at a decode step's shapes (8 slots, one query
    row, 16 heads of 128 over ``S2S_MAX_SRC`` positions, sources of 48
    masked in): the int8 read (``_quantized_cross_attention``, bf16
    products) and the float one (the draft's: the masked bf16
    composition), timed by ``bench_ms``; times the layers give a step's
    share."""
    from qgemm_tpu_torch.models.attention import (_quantized_cross_attention,
                                                  scaled_dot_product_attention)
    from qgemm_tpu_torch.ops.kv_cache import quantize_kv
    from qgemm_tpu_torch.utils.profiling import bench_ms
    cfg = model.cfg
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    dh = cfg.d_model // cfg.n_heads
    shape = (S2S_SLOTS, cfg.n_heads, S2S_MAX_SRC, dh)
    q = torch.randn((S2S_SLOTS, cfg.n_heads, 1, dh), generator=g, device="cuda").bfloat16()
    k = torch.randn(shape, generator=g, device="cuda").bfloat16()
    v = torch.randn(shape, generator=g, device="cuda").bfloat16()
    mask = torch.arange(S2S_MAX_SRC, device="cuda")[None, :] < 48
    mask = mask.expand(S2S_SLOTS, -1)
    kq, kc = quantize_kv(k)
    vq, vc = quantize_kv(v)
    int8_ms = bench_ms(lambda: _quantized_cross_attention(q, kq, kc, vq, vc, mask=mask))
    float_ms = bench_ms(lambda: scaled_dot_product_attention(q, k, v,
                                                             mask=mask[:, None, None, :]))
    b_int8 = sum(t.numel() * t.element_size() for t in (q, kq, kc, vq, vc)) + q.numel() * 2
    return {"int8_ms": int8_ms, "float_ms": float_ms, "layers": cfg.n_layers,
            "int8_ms_per_step": int8_ms * cfg.n_layers,
            "int8_bound_ms": bound(b_int8, 4 * q.numel() * S2S_MAX_SRC, BF16_FLOPS)[0],
            "shape": {"slots": S2S_SLOTS, "heads": cfg.n_heads, "head_dim": dh,
                      "positions": S2S_MAX_SRC, "source": 48}}


def phase_seq2seq() -> dict:
    """The encoder-decoder family on the main path at full width: S2S_1_5B
    at ``S2S_LAYERS`` + ``S2S_LAYERS`` layers (int8 weights,
    ``Transformer.init_quantized`` seed 0, and its W4A8
    self-draft from the same float weights) serving the
    ``S2S_REQUESTS`` greedy requests of ``s2s_requests`` through every
    engine of ``S2S_ENGINES`` on each of its routes. Fails unless every
    route's transcripts equal the first route's bit for bit (an engine
    served on the graph route alone: its eager and graph routes on the
    short list), every decode step (round) launches what
    ``s2s_launches_expected`` says and every admission what
    ``s2s_admission_launches`` says (a speculative engine's: the target's
    and the draft's), and 8 sampled requests draw the same tokens on the
    eager and graph routes of every engine (the dense ones on the full
    list, the others on the short one). Reports each engine's steady
    window (``profile_decode`` or ``profile_spec`` on 48-token sources)
    against the step's byte bound, the cross read's share of a step, and a
    beam search (``S2S_BEAM``), whose beam 1 must equal ``generate``, and
    runs ``examples/transformer_demo.py`` (``s2s_demo``)."""
    from qgemm_tpu_torch.models.transformer import S2S_1_5B, Transformer
    from qgemm_tpu_torch.serving.engine import Request
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(S2S_1_5B, n_layers=S2S_LAYERS)
    model = Transformer.init_quantized(cfg, seed=0, device="cuda")
    draft = Transformer.init_quantized(cfg, seed=0, device="cuda", bits=4)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reqs_spec = s2s_requests(cfg.vocab_size, np.random.default_rng(15))
    make = lambda: [Request(prompt=p, max_new_tokens=n) for p, n in reqs_spec]
    make_short = lambda: [Request(prompt=p, max_new_tokens=min(n, S2S_SHORT_NEW))
                          for p, n in reqs_spec[:S2S_SHORT_REQUESTS]]
    n_layers = cfg.n_layers
    step_bytes = s2s_step_bytes(model)
    res = {"phase": "seq2seq", "model": f"S2S_1_5B at {n_layers} + {n_layers} layers, int8 "
                                        "(seed 0), W4A8 self-draft",
           "params": model.num_params(), "init_s": init_s, "requests": len(reqs_spec),
           "step_bytes": step_bytes, "step_bound_ms": bound(step_bytes, 0, INT8_OPS)[0],
           "engines": {}}
    for label, (kw, routes, spec) in S2S_ENGINES.items():
        paged = kw.get("paged", False)
        want = s2s_launches_expected(n_layers, paged, spec)
        want_adm = s2s_admission_launches(n_layers, spec)
        unit = "round" if spec else "step"
        d = draft if spec else None
        t_eng = time.perf_counter()

        def serve_route(route: str, reqs: list, tag: str) -> dict:
            engine = s2s_engine(model, route, kw, d)
            run = drive(engine, reqs, f"seq2seq {label} {tag}")
            per = run["per_round"] if spec else run["per_decode"]
            if per is None or any(per.get(k, 0) != v for k, v in want.items()):
                raise AssertionError(f"seq2seq {label} {tag}: launches per {unit} {per}, "
                                     f"expected {want}")
            if not run["admit_only"]:
                raise AssertionError(f"seq2seq {label} {tag}: no admission step read")
            for n_adm, adm in run["admit_only"]:
                got = {k: adm.get(k, 0) for k in want_adm}
                if any(got[k] != n_adm * v for k, v in want_adm.items()):
                    raise AssertionError(f"seq2seq {label} {tag}: {n_adm} admissions "
                                         f"launched {got}, expected {want_adm} each")
            out = {"transcripts": [r.generated for r in reqs], "stats": engine.stats,
                   "graph": run["graph"], "per": per,
                   "ms_mean_in_run": float(np.mean(run["round_ms"] if spec
                                                   else run["step_ms"]))}
            if tag == "graph":
                rng = np.random.default_rng(8)
                out["profile"] = (profile_spec(engine, rng, n_steps=4, prompt=s2s_source)
                                  if spec else profile_decode(engine, rng, prompt=s2s_source))
            return out

        runs = {route: serve_route(route, make(), route) for route in routes}
        for route in routes[1:]:
            if runs[route]["transcripts"] != runs[routes[0]]["transcripts"]:
                raise AssertionError(f"seq2seq {label}: {route}'s transcripts are not the "
                                     f"{routes[0]} route's")
        entry = {"launches_per_" + unit: {k: v for k, v in runs["graph"]["per"].items() if v},
                 "launches_per_admission": want_adm,
                 "routes_equal": list(routes), "profile": runs["graph"]["profile"],
                 "ms_mean_in_run": {r: runs[r]["ms_mean_in_run"] for r in routes},
                 "stats": {r: {k: v for k, v in runs[r]["stats"].items()
                               if k in ("tokens_per_s", "steps", "decode_steps", "spec_rounds",
                                        "spec_acceptance", "itl_p50_ms", "admit_p50_ms",
                                        "pages_total", "decode_graph_captures",
                                        "decode_graph_replays")} for r in routes}}
        if "eager" not in routes:
            short = {route: serve_route(route, make_short(), f"{route} short")
                     for route in ("eager", "graph")}
            if short["eager"]["transcripts"] != short["graph"]["transcripts"]:
                raise AssertionError(f"seq2seq {label}: the eager route's transcripts of the "
                                     "short list are not the graph route's")
            entry["short_routes_equal"] = ["eager", "graph"]
            entry["ms_mean_in_run"]["eager_short"] = short["eager"]["ms_mean_in_run"]
        full = label in ("dense_int8", "spec_dense_int8")
        entry["sampled"] = sampled_routes_equal(
            model, kw, make if full else make_short, f"seq2seq {label}",
            routes=("eager", "graph"),
            make_engine=lambda m, route, k: s2s_engine(m, route, k, d))
        entry["sampled"]["list"] = "full" if full else "short"
        entry["seconds"] = time.perf_counter() - t_eng
        res["engines"][label] = entry
        torch.cuda.empty_cache()
    res["cross_read"] = s2s_cross_read_ms(model, S2S_ENGINES["dense_int8"][0])
    step = res["engines"]["dense_int8"]["profile"]["kernel_ms_per_step"]
    res["cross_read"]["share_of_dense_step_device_ms"] = \
        res["cross_read"]["int8_ms_per_step"] / step
    res["beam"] = s2s_beam(model)
    del model, draft
    torch.cuda.empty_cache()
    res["demo"] = s2s_demo()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    return res


def s2s_demo() -> dict:
    """``examples/transformer_demo.py`` on the card: the reference preset
    (d_model 8, head_dim 2), int8, with ``--bench`` (the served engines
    above cover S2S_1_5B's widths)."""
    from qgemm_tpu_torch.examples import transformer_demo
    out = {}
    for preset in ("reference",):
        r = transformer_demo.main(["--preset", preset, "--quantized", "--bench",
                                   "--new-tokens", "32"])
        if len(r["tokens"]) != 2 or any(len(t) != 32 for t in r["tokens"]):
            raise AssertionError(f"transformer_demo {preset}: {r['tokens']}")
        out[preset] = {k: v for k, v in r.items() if k != "tokens"}
    return out


def s2s_beam(model) -> dict:
    """``beam_search`` at ``S2S_BEAM`` on the int8 S2S_1_5B with the int8
    self-cache (wall time, finite scores), and its beam 1 against
    ``generate`` on the same source (equal token for token)."""
    from qgemm_tpu_torch.ops import cuda as kernels
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    n, k = S2S_BEAM["new_tokens"], S2S_BEAM["beam_size"]
    src = torch.randint(3, model.cfg.vocab_size, (S2S_BEAM["sources"], 40), generator=g,
                        device="cuda")
    model.beam_search(src, 4, beam_size=k, quantized_cache=True)     # warm
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    toks, scores = model.beam_search(src, n, beam_size=k, quantized_cache=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = kernels.launch_counts()
    if toks.shape != (src.shape[0], n) or not bool(torch.isfinite(scores).all()):
        raise AssertionError(f"beam search: tokens {tuple(toks.shape)}, scores {scores}")
    b1, _ = model.beam_search(src[:1], 16, beam_size=1, quantized_cache=True)
    greedy = model.generate(src[:1], 16, quantized_cache=True)
    if b1.tolist() != greedy.tolist():
        raise AssertionError(f"beam search: beam 1 {b1.tolist()} != generate "
                             f"{greedy.tolist()}")
    return {"beam_size": k, "sources": src.shape[0], "new_tokens": n, "wall_s": wall,
            "ms_per_step": wall * 1e3 / n, "tokens_per_s": src.shape[0] * n / wall,
            "scores": scores.tolist(), "beam1_equals_generate": True,
            "launches": {kk: v for kk, v in counts.items() if v}}


# The trained check of the encoder-decoder engines: a reverse model
# (target = the source reversed, then EOS; the decoder sees the source only
# through cross-attention), trained on the card on sources of 1-31 tokens,
# one length a batch, and held to its teacher-forced accuracy over 8-31.
# Its token embeddings start REV_EMBED_SCALE times the init's (std 1/sqrt(d)
# beside sinusoidal positions of magnitude 1): at the init's scale neither
# package's model left the loss plateau of a copy or a reversal within
# 3,000 steps on the CPU; scaled, a CPU run of this recipe reached 0.99 at
# length 24 by step 1,700.
REV_MODEL = dict(vocab_size=64, d_model=128, n_heads=4, d_ff=512, n_layers=2,
                 max_seq_len=64)
REV_BOS, REV_EOS = 1, 2
REV_TRAIN_LENGTHS = (1, 31)
REV_LENGTHS = (8, 31)
REV_EMBED_SCALE = 8.0
REV_STEPS = (2000, 4000)          # attempts, until one reaches REV_MIN_ACC
REV_BATCH = 64
REV_LR = 1.5e-3
REV_MIN_ACC = 0.95
REV_SLACK = 0.05
# three waves of 8 requests, longest first: each wave's slots held a
# longer source before, whose rows past the new source stay in the cross
# K/V and are read unless the step masks them
REV_WAVES = ((26, 31), (16, 22), (8, 13))
# the engines that serve the trained model (int8 weights, int8 cross K/V):
# (options, whether the transcripts must equal ``generate``'s with the int8
# self-cache, the draft)
REV_ENGINES = {
    "dense_int8": (dict(quantized_cache=True), True, None),
    "dense_int8_ms4": (dict(quantized_cache=True, multi_step=4), True, None),
    "paged_int8": (dict(quantized_cache=True, paged=True, page_size=16), True, None),
    "paged_int4": (dict(quantized_cache=True, paged=True, page_size=16, kv_bits=4), False,
                   None),
    "spec_dense_int8": (dict(quantized_cache=True), True, "w4a8"),
    "spec_paged_int8": (dict(quantized_cache=True, paged=True, page_size=16), True, "w4a8"),
    "spec_paged_int4": (dict(quantized_cache=True, paged=True, page_size=16, kv_bits=4),
                        False, "w4a8"),
}


def rev_batch(g: torch.Generator, batch: int, length: int) -> tuple:
    """(source [B, L], decoder input [B, L+1] = BOS + reversed source,
    target [B, L+1] = reversed source + EOS) on the generator's device."""
    src = torch.randint(3, REV_MODEL["vocab_size"], (batch, length), generator=g,
                        device=g.device)
    rev = src.flip(1)
    col = lambda t: torch.full((batch, 1), t, dtype=src.dtype, device=src.device)
    return src, torch.cat([col(REV_BOS), rev], 1), torch.cat([rev, col(REV_EOS)], 1)


def rev_teacher_forced(model, n: int = 16, seed: int = 7) -> float:
    """Teacher-forced top-1 accuracy over every target token, at each
    source length in ``REV_LENGTHS``, n sources each."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    hit = total = 0
    with torch.no_grad():
        for length in range(REV_LENGTHS[0], REV_LENGTHS[1] + 1):
            src, tin, tout = rev_batch(g, n, length)
            pred = model(src, tin).argmax(dim=-1)
            hit += int((pred == tout).sum())
            total += tout.numel()
    return hit / total


def rev_train(steps: int) -> tuple:
    """Train the reverse model on the port's training path (K3 forward and
    K7 backward, the analytic cross-entropy, Adam at ``REV_LR``, falling
    over the last 30 % of the steps), one source length of
    ``REV_TRAIN_LENGTHS`` a batch. Returns (model, losses, seconds and
    launches per step)."""
    from qgemm_tpu_torch.models.optim import Adam
    from qgemm_tpu_torch.models.transformer import Transformer, TransformerConfig
    from qgemm_tpu_torch.ops.cross_entropy import cross_entropy_loss
    from qgemm_tpu_torch.ops import cuda as kernels
    cfg = TransformerConfig(**REV_MODEL)
    model = Transformer.init(cfg, seed=0, device="cuda")
    with torch.no_grad():
        model.embed.table.mul_(REV_EMBED_SCALE)
    params = [p for p in model.parameters() if p.requires_grad]
    opt = Adam(lr=REV_LR)
    state = opt.init(params)
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    lengths = np.random.default_rng(2).integers(REV_TRAIN_LENGTHS[0], REV_TRAIN_LENGTHS[1] + 1,
                                                size=steps)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    losses = []
    for i in range(steps):
        # the rate falls linearly over the last 30 % of the steps to a tenth
        opt.lr = REV_LR * min(1.0, 0.1 + 0.9 * (steps - i) / (0.3 * steps))
        src, tin, tout = rev_batch(g, REV_BATCH, int(lengths[i]))
        for p in params:
            p.grad = None
        logits = model(src, tin)
        loss = cross_entropy_loss(logits.reshape(-1, cfg.vocab_size), tout.reshape(-1))
        loss.backward()
        state = opt.step(params, [p.grad for p in params], state)
        if i % (steps // 10) == 0 or i == steps - 1:
            losses.append(float(loss.detach()))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    return model, {"steps": steps, "losses": losses, "train_s": time.perf_counter() - t,
                   "launches_per_step": {k: v / steps for k, v in counts.items() if v}}


def rev_model(ckpt: Path) -> tuple:
    """The reverse model, reloaded from ``ckpt`` (a state dict, and the JSON
    beside it) if it exists, else trained (``REV_STEPS`` in turn, until one
    reaches ``REV_MIN_ACC``) and saved there. Returns (the float model,
    what was trained)."""
    from qgemm_tpu_torch.models.transformer import Transformer, TransformerConfig
    meta = ckpt.with_suffix(".json")
    if ckpt.exists():
        info = json.loads(meta.read_text())
        model = Transformer.init(TransformerConfig(**REV_MODEL), seed=0, device="cuda")
        model.load_state_dict(torch.load(ckpt, map_location="cuda"))
        info["teacher_forced_acc_reloaded"] = rev_teacher_forced(model)
        return model, info
    attempts = []
    for steps in REV_STEPS:
        model, st = rev_train(steps)
        st["teacher_forced_acc"] = rev_teacher_forced(model)
        attempts.append(st)
        if st["teacher_forced_acc"] >= REV_MIN_ACC:
            break
        del model
    else:
        raise AssertionError(f"reverse model: no attempt reached {REV_MIN_ACC} teacher-forced "
                             f"accuracy: {attempts}")
    info = {"attempts": attempts, "teacher_forced_acc": st["teacher_forced_acc"]}
    torch.save(model.state_dict(), ckpt)
    meta.write_text(json.dumps(info))
    return model, info


def rev_readings(ckpt: Path) -> dict:
    """The reverse model (``rev_model``) quantized to int8, serving the
    three ``REV_WAVES`` of 8 held-out sources each (max_new_tokens the
    source's length + 1, greedy) through every engine of ``REV_ENGINES``
    (the speculative ones with the model's W4A8 copy as draft), launch
    counts set to 0 just before each run and read just after. Per engine:
    the accuracy of the transcripts against the reversed sources + EOS,
    how many equal ``generate``'s (int8 self-cache), and the first that
    differs with both sides' margins. Judges nothing (``rev_failures``
    does)."""
    from qgemm_tpu_torch.serving.engine import Request
    from qgemm_tpu_torch.serving.seq2seq import Seq2SeqEngine
    t0 = time.perf_counter()
    model, info = rev_model(ckpt)
    qm = model.quantize()
    draft = model.quantize(bits=4)
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    rng = np.random.default_rng(12)
    srcs = [torch.randint(3, REV_MODEL["vocab_size"], (int(rng.integers(lo, hi + 1)),),
                          generator=g, device="cuda").tolist()
            for lo, hi in REV_WAVES for _ in range(8)]
    targets = [list(reversed(s)) + [REV_EOS] for s in srcs]
    gen = [qm.generate(torch.tensor([s], device="cuda"), len(s) + 1,
                       quantized_cache=True)[0].tolist() for s in srcs]
    acc = lambda outs: (sum(a == b for o, t in zip(outs, targets) for a, b in zip(o, t))
                        / sum(len(t) for t in targets))
    res = {"training": info, "requests": len(srcs), "waves": REV_WAVES,
           "generate_acc": acc(gen), "engines": {}}
    for label, (kw, exact, use_draft) in REV_ENGINES.items():
        engine = Seq2SeqEngine(qm, max_slots=8, max_src_len=REV_WAVES[0][1] + 1,
                               max_new_tokens=REV_WAVES[0][1] + 1, device="cuda",
                               draft_model=draft if use_draft else None,
                               spec_gamma=SPEC_GAMMA if use_draft else 4, **kw)
        reqs = [Request(prompt=s, max_new_tokens=len(s) + 1) for s in srcs]
        run = drive(engine, reqs, f"s2s_reverse {label}")
        stats = engine.stats
        del engine
        outs = [r.generated for r in reqs]
        diffs = [first_difference(a, b) for a, b in zip(gen, outs)]
        row = {"acc": acc(outs), "equal_to_generate": sum(d is None for d in diffs),
               "first_difference_steps": diffs, "first_difference": None,
               "launches": {k: v for k, v in run["counts"].items() if v}}
        if use_draft:
            row.update(spec_rounds=stats.get("spec_rounds", 0),
                       spec_acceptance=stats.get("spec_acceptance"))
        i = next((i for i, d in enumerate(diffs) if d is not None), None)
        if i is not None:
            row["first_difference"] = rev_margins(qm, srcs[i], diffs[i], gen[i], outs[i])
            row["first_difference"]["request"] = i
        res["engines"][label] = row
    del model, qm, draft
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    return res


def rev_margins(model, src: list, step: int, want: list, got: list) -> dict:
    """``generate``'s logits at ``step`` of ``want`` (its transcript): the
    margin of its token over the engine's there, and its top-2 gap."""
    enc_kvs = model.cross_kvs(model.encode(torch.tensor([src], device="cuda")))
    caches = model.init_cache(1, len(want), quantized=True)
    tok = torch.tensor([[REV_BOS]], device="cuda")
    for t in range(step + 1):
        logits, caches = model.decode_logits(tok, t, enc_kvs, caches)
        tok = torch.tensor([[want[t]]], device="cuda")
    lg = logits[0].float()
    top2 = torch.topk(lg, 2).values
    return {"step": step, "generate_token": want[step], "engine_token": got[step],
            "generate_margin": float(lg[want[step]] - lg[got[step]]),
            "generate_top2_gap": float(top2[0] - top2[1])}


def rev_failures(res: dict) -> list:
    """What of ``rev_readings``' result breaks its bounds: each engine's
    accuracy at least the teacher-forced accuracy less ``REV_SLACK``, the
    transcripts of the engines so marked equal to ``generate``'s, every
    speculative engine ran rounds."""
    floor = res["training"]["teacher_forced_acc"] - REV_SLACK
    bad = []
    for label, row in res["engines"].items():
        if row["acc"] < floor:
            bad.append(f"{label}: accuracy {row['acc']} < {floor}")
        if REV_ENGINES[label][1] and row["equal_to_generate"] != res["requests"]:
            bad.append(f"{label}: {row['equal_to_generate']} of {res['requests']} transcripts "
                       f"equal generate's ({row['first_difference']})")
        if "spec_rounds" in row and not row["spec_rounds"] > 0:
            bad.append(f"{label}: no speculative round")
    return bad


def phase_s2s_reverse() -> dict:
    """The trained reverse model (``rev_readings``, the model saved to a
    temporary directory); fails on any of ``rev_failures``."""
    with tempfile.TemporaryDirectory() as tmp:
        res = {"phase": "s2s_reverse", **rev_readings(Path(tmp) / "reverse.pt")}
    res["acc_floor"] = res["training"]["teacher_forced_acc"] - REV_SLACK
    emit(res)
    bad = rev_failures(res)
    per_step = res["training"]["attempts"][-1]["launches_per_step"]
    attn = 3 * REV_MODEL["n_layers"]
    if per_step.get("flash_attention") != attn or per_step.get("flash_attention_bwd") != attn:
        bad.append(f"training launched {per_step} a step, not K3 and K7 {attn} times each")
    if bad:
        raise AssertionError(f"s2s reverse: {bad}")
    return res


def s2s_reverse_child(ckpt: str) -> None:
    """``--s2s-reverse CKPT``: ``rev_readings`` of the model in CKPT (trained
    and saved there first if missing), one JSON line."""
    from qgemm_tpu_torch.ops.cuda import _build
    _build.build()
    emit({"phase": "s2s_reverse", **rev_readings(Path(ckpt))})


# Faults that ``--seq2seq-faults`` plants, each in its own copy of the
# package: (file under qgemm_tpu_torch/, the sound text, the faulty text).
# The decode step's cross read attends every position of the cross K/V,
# stale rows of an earlier, longer source included; admission writes a
# slot's cross K/V into the next slot's rows; the int8 cross read drops the
# K and V scales (reads codes / 127).
S2S_FAULTS = {
    "cross_read_ignores_src_lens": (
        "serving/seq2seq.py",
        "        return self._src_pos[None, :] < self.src_lens[:, None]\n",
        "        return (self._src_pos[None, :] >= 0).expand(self.max_slots, -1)\n"),
    "cross_kv_wrong_slot": (
        "serving/seq2seq.py",
        "                d[slot:slot + 1, :, :plen] = p.to(d.dtype)\n",
        "                w = (slot + 1) % d.shape[0]\n"
        "                d[w:w + 1, :, :plen] = p.to(d.dtype)\n"),
    "int8_cross_scales_dropped": (
        "models/attention.py",
        "    s = s * (kc[..., 0] / (QRANGE * d ** 0.5))[:, :, None, :]\n",
        "    s = s * (1.0 / (QRANGE * d ** 0.5))\n    vc = torch.ones_like(vc)\n"),
}


def seq2seq_faults() -> None:
    """``--seq2seq-faults``: ``--s2s-reverse`` (which trains the reverse
    model once and saves it in a temporary directory) with this checkout's
    package, then with each of ``S2S_FAULTS`` planted in a copy of it, one
    process each. Prints every reading beside its bound; fails if the sound
    run breaks a bound of ``rev_failures`` or a fault keeps every engine
    within them."""
    phase_device()
    src = Path(__file__).resolve().parent
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "reverse.pt")
        for name, fault in [("sound", None), *S2S_FAULTS.items()]:
            script = package_copy(tmp, src, name, fault)
            proc = subprocess.run([sys.executable, str(script), "--s2s-reverse", ckpt],
                                  capture_output=True, text=True, timeout=1200, check=False)
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
                raise AssertionError(f"--s2s-reverse of {name} exited {proc.returncode}")
            runs[name] = json.loads(proc.stdout.strip().splitlines()[-1])
    failures = {name: rev_failures(r) for name, r in runs.items()}
    emit({"phase": "seq2seq_faults", "training": runs["sound"]["training"],
          "floor": runs["sound"]["training"]["teacher_forced_acc"] - REV_SLACK,
          "runs": {name: {"acc": {k: v["acc"] for k, v in r["engines"].items()},
                          "equal_to_generate": {k: v["equal_to_generate"]
                                                for k, v in r["engines"].items()},
                          "seconds": r["seconds"], "failures": failures[name]}
                   for name, r in runs.items()}})
    bad = [f"sound run: {f}" for f in failures["sound"]]
    bad += [f"{name} was not caught" for name in S2S_FAULTS if not failures[name]]
    if bad:
        raise AssertionError(f"seq2seq faults: {bad}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    if sys.argv[1:2] == ["--dense-step-child"]:
        return dense_step_child(sys.argv[2])
    if sys.argv[1:2] == ["--dense-step-ab"]:
        return dense_step_ab(sys.argv[2], *map(int, sys.argv[3:4]))
    if sys.argv[1:2] == ["--flash-child"]:
        return flash_child(sys.argv[2])
    if sys.argv[1:2] == ["--flash-ab"]:
        return flash_ab(sys.argv[2], *map(int, sys.argv[3:4]))
    if sys.argv[1:2] == ["--gemv-child"]:
        return gemv_child(sys.argv[2])
    if sys.argv[1:2] == ["--gemv-ab"]:
        return gemv_ab(sys.argv[2], *map(int, sys.argv[3:4]))
    if sys.argv[1:2] == ["--tile-child"]:
        return tile_child(sys.argv[2])
    if sys.argv[1:2] == ["--tile-ab"]:
        return tile_ab(sys.argv[2], *map(int, sys.argv[3:4]))
    if sys.argv[1:2] == ["--paged-child"]:
        return paged_child(sys.argv[2])
    if sys.argv[1:2] == ["--paged-ab"]:
        return paged_ab(sys.argv[2], *map(int, sys.argv[3:4]))
    if sys.argv[1:2] == ["--decode-child"]:
        return decode_child(sys.argv[2])
    if sys.argv[1:2] == ["--decode-ab"]:
        return decode_kernels_ab(sys.argv[2], *map(int, sys.argv[3:4]))
    if sys.argv[1:2] == ["--k6-draws"]:
        return k6_draws(int(sys.argv[2]))
    if sys.argv[1:2] == ["--build-times"]:
        return build_times()
    if sys.argv[1:2] == ["--paged-logits"]:
        return paged_logits(int(sys.argv[2]))
    if sys.argv[1:2] == ["--long-copy"]:
        return long_copy_child(*sys.argv[2:4])
    if sys.argv[1:2] == ["--decode-faults"]:
        return decode_faults(int(sys.argv[2]), *sys.argv[3:4])
    if sys.argv[1:2] == ["--quant-child"]:
        return quant_child(sys.argv[2])
    if sys.argv[1:2] == ["--quant-ab"]:
        return quant_ab(sys.argv[2], *map(int, sys.argv[3:4]))
    if sys.argv[1:2] == ["--quant-faults"]:
        return quant_faults(*sys.argv[2:3])
    if sys.argv[1:2] == ["--row12-trace"]:
        return row12_trace()
    if sys.argv[1:2] == ["--graph-child"]:
        return graph_child(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--graph-ab"]:
        return graph_ab(sys.argv[2], *map(int, sys.argv[3:4]))
    if sys.argv[1:2] == ["--graph-faults"]:
        return graph_faults()
    if sys.argv[1:2] == ["--graph-transcripts"]:
        return graph_transcripts()
    if sys.argv[1:2] == ["--spec-tv"]:
        return spec_tv()
    if sys.argv[1:2] == ["--spec-faults"]:
        return spec_faults()
    if sys.argv[1:2] == ["--s2s-reverse"]:
        return s2s_reverse_child(sys.argv[2])
    if sys.argv[1:2] == ["--seq2seq-faults"]:
        return seq2seq_faults()
    if sys.argv[1:2] == ["--tp-faults"]:
        return tp_faults()
    if sys.argv[1:2] == ["--tp-cards"]:
        return tp_cards(int(sys.argv[2]))
    from qgemm_tpu_torch.ops.cuda import _build   # fails outside the repository

    smi = phase_device()
    phase_build()
    if sys.argv[1:2] == ["--only"]:   # a quick first run of some phases
        for name in sys.argv[2].split(","):
            globals()[f"phase_{name}"]()
        return
    phase_shape_limits()
    phase_flash_edges()
    errs = phase_parity()
    timing = phase_timing(errs)
    given_cx = phase_k1_given_cx()
    ops = phase_ops_layer()
    timing.update({name: ops[name] for name in ("softmax", "layernorm", "int8_flash_attention",
                                                "int8_flash_prepass")})
    gemm = phase_gemm_protocol()
    demo = phase_quantize_demo()
    mnist = phase_mnist()
    int8 = phase_serving_int8()
    w4a8 = serve("w4a8", {"bits": 4}, used=("w4a8_matmul", "decode_attention",
                                            "flash_attention"),
                 unused=("quantized_matmul",))
    serve("int8_outlier", {"outlier_threshold": 6.0},
          used=("quantized_matmul", "decode_attention", "flash_attention"),
          unused=("w4a8_matmul",), outliers=True)
    paged8, paged4 = serve_paged()
    graphs = phase_decode_graph()
    phase_surface(graphs["surface_trace"])
    spec = phase_spec()
    tv = spec_tv()
    if not tv["ok"]:
        raise AssertionError(f"spec_tv: the sampled round's draws are off the target's "
                             f"distribution: {tv}")
    moe = serve_moe()
    par = phase_parallel()
    dry = phase_dryrun()
    phase_numerics()
    phase_numerics_moe()
    phase_outlier_numerics()
    train = phase_train()
    geoms = phase_attn_geometries()
    pages = phase_wide_pages()
    induction, copy_model = phase_train_induction()
    phase_train_serve(copy_model)
    phase_long_copy()
    s2s = phase_seq2seq()
    phase_s2s_reverse()
    replaces = {"quantized_matmul": "qgemm_tpu/ops/pallas/quantized_matmul.py:107",
                "decode_attention": "qgemm_tpu/ops/pallas/decode_attention.py:44",
                "flash_attention": "qgemm_tpu/ops/pallas/flash_attention.py:41",
                "w4a8_matmul": "qgemm_tpu/ops/pallas/w4a8_matmul.py:72",
                "paged_decode_attention": "qgemm_tpu/ops/pallas/paged_attention.py:49",
                "paged_context_attention": "qgemm_tpu/ops/pallas/paged_attention.py:328",
                "flash_attention_bwd": "qgemm_tpu/ops/pallas/flash_attention.py:267",
                "expert_matmul": "qgemm_tpu/ops/pallas/expert_matmul.py:47",
                "col_quantize": "qgemm_tpu/ops/pallas/quantized_matmul.py:65",
                "softmax": "qgemm_tpu/ops/pallas/softmax.py:30",
                "layernorm": "qgemm_tpu/ops/pallas/layernorm.py:30",
                "int8_flash_attention": "qgemm_tpu/ops/pallas/int8_flash_attention.py:45"}
    wrappers = KERNEL_WRAPPERS
    # the native-scheduled twins' launches in all (each equal to its Python
    # twin's), the MNIST int8 forward's and the quantize demo's
    twins = {"serving_int8": int8["native_twin"],
             "serving_paged_int4_overcommit": paged4["native_twin"],
             "decode_graph dense_int8 graph_ms4": graphs["engines"]["dense_int8"]["native_twin"],
             "spec dense_int8 spec_graph": spec["engines"]["dense_int8"]["native_twin"]}
    demo_launches = {c["case"]: c["launches"] for c in demo["cases"]}
    kernels = []
    for name in _build.KERNELS:
        t = timing[name]
        path = {"w4a8_matmul": w4a8, "paged_decode_attention": paged8,
                "paged_context_attention": paged8, "flash_attention_bwd": train,
                "expert_matmul": moe, "col_quantize": moe, "softmax": ops, "layernorm": ops,
                "int8_flash_attention": ops}.get(name, int8)
        ws = wrappers.get(name, (name,))
        per_decode = path.get("launches_per_decode_step")
        per_prefill = path.get("launches_per_prefill")
        # K9 runs where the MoE model is built (GPT.init_quantized), not in
        # the engine: its launches are those of serve_moe's init
        launched = path["init_launches"] if name == "col_quantize" else path["launches"]
        entry = {"name": name, "route": "cuda",
                 "source": f"qgemm_tpu_torch/csrc/{name}.cu",
                 "replaces": replaces[name],
                 "launches": sum(launched.get(w, 0) for w in ws),
                 "launches_counted_in": path["phase"],
                 "launches_per_decode_step": (sum(per_decode[w] for w in ws)
                                              if per_decode else None),
                 "launches_per_prefill": (sum(per_prefill[w] for w in ws)
                                          if per_prefill else None),
                 "max_abs_err": t["max_abs_err"], "max_rel_err": t["max_rel_err"],
                 "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                 "timed_at": t["shape"], "timing": "bench_ms: median of 20 "
                 "back-to-back calls queued behind a device sleep, CUDA events "
                 "around each, L2 flushed by a read before each", "card": smi}
        native_counts = {lbl: sum(tw["launches"].get(w, 0) for w in ws)
                         for lbl, tw in twins.items()}
        if any(native_counts.values()):
            entry["launches_native_scheduler_twins"] = {k: v for k, v in native_counts.items()
                                                        if v}
        if any(c.get(name) for c in demo_launches.values()):
            entry["launches_quantize_demo"] = {k: c.get(name, 0) for k, c in
                                               demo_launches.items()}
        if name == "quantized_matmul":
            tp = graphs["tp_serving"]["engines"]
            entry["given_cx_route"] = {
                "note": "K1 on caller-given row scales (row 2's contract): the row-parallel "
                        "int8 layer's route, launched by the mesh engines of tp_serving",
                "launches_per_decode_step_tp_serving": {
                    k: e["given_cx"]["per_decode"] for k, e in tp.items()},
                "launches_tp_serving": {k: e["given_cx"]["in_all"] for k, e in tp.items()},
                "shard_rows": [{k: r[k] for k in ("layer", "p", "m", "k_shard", "n", "ms",
                                                  "fused_ms", "plain_ms", "bound_ms",
                                                  "bound_by", "shard_sum_max_abs_err")}
                               for r in given_cx["rows"]]}
            entry.update(also_replaces="qgemm_tpu/ops/pallas/quantized_matmul.py:139",
                         launches_mnist_int8_per_forward=mnist["int8_launches_per_forward"][name],
                         mnist_shapes=[{k: r[k] for k in ("m", "k", "n", "ms", "plain_ms",
                                                          "bound_ms", "max_abs_err")}
                                       for r in mnist["k1_at_mlp_shapes"]])
        if name == "w4a8_matmul":
            entry["library_note"] = ("no single PyTorch call computes W4A8: "
                                     "torch._weight_int4pack_mm takes bf16 activations")
            entry["k1_ms_same_shape"] = t["k1_ms"]
        if name.startswith("paged"):
            t4 = timing[name + "_int4"]
            entry.update(launches_per_prefill=paged8["prefill_launches"]["per_chunk"].get(name, 0),
                         prefill_unit="one prefill chunk (a 256-row piece of a long prompt, "
                                      "or the suffix after a prefix hit)",
                         library_note=t["library_note"], int4_ms=t4["ms"],
                         int4_plain_ms=t4["plain_ms"], int4_bound_ms=t4["bound_ms"],
                         int4_bound_by=t4["bound_by"],
                         launches_int4_overcommit_run=sum(paged4["launches"][w] for w in ws))
        s2s_counts = {f"{lbl}_per_{'round' if e.get('launches_per_round') else 'step'}":
                      sum((e.get("launches_per_round") or e["launches_per_step"]).get(w, 0)
                          for w in ws) for lbl, e in s2s["engines"].items()}
        s2s_adm, s2s_adm_spec = (sum(s2s["engines"][lbl]["launches_per_admission"].get(w, 0)
                                     for w in ws) for lbl in ("dense_int8", "spec_dense_int8"))
        if any(s2s_counts.values()) or s2s_adm or s2s_adm_spec:
            entry.update(launches_seq2seq={k: v for k, v in s2s_counts.items() if v},
                         launches_seq2seq_per_admission=s2s_adm,
                         launches_seq2seq_per_spec_admission=s2s_adm_spec)
        if name in ("quantized_matmul", "w4a8_matmul", "paged_context_attention"):
            entry["launches_per_spec_round"] = {
                k: e["launches_per_round"].get(name, 0) for k, e in spec["engines"].items()}
        if name == "paged_decode_attention":
            entry.update(also_replaces="qgemm_tpu/ops/pallas/paged_attention.py:160",
                         launches_by_entry={w: path["launches"][w] for w in ws},
                         k2_ms_same_lengths=t["k2_ms_same_lengths"])
        if name == "decode_attention":
            entry["k5_ms_same_lengths"] = t["k5_ms_same_lengths"]
        if name in ("decode_attention", "paged_decode_attention"):
            entry["split_body"] = "qgemm_tpu_torch/csrc/split_decode.cuh"
        if name in ("flash_attention", "flash_attention_bwd"):
            entry.update(launches_per_train_step=train["launches_per_step"][name],
                         launches_train_induction={k: r["launches"][name]
                                                   for k, r in induction.items()})
        if name == "expert_matmul":
            entry.update(also_replaces="qgemm_tpu/ops/pallas/expert_matmul.py:108",
                         library_note="yardstick, not a route: per expert, torch "
                                      "row-quantize + torch._int_mm + dequant",
                         library_timing=t["library_timing"])
        if name == "col_quantize":
            entry.update(launches_counted_in="serving_moe_int8 (GPT.init_quantized)",
                         launches_at_init=path["init_launches"].get(name, 0),
                         launches_per_decode_step=0, launches_per_prefill=0,
                         launches_gemm_protocol=gemm["int8_dynamic_launches"].get(name, 0),
                         library_note="yardstick, not a route: the torch f32 column "
                                      "quantize the port ran before K9",
                         library_timing=t["library_timing"])
        if name == "flash_attention":
            entry.update(library_note="torch.nn.functional.scaled_dot_product_attention, "
                                      "causal, bf16: a yardstick only",
                         plan=t["plan"], achieved_tflops=t["achieved_tflops"],
                         at_train_shape=t["at_train_shape"])
        if name == "flash_attention_bwd":
            entry.update(also_replaces="qgemm_tpu/ops/pallas/flash_attention.py:302",
                         library_note="the backward of torch.nn.functional."
                                      "scaled_dot_product_attention (torch.autograd.grad "
                                      "on a kept graph), a yardstick only",
                         library_timing=t["library_timing"], plan=t["plan"],
                         k3_fwd_ms_same_shape=t["k3_fwd_ms_same_shape"],
                         sdpa_fwd_ms_same_shape=t["sdpa_fwd_ms_same_shape"],
                         ms_by_kernel_traced=t["ms_by_kernel_traced"],
                         achieved_tflops=t["achieved_tflops"],
                         achieved_tflops_executed=t["achieved_tflops_executed"])
        if name in ("softmax", "layernorm", "int8_flash_attention"):
            entry.update({k: t[k] for k in t if k not in entry and k not in
                          ("max_abs_err", "max_rel_err", "shape")})
        par_counts = parallel_launches(par, ws)
        if par_counts:
            entry["launches_parallel"] = par_counts
        if name in WIDE_TIMING_KEYS:
            entry["at_wide_shapes"] = {k: geoms["timing"][k] for k in WIDE_TIMING_KEYS[name]}
            entry["launches_attn_geometries"] = {
                f"{lbl} {tier}": sum(geoms[lbl][tier]["launches"].get(w, 0) for w in ws)
                for lbl in ATTN_GEOMETRIES for tier in ("dense", "paged")}
            if name.startswith("flash"):
                entry["launches_attn_geometries"]["train_gemma2b_widths per step"] = \
                    geoms["train_gemma2b_widths"]["launches_per_step"][name]
        if name in LAST_TIMING_KEYS:
            entry["at_last_shapes"] = {k: pages["timing"][k] for k in LAST_TIMING_KEYS[name]}
        if name in ("paged_decode_attention", "paged_context_attention"):
            entry["launches_wide_pages"] = {
                tier: sum(pages[tier]["launches"].get(w, 0) for w in ws)
                for tier in WIDE_PAGE_TIERS}
        entry["launches_dryrun"] = kernel_launches(dry["launches"], name)
        kernels.append(entry)
    # the int8 flash attention's pre-pass kernel: a second kernel of its
    # source, with its own launch count
    t = timing["int8_flash_prepass"]
    kernels.append({"name": "int8_flash_prepass", "route": "cuda",
                    "source": "qgemm_tpu_torch/csrc/int8_flash_attention.cu",
                    "replaces": "qgemm_tpu/ops/pallas/int8_flash_attention.py:145",
                    "replaces_note": "the XLA pre-pass of flash_attention_int8 (lines 145-163), "
                                     "before its pallas_call",
                    "launches": ops["launches"]["int8_flash_prepass"],
                    "launches_counted_in": ops["phase"],
                    "launches_note": "two device launches a call: the column pass, then the "
                                     "row pass",
                    **{k: t[k] for k in ("max_abs_err", "max_rel_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by", "library_ms", "plain_note",
                                         "library_note", "qk_only_ms", "qk_only_bound_ms")},
                    "error_note": "max_abs_err: K codes against the torch pre-pass's (Q and "
                                  "V codes and their scales bit for bit); max_rel_err: K's "
                                  "row scales",
                    "timed_at": t["shape"], "card": smi})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
