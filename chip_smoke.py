"""End-to-end check of the PyTorch/CUDA port (qgemm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from qgemm_tpu_torch/csrc, holds each one
against its plain PyTorch version at GPT_6_7B shapes, times them, runs
bench.py's GEMM protocol at 2048^3, and serves 16 greedy requests through
ContinuousBatchingEngine on the full-width, full-depth GPT_6_7B (random
weights from a seed, int8 KV cache) three times: int8 weights, int4 (W4A8)
weights, and int8 weights with the LLM.int8() outlier split (outlier
feature dims planted in the LayerNorm gains). Each serving run checks that
it went through its kernels. Then it compares a 2-layer full-width
model's prefill logits between the CPU (float32, plain versions) and the
GPU (bf16, kernels), and the logits' quantization error with and without
the outlier split. Each phase prints one JSON line; the last line is
{"ok": true, "device": {...}}. Any failure raises, so the exit code is
nonzero. Needs one CUDA device; exits nonzero without one. Uses no JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import time

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
    from qgemm_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    built = _build.build()
    secs = time.perf_counter() - t0
    for name, log in _build.build_logs.items():
        print(f"--- ptxas {name}\n{log}", file=sys.stderr)
    emit({"phase": "build", "seconds": round(secs, 2), "built": built})


def phase_parity() -> dict:
    """Each kernel against its plain version at the serving shapes."""
    from qgemm_tpu_torch.ops.cuda.decode_attention import (decode_attention,
                                                           decode_attention_plain)
    from qgemm_tpu_torch.ops.cuda.flash_attention import (flash_attention_fwd,
                                                          flash_attention_plain)
    from qgemm_tpu_torch.ops.kv_cache import quantize_kv
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
                         "w4a8_matmul")}
    report = []

    def record(name, got, ref, **row):
        e, r = max_err(got, ref), rel_err(got, ref)
        errs[name]["max_abs_err"] = max(errs[name]["max_abs_err"], e)
        errs[name]["max_rel_err"] = max(errs[name]["max_rel_err"], r)
        report.append(dict(kernel=name, max_abs_err=e, max_rel_err=r, **row))
        return e

    # K1: identical int8 codes on both sides, so only the f32 epilogue's
    # association differs: |err| <= 1e-6 * max|ref| (a few f32 ulps)
    for k, n in GEMM_SHAPES:
        w = torch.randn((k, n), generator=g, device=dev).to(torch.bfloat16) * 0.02
        wq = quantize_weights(w)
        x = torch.randn((512, k), generator=g, device=dev).to(torch.bfloat16)
        rows = {}
        for m in (1, 8, 300, 512):
            got = quantized_matmul_prequant(x[:m], wq)
            ref = quantized_matmul_plain(x[:m], wq)
            tol = 1e-6 * float(ref.abs().max())
            e = record("quantized_matmul", got, ref, m=m, k=k, n=n, tol=tol)
            if not e <= tol:
                raise AssertionError(f"K1 m={m} k={k} n={n}: max err {e} > {tol}")
            rows[m] = got[0]
        # a row's result may not depend on how many rows share the call
        for m in (8, 300, 512):
            if not torch.equal(rows[m], rows[1]):
                raise AssertionError(f"K1 row 0 differs between m=1 and m={m} (k={k}, n={n})")
        del w, wq, x

    # K4: identical int8 codes and int32 group sums, and both kernels fold
    # groups and slabs in the plain version's order with correctly rounded
    # f32 steps: |err| <= 1e-6 * max|ref| (a few f32 ulps; expected 0). The
    # first K slab is 8x larger, so per-slab scales differ within a row.
    for k, n in GEMM_SHAPES:
        wq4 = quantize_weights_int4(torch.randn((k, n), generator=g, device=dev) * 0.02)
        x = torch.randn((512, k), generator=g, device=dev)
        x[:, :2048] *= 8.0
        x = x.to(torch.bfloat16)
        rows = {}
        for m in (1, 8, 300, 512):
            got = quantized_matmul_prequant_w4(x[:m], wq4)
            ref = w4a8_matmul_plain(x[:m], wq4)
            tol = 1e-6 * float(ref.abs().max())
            e = record("w4a8_matmul", got, ref, m=m, k=k, n=n, tol=tol)
            if not e <= tol:
                raise AssertionError(f"K4 m={m} k={k} n={n}: max err {e} > {tol}")
            rows[m] = got[0]
        for m in (8, 300, 512):
            if not torch.equal(rows[m], rows[1]):
                raise AssertionError(f"K4 row 0 differs between m=1 and m={m} (k={k}, n={n})")
        del wq4, x

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

    # K3: bf16 O rounds once on each side (2^-7 relative), p rounds to bf16
    # relative to a running max (rare one-ulp flips, atol 1e-2); lse sums
    # unrounded p in f32 (atol 1e-4)
    for sq, causal in [(8, True), (300, True), (512, True), (2048, True), (300, False)]:
        q, k, v = (torch.randn((1, 32, sq, 128), generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        ro, rl = flash_attention_plain(q, k, v, causal=causal)
        el = max_err(lse, rl)
        e = record("flash_attention", o, ro, sq=sq, causal=causal,
                   lse_max_abs_err=el, tol=1e-2)
        if not (excess(o, ro, 2 ** -7) <= 1e-2 and el <= 1e-4):
            raise AssertionError(f"K3 sq={sq} causal={causal}: O err {e}, lse err {el}")
    torch.cuda.synchronize()
    emit({"phase": "parity", "checks": report, "outlier_gemm": outlier_checks})
    return errs


def phase_timing(errs: dict) -> dict:
    """Kernel, plain-version and library device times at the main path's
    shapes: bench_ms, the median of 20 calls queued back to back behind a
    device sleep, each between its own CUDA events, L2 flushed by a read
    before each."""
    import torch.nn.functional as F

    from qgemm_tpu_torch.ops.cuda.decode_attention import (decode_attention,
                                                           decode_attention_plain)
    from qgemm_tpu_torch.ops.cuda.flash_attention import (flash_attention_fwd,
                                                          flash_attention_plain)
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
    for m in (8, 512):
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
            bms, by = bound(m * k * 2 + k * n + n * 4 + m * n * 4, 2 * m * n * k, INT8_OPS)
            k1_rows.append({"m": m, "k": k, "n": n, "ms": ms, "plain_ms": plain,
                            "library_ms": lib, "bound_ms": bms, "bound_by": by})
            del wq, x
    emit({"phase": "timing_k1_shapes", "rows": k1_rows})
    head = k1_rows[1]          # m=8, k=4096, n=16384: the FFN-up GEMM of a decode step
    out["quantized_matmul"] = dict(head, **errs["quantized_matmul"],
                                   shape=f"m={head['m']} k={head['k']} n={head['n']}")

    # K4 with K1 beside it at the same shape (the int8 point of comparison,
    # not a yardstick: K1 computes another function). No single PyTorch
    # call computes W4A8: torch._weight_int4pack_mm takes bf16 activations
    # (A16W4), so library_ms is null.
    k4_rows = []
    for m in (8, 512):
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
                            "k1_ms": k1})
            del wq4, wq, x
    emit({"phase": "timing_k4_shapes", "rows": k4_rows})
    head = k4_rows[1]
    out["w4a8_matmul"] = dict(head, **errs["w4a8_matmul"],
                              shape=f"m={head['m']} k={head['k']} n={head['n']}")

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

    sq = 512
    q, k, v = (torch.randn((1, h, sq, d), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    ms = bench_ms(lambda: flash_attention_fwd(q, k, v, causal=True))
    plain = bench_ms(lambda: flash_attention_plain(q, k, v, causal=True))
    lib = bench_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    pairs = sq * (sq + 1) // 2
    bms, by = bound(4 * h * sq * d * 2 + h * sq * 4, h * pairs * 4 * d, BF16_FLOPS)
    out["flash_attention"] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                              "bound_ms": bms, "bound_by": by,
                              **errs["flash_attention"],
                              "shape": f"B=1 H={h} S={sq} D={d} causal"}
    return out


def profile_decode(engine, rng, n_steps: int = 10) -> dict:
    """Where a steady decode step's time goes, with 8 busy slots: three
    windows of ``n_steps`` steps back to back, the middle one traced by
    torch.profiler (CUDA activity only). The trace gives the device's
    kernel time per step (the union of kernel intervals). The idle share is
    1 - kernel time / wall time, against the traced window's own wall time
    (which carries the profiler's host cost, so it is an upper bound) and
    against the mean wall time of the two untraced windows around it (whose
    slots sit, on average, at the traced window's positions). Runs after
    the serving phase's launch counts were read."""
    from torch.profiler import ProfilerActivity, profile

    from qgemm_tpu_torch.serving.engine import Request
    vocab = engine.model.cfg.vocab_size
    for _ in range(engine.max_slots):
        engine.submit(Request(prompt=rng.integers(0, vocab, size=300).tolist(),
                              max_new_tokens=3 * n_steps + 8))
    for _ in range(3):          # admits every slot, then two warm steps
        engine.step()
    if engine.book.num_active != engine.max_slots:
        raise AssertionError("profile window: not every slot is decoding")

    def window() -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n_steps):
            engine.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / n_steps

    before = window()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced_ms = window()
    after = window()
    if engine.book.num_active != engine.max_slots:
        raise AssertionError("profile window: a slot finished inside the windows")
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    engine.run_to_completion()
    if not spans:
        raise AssertionError("torch.profiler recorded no device kernel in the window")
    busy_us, end, by_name = 0.0, float("-inf"), {}
    for s, e, name in spans:        # union of the kernels' intervals
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    kernel_ms = busy_us / 1e3 / n_steps
    untraced_ms = (before + after) / 2
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": n_steps, "slots": engine.max_slots,
            "wall_ms_per_step_untraced": untraced_ms,
            "wall_ms_per_step_untraced_windows": [before, after],
            "wall_ms_per_step_traced": traced_ms,
            "kernel_ms_per_step": kernel_ms,
            "idle_share_untraced": 1.0 - kernel_ms / untraced_ms,
            "idle_share_traced": 1.0 - kernel_ms / traced_ms,
            "device_events_per_step": len(spans) / n_steps,
            "top_kernels_ms_per_step": {n[:80]: v / 1e3 / n_steps for n, v in top}}


def plant_outlier_dims(model) -> None:
    """Systematic outlier features, as LLM.int8() reports for OPT-6.7B:
    ln1 and ln2 gain 20 at six fixed dims in every block. LayerNorm
    outputs are about N(0, 1) with random weights, so without this no
    activation would pass the 6.0 threshold."""
    with torch.no_grad():
        for blk in model.blocks:
            blk.ln1.gamma[OUTLIER_DIMS] = 20.0
            blk.ln2.gamma[OUTLIER_DIMS] = 20.0


def serve(label: str, qkw: dict, used: tuple, unused: tuple, outliers: bool = False) -> dict:
    """One pass of the main path: GPT_6_7B (full width and depth, weights
    quantized with ``qkw``) serving 16 greedy requests through the
    continuous-batching engine with an int8 KV cache. The launch counts are
    set to 0 just before the run and read just after it: every kernel in
    ``used`` must have launched and none in ``unused``. With ``outliers``
    the outlier dims are planted, a forward pre-hook on every quantized
    linear adds its input's count of columns above the threshold into a
    device tensor (read once, after the run), and the transcripts are not
    held to isolated generation: outlier selection runs over every row of
    a step, so a request's tokens may depend on what shares its step."""
    from qgemm_tpu_torch.models.gpt import GPT, GPT_6_7B
    from qgemm_tpu_torch.models.linear import QuantizedLinear
    from qgemm_tpu_torch.ops import cuda as kernels
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
    plens = rng.integers(128, 501, size=16)
    news = rng.integers(16, 49, size=16)
    reqs = [Request(prompt=rng.integers(0, GPT_6_7B.vocab_size, size=int(p)).tolist(),
                    max_new_tokens=int(nn)) for p, nn in zip(plens, news)]
    engine = ContinuousBatchingEngine(model, max_slots=8, max_seq_len=1024,
                                      quantized_cache=True, device="cuda")
    for r in reqs:
        engine.submit(r)

    kernels.reset_launch_counts()
    decode_only, admit_steps, step_ms = [], [], []
    while engine.book.num_waiting or engine.book.num_active:
        before = kernels.launch_counts()
        n_adm = len(engine._admit_times)
        t = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t) * 1e3
        delta = {kk: v - before[kk] for kk, v in kernels.launch_counts().items()}
        admitted = len(engine._admit_times) - n_adm
        if admitted:
            admit_steps.append((admitted, delta))
        else:
            decode_only.append(delta)
            step_ms.append(dt)
    counts = kernels.launch_counts()
    engine.run_to_completion()
    stats = engine.stats
    for hook in hooks:
        hook.remove()
    columns_above = int(above)

    bad = [(r.id, r.error) for r in reqs if not r.done or r.error is not None]
    if bad:
        raise AssertionError(f"{label}: requests failed or unfinished: {bad}")
    for r in reqs:
        if len(r.generated) != r.max_new_tokens:
            raise AssertionError(f"{label}: request {r.id}: {len(r.generated)} tokens, "
                                 f"wanted {r.max_new_tokens}")
    if not all(counts[k] > 0 for k in used):
        raise AssertionError(f"{label}: a kernel of the path never launched: {counts}")
    if any(counts[k] for k in unused):
        raise AssertionError(f"{label}: a kernel off the path launched: {counts}")
    if outliers and not columns_above > 0:
        raise AssertionError(f"{label}: no activation column passed the outlier threshold")
    per_decode = decode_only[0] if decode_only else None
    if any(dd != per_decode for dd in decode_only):
        raise AssertionError(f"{label}: decode steps launched different kernel counts")
    per_prefill = None
    if admit_steps and per_decode is not None:
        n, dd = admit_steps[0]
        per_prefill = {kk: (dd[kk] - per_decode[kk]) // n for kk in dd}
    n_gemms = 4 * GPT_6_7B.n_layers + 2 * GPT_6_7B.n_layers + 1
    for k in used:
        if k in ("quantized_matmul", "w4a8_matmul") and not (
                per_decode[k] == n_gemms and per_prefill[k] == n_gemms):
            raise AssertionError(f"{label}: {k} launched {per_decode[k]} times per decode "
                                 f"step and {per_prefill[k]} per prefill, not {n_gemms}")

    matched = 0
    if not outliers:     # rows are independent: two transcripts equal generate
        for r in reqs[:2]:
            iso = model.generate(torch.tensor([r.prompt], device="cuda"), r.max_new_tokens,
                                 quantized_cache=True)[0].tolist()
            if iso != r.generated:
                raise AssertionError(f"{label}: request {r.id}: engine {r.generated} "
                                     f"!= generate {iso}")
            matched += 1
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    profile = profile_decode(engine, rng)
    res = {"phase": f"serving_{label}",
           "model": f"GPT_6_7B {label} weights, int8 KV cache",
           "quantize": qkw, "layers": GPT_6_7B.n_layers, "d_model": GPT_6_7B.d_model,
           "vocab": GPT_6_7B.vocab_size, "init_s": round(init_s, 2),
           "requests": len(reqs), "prompt_tokens": int(plens.sum()),
           "stats": stats, "decode_steps_timed": len(step_ms),
           "decode_step_ms_mean": float(np.mean(step_ms)) if step_ms else None,
           "decode_step_ms_median": float(np.median(step_ms)) if step_ms else None,
           "launches": counts, "launches_per_decode_step": per_decode,
           "launches_per_prefill": per_prefill,
           "peak_mem_gb": round(peak / 2**30, 2),
           "transcripts_match_generate": matched, "decode_profile": profile}
    if outliers:
        res["outlier_dims_planted"] = OUTLIER_DIMS
        res["columns_above_threshold"] = columns_above
    emit(res)
    del engine, model
    torch.cuda.empty_cache()
    return res


def phase_gemm_protocol() -> dict:
    """bench.py's protocol on the card: M = N = K = 2048, uniform(-1, 1)
    f32 operands; the signed mean error of the dynamic int8 path against
    the exact f32 product; bench_ms times of f32 (TF32 off) and bf16
    torch.matmul, the dynamic int8 path (torch column-quantize of W, then
    K1: TPU kernel row 3), the prequantized int8 path (K1) and W4A8 (K4).
    Row 3's library time is one torch pipeline of the same function:
    row- and column-quantize, torch._int_mm, dequant."""
    from qgemm_tpu_torch.ops.quantize import (absmax_quantize, dequantize, quantize_weights,
                                              quantize_weights_int4, quantized_matmul,
                                              quantized_matmul_plain,
                                              quantized_matmul_prequant,
                                              quantized_matmul_prequant_w4)
    from qgemm_tpu_torch.utils.profiling import bench_ms
    m = n = k = 2048
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    x = torch.rand((m, k), generator=g, device="cuda") * 2 - 1
    w = torch.rand((k, n), generator=g, device="cuda") * 2 - 1
    exact = torch.matmul(x, w)
    err = quantized_matmul(x, w) - exact
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
             lambda: quantized_matmul_plain(x, quantize_weights(w))),
         "int8_dynamic_library_ms": bench_ms(int_mm_dynamic),
         "int8_prequant_ms": bench_ms(lambda: quantized_matmul_prequant(x, wq)),
         "w4a8_ms": bench_ms(lambda: quantized_matmul_prequant_w4(x, wq4))}
    bms, by = bound(4 * (m * k + k * n + m * n), 2 * m * n * k, INT8_OPS)
    res = {"phase": "gemm_protocol", "m": m, "n": n, "k": k,
           "operands": "uniform(-1, 1) float32",
           "int8_dynamic_signed_mean_err": float(err.mean()),
           "int8_dynamic_mean_abs_err": float(err.abs().mean()),
           "w4a8_signed_mean_err": float(err4.mean()),
           "w4a8_mean_abs_err": float(err4.abs().mean()),
           **t, "int8_dynamic_bound_ms": bms, "int8_dynamic_bound_by": by,
           "speedup_int8_dynamic_vs_f32": t["f32_ms"] / t["int8_dynamic_ms"],
           "speedup_int8_dynamic_vs_bf16": t["bf16_ms"] / t["int8_dynamic_ms"]}
    emit(res)
    return res


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
    for mod in gpu.modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            p.data = p.data.to(torch.bfloat16)
        if hasattr(mod, "pos"):
            mod.pos = mod.pos.to(torch.bfloat16)
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
    ref = model.forward(tokens)[0, -1].double()
    errs = {}
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    from qgemm_tpu_torch.ops.cuda import _build   # fails outside the repository

    smi = phase_device()
    phase_build()
    errs = phase_parity()
    timing = phase_timing(errs)
    phase_gemm_protocol()
    int8 = serve("int8", {}, used=("quantized_matmul", "decode_attention", "flash_attention"),
                 unused=("w4a8_matmul",))
    w4a8 = serve("w4a8", {"bits": 4}, used=("w4a8_matmul", "decode_attention",
                                            "flash_attention"),
                 unused=("quantized_matmul",))
    serve("int8_outlier", {"outlier_threshold": 6.0},
          used=("quantized_matmul", "decode_attention", "flash_attention"),
          unused=("w4a8_matmul",), outliers=True)
    phase_numerics()
    phase_outlier_numerics()
    replaces = {"quantized_matmul": "qgemm_tpu/ops/pallas/quantized_matmul.py:107",
                "decode_attention": "qgemm_tpu/ops/pallas/decode_attention.py:44",
                "flash_attention": "qgemm_tpu/ops/pallas/flash_attention.py:41",
                "w4a8_matmul": "qgemm_tpu/ops/pallas/w4a8_matmul.py:72"}
    kernels = []
    for name in _build.KERNELS:
        t = timing[name]
        path = w4a8 if name == "w4a8_matmul" else int8
        entry = {"name": name, "route": "cuda",
                 "source": f"qgemm_tpu_torch/csrc/{name}.cu",
                 "replaces": replaces[name], "launches": path["launches"][name],
                 "launches_counted_in": path["phase"],
                 "launches_per_decode_step": path["launches_per_decode_step"][name],
                 "launches_per_prefill": path["launches_per_prefill"][name],
                 "max_abs_err": t["max_abs_err"], "max_rel_err": t["max_rel_err"],
                 "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                 "timed_at": t["shape"], "timing": "bench_ms: median of 20 "
                 "back-to-back calls queued behind a device sleep, CUDA events "
                 "around each, L2 flushed by a read before each", "card": smi}
        if name == "quantized_matmul":
            entry["also_replaces"] = "qgemm_tpu/ops/pallas/quantized_matmul.py:139"
        if name == "w4a8_matmul":
            entry["library_note"] = ("no single PyTorch call computes W4A8: "
                                     "torch._weight_int4pack_mm takes bf16 activations")
            entry["k1_ms_same_shape"] = t["k1_ms"]
        kernels.append(entry)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
