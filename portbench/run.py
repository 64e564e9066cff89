"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero, printing no result, without a CUDA card (or with fewer
cards than the cell asks for), and when JAX or the JAX package is loaded
in this process once the window has closed. The last line of standard
output is the result (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``; the numbers compared
come last, under ``checks``); the last lines of standard error repeat the
numbers compared with their limits.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

_T_IMPORT = time.perf_counter()


def process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock (from
    /proc/self/stat), or this module's import where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


def finite(x):
    return x if x is None or math.isfinite(x) else sys.float_info.max


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import bench, spec
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    res = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    bad = bench.forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    checks = res["checks"]
    out = {"correct": bench.is_correct(checks), "attempted": res["attempted"],
           "failed": res["failed"],
           "metrics": {k: {"value": finite(v["value"]), "unit": v["unit"]}
                       for k, v in res["metrics"].items()},
           "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                      "count": cell.chips, "memory_peak_bytes": res["memory_peak_bytes"]}}
    tr = res.get("trace")
    if tr is not None:
        out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        top = sorted(tr.by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(tr.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[n[:160], s] for n, s in top],
                            "idle_gaps": [[n, s] for n, s in gaps]}
        print(f"trace: {tr.kernels} kernels in the traced window, {tr.outside} outside it",
              file=sys.stderr)
    out["checks"] = {k: {"value": finite(v["value"]), "limit": v["limit"]}
                     for k, v in checks.items()}
    sys.stdout.flush()
    for k, v in checks.items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
