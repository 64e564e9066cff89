"""Read the numbers that a cell's correctness limit is set from: the program
as the cell serves it, and its control (the port's own W4A8 path, int4
weights, the nearest precision below the configuration's int8), each over
several seeds in one process, each a short window at the cell's own load
compared with the int8 reference as a run compares it.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 15

Prints one JSON line per run: ``side``, ``seed``, both gaps as read
(whether or not the cell limits them) and ``correct``, the cell's own
check (``bench.is_correct``) on that run. Then a summary: for each gap the
program's largest reading (the lower one) and the control's smallest (the
upper one), and whether every control run came out not correct. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

CONTROL = {"bits": 4}
GAPS = ("max_logit_gap", "mean_logit_gap")


def reading(res: dict) -> dict:
    """One run's line: both gaps as read, and the cell's own verdict."""
    from portbench import bench
    return {**{k: res["readings"].get(k) for k in GAPS},
            "correct": bench.is_correct(res["checks"]),
            "served": res["checks"]["served_tokens"]["value"], "failed": res["failed"]}


def summary(lines: list) -> dict:
    """Per gap the program's largest reading and the control's smallest."""
    out = {}
    for k in GAPS:
        prog = [x[k] for x in lines if x["side"] == "program" and x[k] is not None]
        ctrl = [x[k] for x in lines if x["side"] == "control" and x[k] is not None]
        out[k] = {"lower": max(prog) if prog else None, "upper": min(ctrl) if ctrl else None}
    out["control_never_correct"] = not any(x["correct"] for x in lines
                                           if x["side"] == "control")
    out["program_always_correct"] = all(x["correct"] for x in lines if x["side"] == "program")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)
    import torch

    from portbench import bench, spec
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    lines = []
    for side, seeds, quant in (("program", args.seeds, None),
                               ("control", args.control_seeds, CONTROL)):
        for s in [int(x) for x in seeds.split(",") if x]:
            t = time.perf_counter()
            res = bench.run_cell(cell, s, args.seconds, False, "cuda", t, quantize=quant)
            line = {"side": side, "seed": s, **reading(res),
                    "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                    "seconds": time.perf_counter() - t}
            lines.append(line)
            print(json.dumps(line), flush=True)
            del res
    print(json.dumps({"workload": cell.name, **summary(lines),
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
