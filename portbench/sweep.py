"""Find an open-loop cell's knee once: run its traffic at each of a few fixed
rates and report, for each, the tails, the share of requests within both
limits and whether the backlog grew.

    python3 -m portbench.sweep --workload <cell> --rates 4,6,8 --seconds 20 --seed 1

A request meets the limits when its time to first token (from its due
time) is at most ``--ttft-ms`` and its time per output token at most
``--tpot-ms``; one still waiting for its first token at the close misses.
The backlog is the number of requests due but not yet admitted; it grew
when the close holds more than two more than the window's middle. The
knee is the highest rate whose backlog did not grow. The cell's traffic
file keeps its rate; this only reads.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def backlog(recs, t: float) -> int:
    return sum(1 for r in recs if r.sent <= t and (r.first is None or r.first > t))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--ttft-ms", type=float, default=2000.0)
    ap.add_argument("--tpot-ms", type=float, default=100.0)
    args = ap.parse_args(argv)
    import torch

    from portbench import bench, readers, spec
    if not torch.cuda.is_available():
        print("portbench.sweep: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    for rate in [float(x) for x in args.rates.split(",")]:
        res = bench.run_cell(cell, args.seed, args.seconds, False, "cuda",
                             time.perf_counter(), rate=rate, check=False)
        run = res["run"]
        due = [r for r in run.recs if run.t0 <= r.sent <= run.t1]
        ok = 0
        for r in due:
            if r.first is None or r.first > run.t1:
                continue
            tpot = ((r.finish - r.first) / (r.seen - 1) if r.finish is not None and r.seen > 1
                    else 0.0)
            ok += (r.first - r.sent) * 1e3 <= args.ttft_ms and tpot * 1e3 <= args.tpot_ms
        mid = backlog(run.recs, (run.t0 + run.t1) / 2)
        end = backlog(run.recs, run.t1)
        print(json.dumps({"rate_per_s": rate, "due": len(due),
                          "ttft_p95_ms": readers.ttft_p95_ms(run),
                          "tpot_p95_ms": readers.tpot_p95_ms(run),
                          "within_limits": ok / len(due) if due else None,
                          "backlog_mid": mid, "backlog_end": end,
                          "grew": end > mid + 2,
                          "completed_tokens_per_s": readers.output_tokens_per_s(run)}),
              flush=True)
        del res, run
    return 0


if __name__ == "__main__":
    sys.exit(main())
