"""The knee of the bursty serving cell: the highest session rate the batcher
sustains with the cell's burst shape, found once by a sweep on the chip.

    python3 -m cudabench.sweep --workload sopro-v1.5-fp32.serve-bursty \\
        --rates 8 10 12 14 16 --seconds 30 --seed 7 --out build/sweep.json

A rate is sustained when, over a run of `--seconds`: no session is refused
or fails, the waiting backlog at the window's end is no larger than at its
middle, and the 95th percentile of the gaps between chunks stays under one
chunk's audio (chunk_frames x 80 ms), past which a client underruns. The
knee is the highest sustained rate below the first rate that is not; the
cell's rate is 0.8 x the knee. Writes both into the cell's traffic file
(`rate`, `knee`) and the table to `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    from cudabench import run

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.getcwd()
    _, cell, _, mix0, _ = run.load_cell(root, args.workload)
    limit_ms = float(mix0["batcher"]["chunk_frames"]) * 80.0
    table = []
    for rate in sorted(args.rates):
        keep: dict = {}
        rc = run.main(["--workload", args.workload, "--seed", str(args.seed), "--seconds",
                       str(args.seconds), "--trace", "0"],
                      cfg_override=lambda c, m, r=rate: (c, dict(m, rate=r)), keep=keep)
        s_mid, s_end = keep.get("stats_mid") or {}, keep.get("stats1") or {}
        e2e = keep.get("end_to_end", {})
        row = {"rate": rate, "rc": rc, "failed": keep.get("failed"),
               "attempted": keep.get("attempted"),
               "waiting_mid": s_mid.get("waiting"), "waiting_end": s_end.get("waiting"),
               "chunk_gap_p95_ms": e2e.get("chunk_gap_p95_ms"),
               "ttfa_p95_ms": e2e.get("ttfa_p95_ms"), "audio_s_per_s": e2e.get("audio_s_per_s")}
        row["sustained"] = bool(rc == 0 and row["failed"] == 0
                                and row["waiting_end"] is not None
                                and row["waiting_end"] <= row["waiting_mid"]
                                and row["chunk_gap_p95_ms"] is not None
                                and row["chunk_gap_p95_ms"] < limit_ms)
        table.append(row)
        print("SWEEP " + json.dumps(row), flush=True)
    knee = None
    for row in table:
        if not row["sustained"]:
            break
        knee = row["rate"]
    result = {"workload": args.workload, "seconds": args.seconds, "seed": args.seed,
              "knee": knee, "rate": None if knee is None else round(0.8 * knee, 3), "table": table}
    if knee is not None:
        path = os.path.join(run.data_dir(root), "traffic", f"{cell['traffic']}.json")
        mix = dict(mix0, knee=knee, rate=result["rate"])
        with open(path, "w") as f:
            json.dump(mix, f, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print("KNEE " + json.dumps({k: result[k] for k in ("knee", "rate")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
