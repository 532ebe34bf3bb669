"""Readings for the limits of `correct`: the program's numbers and the
control's, cell by cell, seed by seed, in one process per call.

    python3 -m cudabench.control --workload <cell> --seeds 11 12 13 --seconds 8

For each seed: one run of the cell (short window, the cell's own load and
traffic), the program's numbers against the reference, then the control in
the program's place: the reference itself computed in the nearest
precision below the configuration's (float32 with TF32 off: TF32), on the
same sessions and chunk grids, judged by the same comparison against the
same float32 reference. Prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def control_readings(keep: dict) -> dict:
    """The control's numbers on the sessions a run checked."""
    import torch

    from cudabench import check, run

    cfg = keep["cfg"]
    if cfg["compute_dtype"] != "float32" or cfg.get("tf32"):
        raise ValueError("the control is defined for float32 with TF32 off")
    check.set_tf32(True)
    try:
        ctrl = keep["family"].reference(keep["sd"], cfg, check.Precision(torch.float32),
                                        keep["device"], keep["entry"], keep["mix"])
        outs = ctrl.run(keep["checked"])
    finally:
        check.set_tf32(False)
    del ctrl
    served = [dataclasses.replace(c, wav=o["wav"][: int(sum(c.chunks)) * keep["hop"]])
              for c, o in zip(keep["checked"], outs)]
    limits = keep["limits"]
    out = check.judge(keep["reference"], served, keep["outs"], float(limits["tau"]),
                      float(limits["tie"]), run.TRIES)
    torch.cuda.empty_cache() if torch.cuda.is_available() else None
    return {"wave_err": out.wave_err, "unexplained": out.unexplained,
            "flips": [len(p["flips"]) for p in out.sessions]}


def main(argv=None) -> int:
    from cudabench import run

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        keep: dict = {}
        rc = run.main(["--workload", args.workload, "--seed", str(seed), "--seconds",
                       str(args.seconds), "--trace", "0"], keep=keep)
        if rc != 0 or not keep:
            print(json.dumps({"seed": seed, "rc": rc}), flush=True)
            continue
        o = keep["outcome"]
        line = {"seed": seed, "program": {"wave_err": o.wave_err, "unexplained": o.unexplained},
                "diverged": [s["diverged_at"] for s in o.sessions],
                "flips": [s["flips"] for s in o.sessions],
                "trail": [s["trail"] for s in o.sessions]}
        if not args.no_control:
            line["control"] = control_readings(keep)
        print("READING " + json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
