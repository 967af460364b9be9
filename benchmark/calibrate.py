"""Readings for the limits: the program's numbers and the control's, seed
by seed, in one process.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 3 \
        --seconds 8 [--out readings.jsonl]

Each seed runs the cell once (a short window at the cell's own load and
sizes), compares the program with the plain reference, and compares the
control (the reference one precision step below the configuration's, in
the program's place; ``reference/precision.py``) with the same reference.
One JSON line per seed goes to standard output and to ``--out``; the last
line gives, per number, the largest program reading (the lower reading of
a limit) and the smallest control reading (the upper one). The benchmark's
own runs never run the control.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def summary(rows):
    """{number: {"lower": max program, "upper": min control}}."""
    out = {}
    for r in rows:
        for side, pick, key in (("program", max, "lower"),
                                ("control", min, "upper")):
            for k, v in r[side].items():
                s = out.setdefault(k, {"lower": None, "upper": None})
                if v is not None:
                    v = float(v)
                    s[key] = v if s[key] is None else pick(s[key], v)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out")
    ap.add_argument("--fault", help="plant a fault of benchmark/faults.py: "
                    "the program's readings are then the fault's")
    args = ap.parse_args(argv)

    import torch
    from benchmark import faults, harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device is available", file=sys.stderr)
        return 2
    print(f"card: {harness.card()}", file=sys.stderr)
    if args.fault:
        faults.install(args.fault)
    rows = []
    t0 = T0
    for seed in args.seeds:
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               "cuda", t0, overrides={"control": True})
        t0 = time.perf_counter()
        row = {"seed": seed, "fault": args.fault,
               "program": {k: v["value"] for k, v in res["checked"].items()},
               "control": res["control"],
               "metrics": {k: v["value"] for k, v in res["metrics"].items()},
               "memory_peak_bytes": res["device"]["memory_peak_bytes"]}
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    print(json.dumps({"workload": args.workload, "seeds": args.seeds,
                      "summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
