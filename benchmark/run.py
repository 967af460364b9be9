"""Run one cell of the benchmark once, on the card this process finds.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the cell's metrics (the end-to-end ones, or with ``--trace 1`` the
per-layer ones) as one JSON line, the last line of standard output, and
each number compared with the plain reference beside its limit as the last
lines of standard error. Exits with another code than 0, printing no
result, when no CUDA card is present (or fewer than the cell asks for), or
when JAX, flax or the JAX package ``glorie_slam_tpu`` is loaded once the
window has closed.

Kernel builds go to ``glorie_slam_tpu_torch/_build/`` inside the checkout
(the port builds its kernels there with nvcc; it uses no Triton or
extension cache); run outputs (the DPT's prior cache, traces) go to a
fresh folder under ``TMPDIR``, removed at the end.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402



def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    os.environ.setdefault("USE_FLAX", "0")

    import torch
    from benchmark import harness

    bench = harness.Bench()
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device is available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    print(f"card: {harness.card()}", file=sys.stderr)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T0, bench=bench)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
