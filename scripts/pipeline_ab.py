#!/usr/bin/env python3
"""Tracking keyframes/s of ``chip_smoke.py``'s pipeline phase for several
checkouts of the repo, one after another on one card.

Each root runs in its own process with its own ``chip_smoke.pipeline``
(bench.py's tracking config, a 320x640 circuit stream, random-weight bf16
net), its kernels built from its own sources. List the roots in an
interleaved order so that drift of the card or host shows:

    python3 scripts/pipeline_ab.py --frames 40 PARENT . . PARENT

Prints one JSON line per run (root, keyframes/s, the pipeline's phase
seconds) and the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

_CHILD = r"""
import json, sys
root, frames = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, root)
import chip_smoke
from glorie_slam_tpu_torch.device import set_float32_precision
set_float32_precision()
chip_smoke.build_all()
pipe, _ = chip_smoke.pipeline(frames)
print("RESULT " + json.dumps({
    "keyframes_per_s": pipe["keyframes_per_s"],
    "steady_frame_ms": pipe["steady_frame_ms"],
    "phase_s": {k: v["total_s"]
                for k, v in pipe["phases"]["phases"].items()}}))
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args()
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(gpu.stdout.strip(), flush=True)
    for root in args.roots:
        root = os.path.abspath(root)
        out = subprocess.run(
            [sys.executable, "-c", _CHILD, root, str(args.frames)],
            cwd=root, capture_output=True, text=True, timeout=900)
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if out.returncode != 0 or not lines:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(lines[-1][len("RESULT "):])
        print(json.dumps({"root": root, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
