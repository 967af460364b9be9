#!/usr/bin/env python3
"""Blocking host-device synchronizations inside ``Tracker.step`` and
``Mapper.on_keyframe``, as the CUDA runtime reports them, and whether a
``sync.*`` span of the program covers each.

    python3 scripts/sync_audit.py --workload replica-track --seed 7 \\
        --seconds 45 --out chiprun_out/sync_audit

Runs one cell of the benchmark once, traced, with
``torch.cuda.set_sync_debug_mode("warn")``. Every synchronizing call that
PyTorch reports (a device-to-host read, a copy from pageable host memory,
an operator whose output size is read back, such as ``nonzero`` or a
boolean-mask index) is traced to the innermost frame of the repository
that made it. A call inside ``Tracker.step`` or ``Mapper.on_keyframe`` is
covered when it runs inside a ``utils.phase_timer.sync`` block (its
``sync.*`` site is named; the script wraps ``sync`` before the program's
modules import it, so the blocks are seen with the profiler off too); one
whose innermost frame lies in ``benchmark/`` is the benchmark's own. Counts are over the whole run and over the profiled
stretch. Writes ``<out>/<cell>.json`` (with the run's result line) and
prints the sites; exits 1 when a call of the program inside those two
methods is covered by no span. Needs a CUDA card.
"""

import argparse
import json
import os
import sys
import time
import warnings
from collections import defaultdict
from contextlib import contextmanager

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PKG = os.sep + "glorie_slam_tpu_torch" + os.sep
BENCH = os.sep + "benchmark" + os.sep
ENTRIES = (("step", os.path.join("tracking", "tracker.py")),
           ("on_keyframe", os.path.join("mapping", "mapper.py")))


def _where(code):
    fn = code.co_filename
    return fn[fn.find(PKG) + 1:] if PKG in fn else os.path.relpath(fn, ROOT)


class Audit:
    def __init__(self):
        import torch

        self.recording = torch.autograd._profiler_enabled
        self.sites = defaultdict(lambda: {"run": 0, "stretch": 0})
        self.outside = 0
        self.open = []          # the sync blocks open, innermost last

    def hit(self, frame):
        """Classify one report from the frame that made the call."""
        site = chain = covered = None
        inside = False
        f = frame
        while f is not None:
            code = f.f_code
            fn = code.co_filename
            if site is None and (PKG in fn or BENCH in fn):
                site = f"{_where(code)}:{f.f_lineno} {code.co_name}"
                chain = []
            elif chain is not None and PKG in fn and len(chain) < 3:
                chain.append(f"{_where(code)}:{f.f_lineno} {code.co_name}")
            if any(code.co_name == n and fn.endswith(p) for n, p in ENTRIES):
                inside = True
            f = f.f_back
        if not inside:
            self.outside += 1
            return
        covered = "sync." + self.open[-1] if self.open else None
        kind = ("benchmark" if site and site.startswith("benchmark")
                else "program")
        rec = self.sites[(site, " < ".join(chain or []), covered, kind)]
        rec["run"] += 1
        rec["stretch"] += bool(self.recording())

    def install(self):
        from glorie_slam_tpu_torch.utils import phase_timer

        loaded = {m for m in sys.modules
                  if m.startswith("glorie_slam_tpu_torch.")}
        if loaded - {"glorie_slam_tpu_torch.utils",
                     "glorie_slam_tpu_torch.utils.phase_timer"}:
            raise RuntimeError("sync_audit: the program was imported before "
                               f"its sync blocks were wrapped: {loaded}")
        plain = phase_timer.sync

        @contextmanager
        def sync(site, n=1):
            self.open.append(site)
            try:
                with plain(site, n):
                    yield
            finally:
                self.open.pop()
        phase_timer.sync = sync

        orig = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if "synchronizing CUDA operation" in str(message):
                self.hit(sys._getframe(1))
                return
            orig(message, category, filename, lineno, file, line)
        warnings.showwarning = show
        warnings.simplefilter("always")

    def table(self):
        rows = [{"site": s, "callers": c, "covered_by": cov, "kind": k, **n}
                for (s, c, cov, k), n in self.sites.items()]
        rows.sort(key=lambda r: (r["kind"], r["covered_by"] is not None,
                                 -r["run"]))
        return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "sync_audit"))
    args = ap.parse_args()
    os.environ.setdefault("USE_FLAX", "0")

    import torch
    from benchmark import harness

    if not torch.cuda.is_available():
        print("sync_audit: no CUDA device is available", file=sys.stderr)
        return 2
    audit = Audit()
    audit.install()
    torch.cuda.set_sync_debug_mode("warn")
    result = harness.run_cell(args.workload, args.seed, args.seconds, True,
                              "cuda", T0)
    torch.cuda.set_sync_debug_mode("default")
    rows = audit.table()
    bare = [r for r in rows if r["kind"] == "program"
            and r["covered_by"] is None]
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.workload}.json"), "w") as f:
        json.dump({"cell": args.workload, "seed": args.seed,
                   "card": harness.card(), "torch": torch.__version__,
                   "sites": rows, "outside": audit.outside,
                   "uncovered": len(bare), "result": result}, f, indent=1)
    for r in rows:
        print(f"{r['kind']:9s} {str(r['covered_by']):28s} run {r['run']:6d} "
              f"stretch {r['stretch']:5d}  {r['site']}  < {r['callers']}")
    print(f"[{args.workload}] sites {len(rows)}, uncovered program sites "
          f"{len(bare)}, reports outside the two methods {audit.outside}")
    print(json.dumps(result.get("metrics", {})))
    return 1 if bare else 0


if __name__ == "__main__":
    sys.exit(main())
