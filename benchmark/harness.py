"""What ``run.py`` drives: a cell found by name, run once, and its result.

``BENCHMARK.json`` (at the root of the repository) names each cell's
configuration and traffic mix. Each sits in a file of its own here, found
by name: ``configs/<config>.json`` (the configuration as it is run),
``traffic/<traffic>.json`` (the mix's parameters, read by the loop in
``loops/<loop>.py`` that the mix names), ``limits/<cell>.json`` (the
limits of the numbers compared) and ``metrics/<metric>.py`` (a reader
``read(record)`` per metric, returning None where it finds nothing to
read). Adding a cell, a configuration or a metric adds files and entries;
no file here changes.
"""

import copy
import importlib
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "glorie_slam_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root`` (the
    repository) and ``here`` (the benchmark's folder)."""

    def __init__(self, root=ROOT, here=HERE):
        self.root, self.here = root, here
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name):
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name):
        return load_json(os.path.join(self.here, "configs", f"{name}.json"))

    def traffic(self, name):
        return load_json(os.path.join(self.here, "traffic", f"{name}.json"))

    def limits(self, cell):
        return load_json(os.path.join(self.here, "limits", f"{cell}.json"))

    def metrics(self, cell, trace):
        """The metric entries a run of ``cell`` reports: the end-to-end ones
        without tracing, the per-layer ones with it; an entry with
        ``workloads`` only in those cells."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.spec[key]
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric):
        """``read`` of ``metrics/<metric>.py``."""
        path = os.path.join(self.here, "metrics", f"{metric}.py")
        modname = "benchmark.metrics." + metric.replace(".", "_").replace(
            "-", "_")
        spec = importlib.util.spec_from_file_location(modname, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def loop(self, name):
        return importlib.import_module(f"benchmark.loops.{name}")


class Record:
    """What a loop measured, for the metric readers.

    kind: the loop's name ("track", "map"); units: work units (keyframes,
    iterations) completed in the window; samples: each unit's seconds,
    where the loop times them one by one; window_s, setup_s; host_s /
    host_n: synchronized host spans over the window (traced runs); trace:
    the reduced profile of the stretch (``yardstick.trace.Reduced``) or
    None; stretch_units: units in the stretch; calls: per-call records from
    the stretch; cfg: the configuration as run.
    """

    def __init__(self, kind, cfg, **kw):
        self.kind, self.cfg = kind, cfg
        self.units = 0
        self.samples = []
        self.window_s = self.setup_s = None
        self.host_s, self.host_n = {}, {}
        self.trace = None
        self.stretch_units = 0
        self.calls = {}
        self.__dict__.update(kw)


class Context:
    """One run's inputs for a loop."""

    def __init__(self, bench, cell, seed, seconds, trace, device, t0,
                 out_dir, overrides=None):
        over = overrides or {}
        self.bench = bench
        self.cell = bench.cell(cell)
        self.name = cell
        self.cfg = merged(bench.config(self.cell["config"])["config"],
                          over.get("cfg", {}))
        self.traffic = merged(bench.traffic(self.cell["traffic"]),
                              over.get("traffic", {}))
        self.dpt_kw = over.get("dpt", {})
        self.with_control = over.get("control", False)
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t0, self.out_dir = device, t0, out_dir
        self.cfg["data"]["output"] = out_dir


def merged(base, over):
    """A deep copy of ``base`` with ``over``'s entries put in, nested
    dictionaries entry by entry (the CPU tests shrink a cell this way)."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merged(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def card():
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown (nvidia-smi unavailable)"


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (whole names compared)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def run_cell(cell, seed, seconds, trace, device, t0, bench=None,
             log=sys.stderr, overrides=None):
    """Run ``cell`` once -> the result dict (``correct`` ... ``checked``)."""
    import torch

    bench = bench or Bench()
    seed = int(seed)
    torch.manual_seed(seed % (1 << 63))
    out_dir = tempfile.mkdtemp(prefix="glorie-bench-")
    try:
        ctx = Context(bench, cell, seed, seconds, trace, device, t0,
                      out_dir, overrides)
        loop = bench.loop(ctx.traffic["loop"])
        rec, numbers, device_info, breakdown = loop.run(ctx)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    limits = bench.limits(cell)["limits"]
    from .check import judge
    ok, rows = judge(numbers, limits)

    metrics = {}
    for m in bench.metrics(cell, trace):
        v = bench.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if rec.samples:
        med = sorted(rec.samples)[len(rec.samples) // 2]
        print(f"[{cell}] per-unit seconds: median {med!r}, samples "
              f"{len(rec.samples)}, units {rec.units}, window "
              f"{rec.window_s!r} s", file=log)
    else:
        mean = rec.window_s / max(1, rec.units)
        print(f"[{cell}] units {rec.units} (mean {mean!r} s each), window "
              f"{rec.window_s!r} s", file=log)
    for name, m in metrics.items():
        print(f"[{cell}] {name} = {m['value']!r} {m['unit']}", file=log)
    result = {"correct": ok, "attempted": rec.units,
              "failed": 0 if ok else 1, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["card"] = card() if device != "cpu" else "cpu"
    if getattr(rec, "control", None) is not None:
        result["control"] = rec.control
    result["checked"] = {
        name: {"value": (v if v is None or math.isfinite(v) else str(v)),
               "limit": lim} for name, v, lim in rows}
    for name, v, lim in rows:
        print(f"check {name}: {v!r} (limit {lim!r})", file=log)
    return result
