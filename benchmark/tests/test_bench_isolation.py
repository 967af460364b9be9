"""What the benchmark runs loads neither JAX nor the JAX package, and its
plain reference loads nothing of the program."""

import subprocess
import sys

from benchmark import harness

RUN_IMPORTS = """
import sys, benchmark.run, benchmark.harness, benchmark.calibrate
import benchmark.loops.track, benchmark.loops.map
import glorie_slam_tpu_torch.slam, glorie_slam_tpu_torch.mapping.mapper
import glorie_slam_tpu_torch.utils.synthetic
import glorie_slam_tpu_torch.utils.printer
b = benchmark.harness.Bench()
for m in b.spec["end_to_end"] + b.spec["per_layer"]:
    b.reader(m["name"])
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""

REF_IMPORTS = """
import sys, benchmark.check, benchmark.weights, benchmark.scene
import benchmark.reference.tracking, benchmark.reference.mapping
import benchmark.yardstick.flops, benchmark.yardstick.trace
import benchmark.yardstick.roofline, benchmark.yardstick.stats
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _tops(code):
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": harness.ROOT}
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    return set(out.stdout.split())


def test_run_loads_no_jax():
    tops = _tops(RUN_IMPORTS)
    assert "glorie_slam_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    tops = _tops(REF_IMPORTS)
    assert "glorie_slam_tpu_torch" not in tops
    assert not tops & set(harness.FORBIDDEN)


def test_whole_names_are_compared(monkeypatch):
    mod = sys.modules[__name__]
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "glorie_slam_tpu_torch.fake", mod)
    monkeypatch.setitem(sys.modules, "jaxtyping", mod)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "glorie_slam_tpu.fake", mod)
    assert harness.forbidden_modules() == ["glorie_slam_tpu"]


def test_fails_without_the_program(tmp_path):
    """In a folder that holds only BENCHMARK.json and the benchmark, a run
    fails and prints no result."""
    import shutil
    shutil.copy(f"{harness.ROOT}/BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import time; from benchmark import harness; "
            "print(harness.run_cell('tum-track', 1, 1.0, False, 'cpu', "
            "time.perf_counter()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin",
                              "PYTHONPATH": str(tmp_path)},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "glorie_slam_tpu_torch" in out.stderr
