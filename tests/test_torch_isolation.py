"""The port never uses JAX, flax or the JAX package, and imports PyYAML,
OpenCV, matplotlib, msgpack, PIL and wandb only inside the functions that
need them: every module of ``glorie_slam_tpu_torch``, ``chip_smoke`` and
the sharded path's drills (``tests/torch_drills.py``, which ``chip_smoke``
and the spawned ranks import) imports in a subprocess that blocks all of
them."""

import os
import pkgutil
import re
import subprocess
import sys

import glorie_slam_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "yaml", "cv2", "matplotlib", "msgpack",
           "PIL", "wandb", "glorie_slam_tpu")

_SCRIPT = r"""
import importlib, pkgutil, sys

BLOCKED = {blocked!r}

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import glorie_slam_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    glorie_slam_tpu_torch.__path__, "glorie_slam_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
sys.path.insert(0, {tests!r})
import torch_drills
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names))
"""


def _modules():
    return [m.name for m in pkgutil.walk_packages(
        glorie_slam_tpu_torch.__path__, "glorie_slam_tpu_torch.")]


def test_port_imports_without_jax_flax_yaml_or_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(blocked=BLOCKED,
                                          tests=os.path.join(ROOT, "tests"))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) == len(_modules()) >= 20


def test_port_sources_name_no_jax_import():
    """No port source imports JAX, flax or the JAX package anywhere, nor
    the optional libraries (PyYAML, ``cv2``, ``msgpack``, ...) at module
    level: those are imported inside the functions that use them."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|glorie_slam_tpu)\b"
                     r"|^(import|from)\s+(yaml|cv2|matplotlib|msgpack|PIL|"
                     r"wandb)\b", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tests", "torch_drills.py")]
    for base, _, names in os.walk(os.path.dirname(
            glorie_slam_tpu_torch.__file__)):
        files += [os.path.join(base, f) for f in names if f.endswith(".py")]
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path


def test_walk_covers_the_mapping_slice():
    """The import check above walks the mapper's modules too."""
    names = set(_modules())
    for mod in ("mapping.async_worker", "mapping.decoders",
                "mapping.import_pointslam", "mapping.mapper",
                "mapping.point_cloud", "mapping.renderer",
                "mapping.sampling", "nets.import_torch", "ops.knn"):
        assert f"glorie_slam_tpu_torch.{mod}" in names, mod


def test_walk_covers_the_prior_and_evaluations():
    """The import check walks the mono prior's and the evaluations'
    modules too (``cv2`` is imported only inside the PNG dump)."""
    names = set(_modules())
    for mod in ("mapping.dpt", "mapping.import_dpt", "mapping.mono_prior",
                "mapping.mesher", "utils.eval_recon", "utils.eval_render",
                "utils.generate_mesh", "utils.image_metrics"):
        assert f"glorie_slam_tpu_torch.{mod}" in names, mod
    path = os.path.join(os.path.dirname(glorie_slam_tpu_torch.__file__),
                        "utils", "eval_render.py")
    with open(path) as f:
        src = f.read()
    assert not re.search(r"^import cv2|^from cv2", src, re.M)


def test_walk_covers_the_entry_point():
    """The import check walks the entry point's modules too: the config
    loader, the CLI, the dataset readers, checkpoints and the visualizer
    (PyYAML, ``cv2`` and ``msgpack`` are imported where they are used)."""
    names = set(_modules())
    for mod in ("config", "cli", "utils.datasets", "utils.checkpoint",
                "utils.visualizer"):
        assert f"glorie_slam_tpu_torch.{mod}" in names, mod


def test_walk_covers_the_tools():
    """The import check walks the run tools too (the endurance run, the
    mapper-schedule run and the suite runner)."""
    names = set(_modules())
    for mod in ("tools.long_run_synthetic", "tools.mapper_schedule_run",
                "tools.run_suite"):
        assert f"glorie_slam_tpu_torch.{mod}" in names, mod


def test_walk_covers_the_edge_sharding():
    """The import check walks the edge group's modules too (the group and
    its collectives, the launcher, the sharded step)."""
    names = set(_modules())
    for mod in ("parallel", "parallel.mesh", "parallel.launch",
                "parallel.step"):
        assert f"glorie_slam_tpu_torch.{mod}" in names, mod
