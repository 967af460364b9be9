"""The port runs where JAX, flax, PyYAML and the JAX package are absent
(the card's machine has none of the first three, and the port must not
lean on the fourth): every module of ``glorie_slam_tpu_torch`` and
``chip_smoke`` import in a subprocess that blocks them."""

import os
import pkgutil
import re
import subprocess
import sys

import glorie_slam_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "yaml", "glorie_slam_tpu")

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
        [sys.executable, "-c", _SCRIPT.format(blocked=BLOCKED)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) == len(_modules()) >= 20


def test_port_sources_name_no_jax_import():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|yaml|glorie_slam_tpu)\b",
                     re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
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
