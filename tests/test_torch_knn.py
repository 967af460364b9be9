"""Kernel F (the mapper's kNN, ``csrc/knn.cu``) on the CPU: it is built
into a library of its own, loaded only by a kNN search on the card, so
that the tracking path's kernels library keeps its three sources and its
digest;
the host's split of the points into ranges; and CPU tensors taking the
plain version. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``)."""

import os

import numpy as np
import pytest
import torch

from glorie_slam_tpu_torch import build
from glorie_slam_tpu_torch.ops import knn

TRACKING_SOURCES = ("lookup_pyramid.cu", "depth_agree.cu", "lookup_plane.cu")


@pytest.fixture
def fake_nvcc(monkeypatch):
    """Builds that record their commands instead of running them."""
    cmds = []
    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build, "_run_all", cmds.extend)
    return cmds


def _sources(cmd):
    return [os.path.basename(a) for a in cmd if a.endswith(".cu")]


def test_kernels_library_holds_only_the_tracking_sources(fake_nvcc, tmp_path):
    assert build.CUDA_SOURCES == TRACKING_SOURCES
    assert build.KNN_SOURCE == "knn.cu"
    build._build_kernels(str(tmp_path))
    compiled = [s for c in fake_nvcc for s in _sources(c)]
    assert compiled == list(TRACKING_SOURCES)


def test_knn_library_builds_only_its_source(fake_nvcc, tmp_path):
    so = build._build_knn(str(tmp_path))
    assert os.path.basename(so) == "libknn.so"
    assert len(fake_nvcc) == 1 and _sources(fake_nvcc[0]) == ["knn.cu"]
    assert "-shared" in fake_nvcc[0]
    assert tuple(a for a in fake_nvcc[0] if a in build.NVCC_FLAGS) == \
        build.NVCC_FLAGS


def test_each_library_loads_under_its_own_digest(monkeypatch):
    """The kernels library's digest covers the three tracking sources and
    the flags, as before kernel F existed; the kNN library's covers
    ``knn.cu`` alone."""
    built = {}
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(
        build, "_build_into",
        lambda name, digest, fn: built.setdefault(name, (digest, fn)) and name)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda so: so)
    assert build.kernels_library() == "kernels"
    assert build.knn_library() == "knn"
    path = [os.path.join(build.CSRC, s) for s in TRACKING_SOURCES]
    assert built["kernels"] == (build._digest(path, build.NVCC_FLAGS),
                                build._build_kernels)
    assert built["knn"] == (build._digest(
        [os.path.join(build.CSRC, "knn.cu")], build.NVCC_FLAGS),
        build._build_knn)


def test_tracking_library_and_cpu_search_load_no_knn_library(monkeypatch):
    """Loading the tracking kernels' library, and a kNN search on CPU
    tensors (the plain version), build and load nothing but that
    library."""
    built = []
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(
        build, "_build_into",
        lambda name, digest, fn: built.append(name) or name)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda so: so)
    assert build.kernels_library() == "kernels"
    D, I = knn.knn_search(torch.rand((10, 3)), torch.rand((8192, 3)), 100)
    assert D.shape == I.shape == (10, knn.NN_NUM)
    assert built == ["kernels"] and list(build._loaded) == ["kernels"]


@pytest.mark.parametrize("Q,n,ranges", [
    (204_800, 35_600, 1), (81_920, 35_600, 1), (150_000, 20_000, 1),
    (30_000, 35_600, 3), (7_000, 35_600, 10), (7_000, 1_048_576, 10),
    (3_000, 20_000, 9), (257, 40_000, 18), (500, 0, 1), (500, 2_000, 1),
    (1, 4_096, 2)])
def test_point_ranges_cover_the_points(Q, n, ranges):
    """The train step's calls fill the card alone; anchoring and small
    renders split the points into ranges of whole stages that cover them
    once, none empty, none under ``MIN_RANGE`` unless there is one."""
    got, span = knn.point_ranges(Q, n, 132)
    assert got == ranges
    if got == 1:
        assert span == n
        return
    assert span % knn.STAGE == 0 and span >= knn.MIN_RANGE
    assert (got - 1) * span < n <= got * span


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(5)
    pts = torch.from_numpy(rng.random((16384, 3), dtype=np.float32))
    q = torch.from_numpy(rng.random((300, 3), dtype=np.float32))
    before = knn.KNN.launches
    D, I = knn.knn_search(q, pts, 9000, k=8)
    n_scan, tile = knn.scan_slots(16384, 9000)
    assert (n_scan, tile) == (16384, 8192)
    Dp, Ip = knn.knn_plain(q, pts, 9000, 8, n_scan)
    assert torch.equal(D, Dp) and torch.equal(I, Ip)
    assert knn.KNN.launches == before
    assert int(I.max()) < 9000
