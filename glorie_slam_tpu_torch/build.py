"""Build native code at first use into ``glorie_slam_tpu_torch/_build/``.

Three libraries, each with a plain C interface loaded through ``ctypes``:

* ``kernels``: the tracking path's CUDA kernels (``CUDA_SOURCES``). Each
  source is compiled by its own ``nvcc`` process (all started together)
  for ``sm_90a``, then the objects are linked into one shared library;
* ``knn``: the mapper's kNN kernel, ``csrc/knn.cu``, a library of its own,
  so that the tracking path never builds or loads it;
* ``proximity``: the host C++ edge proposal in ``native/proximity.cpp``,
  compiled with ``g++``.

The output directory is keyed by a hash of the sources and the flags, so a
second run reuses the build and an edited source rebuilds. ``_build/`` is
listed in ``.gitignore``. Nothing is compiled when the package is imported.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_ROOT = os.path.join(PKG_DIR, "_build")
CSRC = os.path.join(PKG_DIR, "csrc")
CUDA_SOURCES = ("lookup_pyramid.cu", "depth_agree.cu", "lookup_plane.cu")
KNN_SOURCE = "knn.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_loaded = {}


def _digest(paths, flags):
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _run_all(cmds):
    """Start every command at once; raise with the compiler's output if any
    of them fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for c in cmds]
    outs = [p.communicate()[0].decode(errors="replace") for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"build failed: {' '.join(cmd)}\n{out}")


def _build_into(name, digest, build_fn):
    """Run ``build_fn(tmpdir) -> so path`` unless ``_build/<name>-<digest>``
    already holds the library; the finished library is moved into place
    atomically."""
    out_dir = os.path.join(BUILD_ROOT, f"{name}-{digest}")
    so = os.path.join(out_dir, f"lib{name}.so")
    if os.path.isfile(so):
        return so
    os.makedirs(BUILD_ROOT, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f"{name}-", dir=BUILD_ROOT)
    try:
        built = build_fn(tmp)
        os.makedirs(out_dir, exist_ok=True)
        os.replace(built, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


def _build_kernels(tmp):
    nvcc = find_nvcc()
    objs = []
    cmds = []
    for src in CUDA_SOURCES:
        obj = os.path.join(tmp, src.replace(".cu", ".o"))
        objs.append(obj)
        cmds.append([nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, src),
                     "-o", obj])
    _run_all(cmds)
    so = os.path.join(tmp, "libkernels.so")
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", so]])
    return so


def _build_knn(tmp):
    so = os.path.join(tmp, "libknn.so")
    _run_all([[find_nvcc(), *NVCC_FLAGS, "-shared",
               os.path.join(CSRC, KNN_SOURCE), "-o", so]])
    return so


def _build_proximity(tmp):
    so = os.path.join(tmp, "libproximity.so")
    src = os.path.join(PKG_DIR, "native", "proximity.cpp")
    _run_all([["g++", *GXX_FLAGS, src, "-o", so]])
    return so


def _load(name, sources, flags, build_fn):
    with _lock:
        if name not in _loaded:
            so = _build_into(name, _digest(sources, flags), build_fn)
            _loaded[name] = ctypes.CDLL(so)
        return _loaded[name]


def kernels_library():
    """The CUDA kernels' shared library (built on first call)."""
    return _load("kernels", [os.path.join(CSRC, s) for s in CUDA_SOURCES],
                 NVCC_FLAGS, _build_kernels)


def knn_library():
    """The mapper's kNN kernel's shared library (built on first call)."""
    return _load("knn", [os.path.join(CSRC, KNN_SOURCE)], NVCC_FLAGS,
                 _build_knn)


def proximity_library():
    """The host proximity library (built on first call)."""
    return _load("proximity",
                 [os.path.join(PKG_DIR, "native", "proximity.cpp")],
                 GXX_FLAGS, _build_proximity)
