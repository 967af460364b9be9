"""Host C++ edge proposal for the factor graph, loaded through ctypes.

Counterpart of ``glorie_slam_tpu/native``: the greedy distance-sorted NMS
proposals (frontend and backend/loop) run in ``proximity.cpp``, this
package's own copy, built with ``g++`` at first use (``build.py``). There
is no Python fallback: a failed build raises.
"""

import ctypes

import numpy as np

from .. import build

_i64 = ctypes.c_int64
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def _lib():
    lib = build.proximity_library()
    if not getattr(lib, "_glorie_typed", False):
        lib.proximity_edges.restype = _i64
        lib.proximity_edges.argtypes = [
            _f32p, _i64, _i64, _i64, _i64, _i64, ctypes.c_float, _i64,
            _i64p, _i64p, _i64, _i64p, _i64p, _i64]
        lib.backend_proximity_edges.restype = _i64
        lib.backend_proximity_edges.argtypes = [
            _f32p, _f32p, _i64, _i64, _i64, _i64, _i64, ctypes.c_float,
            _i64, _i64, _i64p, _i64p, _i64]
        lib._glorie_typed = True
    return lib


def proximity_edges(d, t0, t1, t, rad, nms, thresh, max_factors,
                    exist_ii, exist_jj):
    """Frontend edge proposal -> (ii, jj)."""
    d = np.ascontiguousarray(d, np.float32)
    exist_ii = np.ascontiguousarray(exist_ii, np.int64)
    exist_jj = np.ascontiguousarray(exist_jj, np.int64)
    cap = max(4 * (max_factors if max_factors > 0 else d.size) + 16,
              8 * (t - max(t0, 0) + 1) * (rad + 2))
    out_ii = np.empty(cap, np.int64)
    out_jj = np.empty(cap, np.int64)
    n = _lib().proximity_edges(
        d, t0, t1, t, rad, nms, float(thresh), max_factors,
        exist_ii, exist_jj, len(exist_ii), out_ii, out_jj, cap)
    return out_ii[:n], out_jj[:n]


def backend_proximity_edges(d, rawd, t_start, t_end, t_start_loop, nms,
                            radius, thresh, max_factors, loop):
    """Backend/loop edge proposal -> (ii, jj); empty when a loop run finds
    no loop edge."""
    d = np.ascontiguousarray(d, np.float32)
    rawd = np.ascontiguousarray(rawd, np.float32)
    cap = max(4 * max_factors + 64, 8 * (t_end + 1) * (radius + 2))
    out_ii = np.empty(cap, np.int64)
    out_jj = np.empty(cap, np.int64)
    n = _lib().backend_proximity_edges(
        d, rawd, t_start, t_end, t_start_loop, nms, radius, float(thresh),
        max_factors, 1 if loop else 0, out_ii, out_jj, cap)
    if n < 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return out_ii[:n], out_jj[:n]
