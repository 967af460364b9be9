"""Radius-bounded k-nearest-neighbour search over a padded point cloud.

Counterpart of ``glorie_slam_tpu/ops/knn.py`` (the exact search that
replaces the reference's FAISS IVF index): squared distances
``|q|^2 + |p|^2 - 2 q.p`` with the cross term as one float32 matrix product,
points at or past the valid count at ``BIG``, and the k smallest per query,
ascending, equal distances by index, lowest first, as ``lax.top_k`` orders
them. The same formula rounded the same way gives the JAX package's
distances bitwise on the CPU: the product equals its ``Precision.HIGHEST``
dot, and the squared norms are summed as XLA fuses them, a chain of fused
multiply-adds (``sq_norm``).

The product must stay float32: the radius dedupe compares distances against
r^2 ~ 1e-3, which TF32's 10-bit mantissa would corrupt. ``knn_search``
raises on a CUDA tensor when TF32 matmuls are allowed (``device.py`` turns
them off).

The JAX search scans the whole capacity tile by tile; this one scans only
the first ``ceil(count / tile)`` tiles, which holds every valid point, so
the top-k is the same. Queries go through in chunks that bound the
distance matrix to ``CHUNK_ELEMS`` values.

``torch.topk`` documents no order for equal values, and the CPU and CUDA
versions pick different ones among exact ties (duplicated anchors lie at
the same distance). So ``topk`` only fixes the k-th smallest distance t
and the points below it; the points at t are then taken lowest index
first: a running count of the row's points at t, searched for 1..k, gives
the index of each in turn.

That is the plain version (``knn_plain``), which CPU tensors take. CUDA
tensors launch kernel F (``csrc/knn.cu``, its own library,
``build.knn_library``) or raise: one thread a query, the distances by the
same formula and roundings and a running top-k in registers, with no
distance matrix. When the queries alone cannot fill the card, the valid
points are split into ranges and a second pass merges the ranges' lists
(``point_ranges``). ``KNN.launches`` counts its launches.
"""

import ctypes
from dataclasses import dataclass

import torch

from .. import build
from ..utils.phase_timer import count, sync, traced

NN_NUM = 8
BIG = 1e12
TILE = 8192
CHUNK_ELEMS = 1 << 27            # query-by-point distances held at once
# kernel F's constants, checked against the library's when it loads
MAX_K = 16                       # largest k instantiated
STAGE = 256                      # points a shared-memory stage
# the point split: ranges while the queries give an SM fewer than
# FILL_THREADS threads, each of at least MIN_RANGE points
FILL_THREADS = 512
MIN_RANGE = 2048


@dataclass
class Kernel:
    """A hand-written kernel: its name, source, the TPU kernel it replaces
    and its launches (the fields of the tracking kernels' records)."""
    name: str
    source: str
    replaces: str
    launches: int = 0


KNN = Kernel("knn", "glorie_slam_tpu_torch/csrc/knn.cu",
             "none: the JAX package's kNN (glorie_slam_tpu/ops/knn.py) is "
             "XLA, with no Pallas kernel")


def sq_norm(x):
    """|x|^2 over the last axis (size 3) of float32 x, rounded as a chain
    of fused multiply-adds x2*x2 + (x1*x1 + x0*x0): each product is exact
    in float64, and the sum is rounded to float32 once per step."""
    acc = x[..., 0] * x[..., 0]
    for c in range(1, x.shape[-1]):
        xc = x[..., c].double()
        acc = (xc * xc + acc.double()).float()
    return acc


def scan_slots(P, n_valid, tile=TILE):
    """(n_scan, tile): the first ``ceil(n_valid / tile)`` tiles (at least
    one) of a capacity of ``P`` slots, the tile cut to ``P``."""
    tile = min(tile, P)
    if P % tile != 0:
        raise ValueError(f"point capacity {P} must be a multiple of the "
                         f"tile size {tile}")
    return min(P, max(1, -(-n_valid // tile)) * tile), tile


@traced("knn.search")
def knn_search(queries, points, n_valid, k: int = NN_NUM, tile: int = TILE):
    """queries (Q, 3); points (P_cap, 3) padded cloud; n_valid: host count.

    Returns (D (Q, k) squared distances ascending, I (Q, k) int64 indices);
    slots past the valid points read ``BIG`` (their indices are arbitrary
    in-range slots, so callers' radius tests exclude them). Counter
    ``knn.tiles`` adds the tiles scanned."""
    if queries.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("knn_search needs float32 matmuls; TF32 is on "
                           "(glorie_slam_tpu_torch.device."
                           "set_float32_precision turns it off)")
    n_valid = int(n_valid)
    n_scan, tile = scan_slots(points.shape[0], n_valid, tile)
    count("knn.tiles", n_scan // tile)
    if queries.is_cuda:
        return _knn_cuda(queries, points, n_valid, k, n_scan)
    return knn_plain(queries, points, n_valid, k, n_scan)


def knn_plain(queries, points, n_valid, k, n_scan):
    """Plain PyTorch version of ``knn_search`` over the first ``n_scan``
    slots (a whole number of tiles holding the ``n_valid`` points)."""
    pts = points[:n_scan].float()
    p2 = sq_norm(pts)
    invalid = torch.arange(n_scan, device=pts.device) >= n_valid
    queries = queries.float()
    q2 = sq_norm(queries)[:, None]
    step = max(1, CHUNK_ELEMS // n_scan)
    nth = torch.arange(1, k + 1, dtype=torch.int32, device=pts.device)
    Ds, Is = [], []
    for s in range(0, queries.shape[0], step):
        cross = queries[s:s + step] @ pts.T
        d = q2[s:s + step] + p2[None, :] - 2.0 * cross
        d.masked_fill_(invalid[None, :], BIG)
        D0, I0 = torch.topk(d, k, dim=1, largest=False, sorted=True)
        t = D0[:, -1:]
        below = D0 < t
        # the j-th point at t, for j = 1..k: where the count reaches j
        at_t = torch.cumsum(d == t, dim=1, dtype=torch.int32)
        nth_at_t = torch.searchsorted(at_t,
                                      nth.expand(len(d), k).contiguous())
        fill = nth[None, :] <= k - below.sum(1, keepdim=True)
        cand_i = torch.cat([I0, nth_at_t.clamp_max(n_scan - 1)], 1)
        cand_d = torch.cat([D0, t.expand(-1, k)], 1).masked_fill(
            ~torch.cat([below, fill], 1), float("inf"))
        # k taken: by distance, equal ones by index
        cand_i, order = torch.sort(cand_i, dim=1, stable=True)
        cand_d, order2 = torch.sort(torch.gather(cand_d, 1, order), dim=1,
                                    stable=True)
        Ds.append(cand_d[:, :k])
        Is.append(torch.gather(cand_i, 1, order2[:, :k]))
    if not Ds:
        return (queries.new_zeros((0, k)),
                torch.zeros((0, k), dtype=torch.long, device=queries.device))
    return torch.cat(Ds), torch.cat(Is)


def _lib():
    lib = build.knn_library()
    if not getattr(lib, "_glorie_typed", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.glorie_knn.restype = i32
        lib.glorie_knn.argtypes = [vp, vp] + [i32] * 6 + [vp] * 5
        lib.glorie_knn_geometry.restype = None
        lib.glorie_knn_geometry.argtypes = [ctypes.POINTER(i32)]
        geometry = (i32 * 2)()
        lib.glorie_knn_geometry(geometry)
        if tuple(geometry) != (MAX_K, STAGE):
            raise RuntimeError(f"knn: MAX_K, STAGE {(MAX_K, STAGE)} differ "
                               f"from kernel F's {tuple(geometry)}")
        lib._glorie_typed = True
    return lib


def point_ranges(n_queries, n_points, sms):
    """(ranges, span): kernel F's split of ``n_points`` valid points for
    ``n_queries`` queries on a card of ``sms`` SMs. One range while the
    queries alone give every SM ``FILL_THREADS`` threads; else as many
    ranges as make up the shortfall, each a whole number of stages and at
    least ``MIN_RANGE`` points."""
    want = -(-sms * FILL_THREADS // max(n_queries, 1))
    ranges = max(1, min(want, n_points // MIN_RANGE))
    if ranges == 1:
        return 1, n_points
    span = -(-n_points // ranges)
    span = -(-span // STAGE) * STAGE
    return -(-n_points // span), span


def _knn_cuda(queries, points, n_valid, k, n_scan):
    dev = queries.device
    if points.device != dev:
        raise ValueError("knn_search: queries and points on different "
                         "devices")
    if queries.dim() != 2 or queries.shape[1] != 3 or points.shape[1] != 3:
        raise ValueError("knn_search: queries and points must be (n, 3)")
    if not 1 <= k <= min(MAX_K, n_scan):
        raise ValueError(f"knn_search: k = {k} outside 1..{MAX_K} or past "
                         f"the {n_scan} slots scanned")
    Q = queries.shape[0]
    D = torch.empty((Q, k), dtype=torch.float32, device=dev)
    I = torch.empty((Q, k), dtype=torch.long, device=dev)
    if Q == 0:
        return D, I
    q = queries.float().contiguous()
    pts = points[:n_scan].float()
    packed = torch.cat([pts, sq_norm(pts)[:, None]], 1)    # (x, y, z, p2)
    n_pts = min(max(n_valid, 0), n_scan)
    ranges, span = point_ranges(
        Q, n_pts, torch.cuda.get_device_properties(dev).multi_processor_count)
    part_d = part_i = None
    if ranges > 1:
        part_d = torch.empty((ranges, Q, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((ranges, Q, k), dtype=torch.int32, device=dev)
    err = _lib().glorie_knn(
        q.data_ptr(), packed.data_ptr(), Q, n_pts, n_scan, k, ranges, span,
        None if part_d is None else part_d.data_ptr(),
        None if part_i is None else part_i.data_ptr(), D.data_ptr(),
        I.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"knn_search: CUDA error {err}")
    KNN.launches += 1 if ranges == 1 else 2
    return D, I


def neighbor_count(D, radius):
    """Neighbours within ``radius`` (a number or a per-query (Q,) tensor),
    comparing squared distances as FAISS does -> (Q,) int32. The square
    is taken in float32, as in the JAX package."""
    if torch.is_tensor(radius):
        r = torch.as_tensor(radius, dtype=torch.float32, device=D.device)
    else:
        with sync("number_upload"):
            r = torch.as_tensor(radius, dtype=torch.float32, device=D.device)
    r2 = r[:, None] ** 2 if r.dim() > 0 else r * r
    return torch.sum(D < r2, dim=-1).to(torch.int32)
