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
"""

import torch

NN_NUM = 8
BIG = 1e12
TILE = 8192
CHUNK_ELEMS = 1 << 27            # query-by-point distances held at once


def sq_norm(x):
    """|x|^2 over the last axis (size 3) of float32 x, rounded as a chain
    of fused multiply-adds x2*x2 + (x1*x1 + x0*x0): each product is exact
    in float64, and the sum is rounded to float32 once per step."""
    acc = x[..., 0] * x[..., 0]
    for c in range(1, x.shape[-1]):
        xc = x[..., c].double()
        acc = (xc * xc + acc.double()).float()
    return acc


def knn_search(queries, points, n_valid, k: int = NN_NUM, tile: int = TILE):
    """queries (Q, 3); points (P_cap, 3) padded cloud; n_valid: host count.

    Returns (D (Q, k) squared distances ascending, I (Q, k) int64 indices);
    slots past the valid points read ``BIG`` (their indices are arbitrary
    in-range slots, so callers' radius tests exclude them)."""
    if queries.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("knn_search needs float32 matmuls; TF32 is on "
                           "(glorie_slam_tpu_torch.device."
                           "set_float32_precision turns it off)")
    P = points.shape[0]
    tile = min(tile, P)
    if P % tile != 0:
        raise ValueError(f"point capacity {P} must be a multiple of the "
                         f"tile size {tile}")
    n_valid = int(n_valid)
    n_scan = min(P, max(1, -(-n_valid // tile)) * tile)
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


def neighbor_count(D, radius):
    """Neighbours within ``radius`` (a number or a per-query (Q,) tensor),
    comparing squared distances as FAISS does -> (Q,) int32. The square
    is taken in float32, as in the JAX package."""
    r = torch.as_tensor(radius, dtype=torch.float32, device=D.device)
    r2 = r[:, None] ** 2 if r.dim() > 0 else r * r
    return torch.sum(D < r2, dim=-1).to(torch.int32)
