"""Edge sharding over ranks: one process per rank, ``torch.distributed``.

Counterpart of ``glorie_slam_tpu/parallel/mesh.py`` (``make_mesh``,
``edge_sharding``, ``replicated``, ``shard_edge_arrays``, ``replicate``)
and of the JAX package's ``tracking.mesh_devices`` switch
(``tracking/fused._active_mesh``). The JAX package shards the edge axis of
one program over a device mesh and lets GSPMD insert the reductions; here
each rank is a process that holds the whole SLAM state (poses,
disparities, the feature stores, the net's weights) and runs the per-edge
work of its own edges: the correlation lookup, the ConvGRU update and the
BA linearization.

Edges are split by **contiguous ranges of source frames** (``ii``), not by
edge index: rank r owns frames ``[bounds[r], bounds[r + 1])`` and every
edge whose ``ii`` lies there (``frame_bounds`` balances the edge counts).
With that split GraphAgg's per-frame mean, the per-frame depth blocks
``C``/``wz`` and the Schur grams of a frame all stay on one rank and
equal the one-rank values. The pose system is not summed across ranks as
partial sums: the ranks gather its small inputs (each edge's 6x6 blocks,
each frame's gram) and every rank assembles it with the one-rank code, in
the one-rank order, so that the result does not depend on the number of
ranks (the counterpart of the JAX package's ``utils/detsum.py``; on the
CPU it is bitwise the one-rank system). Per-frame rows (disparities,
scale/shift, damping, ``disps_up``) are gathered from their owners
(``gather_window``, ``gather_frame_rows``).

The group is built by ``init_edge_group``: NCCL when every rank has a card
of its own, gloo on the CPU or when the ranks share one card (the caller
asks for that). The choice is printed; nothing falls back silently. Every
collective has the group's timeout. ``group_for(cfg)`` returns the group
that ``tracking.mesh_devices`` asks for (None for 0 or 1) and raises when
no group of exactly that size is running, as ``_active_mesh`` raises on a
count it cannot meet.
"""

import datetime
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0

_ACTIVE = None


class EdgeGroup:
    """This process's rank in the edge group, and the group's collectives.

    ``bytes_received`` counts the payload bytes that reached this rank from
    the others (all-gathers and broadcasts), ``collectives`` the calls."""

    def __init__(self, rank, world, device, backend):
        self.rank = rank
        self.world = world
        self.device = torch.device(device)
        self.backend = backend
        self.bytes_received = 0
        self.collectives = 0

    def __repr__(self):
        return (f"EdgeGroup(rank={self.rank}, world={self.world}, "
                f"device={self.device}, backend={self.backend})")

    @property
    def comm_device(self):
        """gloo moves host tensors; NCCL moves the card's."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def reset_counters(self):
        self.bytes_received = 0
        self.collectives = 0

    def all_gather(self, x):
        """Every rank's ``x`` (same shape on all ranks), in rank order, on
        this rank's device."""
        xc = x.detach().to(self.comm_device).contiguous()
        parts = [torch.empty_like(xc) for _ in range(self.world)]
        dist.all_gather(parts, xc)
        self.collectives += 1
        self.bytes_received += xc.numel() * xc.element_size() * (
            self.world - 1)
        return [p.to(x.device) for p in parts]

    def gather_rows(self, x, sizes):
        """Each rank's rows: ``x`` is this rank's (sizes[rank], ...) rows;
        returns the list of every rank's rows, in rank order."""
        sizes = [int(s) for s in sizes]
        if x.shape[0] != sizes[self.rank]:
            raise ValueError(f"rank {self.rank} holds {x.shape[0]} rows, "
                             f"the partition says {sizes[self.rank]}")
        m = max(sizes)
        if m == 0:
            return [x[:0]] * self.world
        pad = x.new_zeros((m,) + tuple(x.shape[1:]))
        pad[:x.shape[0]] = x
        return [p[:s] for p, s in zip(self.all_gather(pad), sizes)]

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` (picklable) on every rank."""
        box = [obj]
        dist.broadcast_object_list(
            box, src=0,
            device=self.device if self.backend == "nccl" else None)
        self.collectives += 1
        if self.rank != 0:
            self.bytes_received += len(pickle.dumps(box[0]))
        return box[0]

    def broadcast_(self, x):
        """Overwrite ``x`` with rank 0's, in place."""
        xc = x.detach().to(self.comm_device).contiguous()
        dist.broadcast(xc, src=0)
        self.collectives += 1
        if self.rank != 0:
            self.bytes_received += xc.numel() * xc.element_size()
            x.copy_(xc.to(x.device))
        return x


def _choose(n, backend, device, shared_device, rank):
    """(backend, device) of rank ``rank`` in an n-rank group."""
    if device is not None and torch.device(device).type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} cannot run CPU ranks")
        return "gloo", torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("edge group: no CUDA device is available; pass "
                           "device='cpu' for CPU ranks")
    cards = torch.cuda.device_count()
    if shared_device:
        if backend not in (None, "gloo"):
            raise ValueError("ranks that share one card run gloo")
        return "gloo", torch.device("cuda", 0)
    if cards < n:
        raise RuntimeError(
            f"edge group: {n} ranks need {n} cards, {cards} visible; ask "
            "for shared-card ranks (gloo on cuda:0) explicitly")
    if backend not in (None, "nccl"):
        raise ValueError("ranks with a card each run NCCL")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return "nccl", torch.device("cuda", local)


def init_edge_group(n, backend=None, init_method=None,
                    timeout=DEFAULT_TIMEOUT_S, rank=None, device=None,
                    shared_device=False):
    """Join (or check) an ``n``-rank edge group and make it the active one.

    ``rank``/``init_method`` default to torchrun's environment (``RANK``,
    ``env://``). ``device="cpu"`` asks for CPU ranks (gloo);
    ``shared_device`` for ranks that share cuda:0 (gloo); otherwise rank r
    takes its own card (NCCL) and a machine with fewer than n cards
    raises. An already initialised default group must have n ranks."""
    global _ACTIVE
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise ValueError(f"a {dist.get_world_size()}-rank process group "
                             f"is running, {n} ranks were asked for")
        if _ACTIVE is not None:
            return _ACTIVE
        rank = dist.get_rank()
    if rank is None:
        if "RANK" not in os.environ:
            raise RuntimeError("init_edge_group: no rank given and no RANK "
                               "in the environment (torchrun sets it)")
        rank = int(os.environ["RANK"])
    backend, dev = _choose(n, backend, device, shared_device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=n, timeout=datetime.timedelta(seconds=timeout))
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the running group uses {dist.get_backend()}, "
                           f"these ranks need {backend}")
    _ACTIVE = EdgeGroup(rank, n, dev, backend)
    if rank == 0:
        print(f"[edge group] {n} ranks, backend {backend}, rank 0 on {dev}"
              + (" (ranks share the card)" if shared_device else ""),
              flush=True)
    return _ACTIVE


def destroy_edge_group():
    global _ACTIVE
    _ACTIVE = None
    if dist.is_initialized():
        dist.destroy_process_group()


def active_group():
    return _ACTIVE


def group_for(cfg):
    """The group ``tracking.mesh_devices`` asks for: None for 0 or 1, else
    the active group, which must have exactly that many ranks."""
    n = int(cfg.get("tracking", {}).get("mesh_devices", 0) or 0)
    if n <= 1:
        return None
    g = _ACTIVE
    if g is None or g.world != n:
        have = 1 if g is None else g.world
        raise ValueError(
            f"tracking.mesh_devices={n} but this process runs in a "
            f"{have}-rank group; start {n} ranks (parallel.launch, the "
            "CLI, or torchrun)")
    return g


def from_rank0(group, obj):
    """A host decision taken on rank 0 and followed by every rank (``obj``
    itself without a group)."""
    return obj if group is None else group.broadcast_object(obj)


# ---------------------------------------------------------------------------
# the partition: contiguous source-frame ranges
# ---------------------------------------------------------------------------


def frame_bounds(ii, world, n_frames, quantum=1):
    """(world + 1,) frame boundaries: rank r owns frames [b[r], b[r + 1]),
    ranges that cover [0, n_frames), start on multiples of ``quantum``
    and balance the edge counts of ``ii`` (host ints, -1 = padding)."""
    ii = np.asarray(ii, np.int64)
    ii = ii[ii >= 0]
    n_units = -(-n_frames // quantum)
    counts = np.bincount(ii // quantum, minlength=n_units)[:n_units]
    cum = np.cumsum(counts)
    total = cum[-1] if len(cum) else 0
    b = [0]
    for r in range(1, world):
        u = int(np.searchsorted(cum, total * r / world, side="left")) + 1
        b.append(max(b[-1], min(u * quantum, n_frames)))
    b.append(n_frames)
    return np.asarray(b, np.int64)


def edge_owner(ii, bounds):
    """Rank of each edge: the owner of its source frame (padding -> 0)."""
    ii = np.maximum(np.asarray(ii, np.int64), 0)
    return np.searchsorted(bounds, ii, side="right") - 1


def rank_edges(ii, bounds):
    """Edge indices of every rank, each ascending."""
    own = edge_owner(ii, bounds)
    return [np.where(own == r)[0] for r in range(len(bounds) - 1)]


def shard_edge_arrays(group, bounds, ii, *arrays):
    """This rank's rows of each per-edge array (leading dim = edges)."""
    sel = rank_edges(ii, bounds)[group.rank]
    idx = None
    out = []
    for a in arrays:
        if idx is None or idx.device != a.device:
            idx = torch.as_tensor(sel, device=a.device)
        out.append(a[idx])
    return tuple(out)


def replicate(group, *tensors):
    """Rank 0's values of each tensor on every rank (in place)."""
    return tuple(group.broadcast_(t) for t in tensors)


def window_rows(bounds, kbase, K):
    """Row ranges [lo, hi) of the window [kbase, kbase + K) that each rank
    owns, relative to kbase."""
    lo = np.clip(bounds[:-1], kbase, kbase + K) - kbase
    hi = np.clip(bounds[1:], kbase, kbase + K) - kbase
    return lo, hi


def gather_window(group, bounds, x, kbase):
    """x (K, ...): a window's rows starting at frame ``kbase``, right on
    this rank's frames -> every row from its owner, in order."""
    lo, hi = window_rows(bounds, kbase, x.shape[0])
    r = group.rank
    parts = group.gather_rows(x[lo[r]:hi[r]], hi - lo)
    return torch.cat(parts)


def gather_frame_rows(group, bounds, frames, x):
    """x (len(mine), ...): rows of this rank's frames among ``frames``
    (host ints, ascending, replicated) -> rows of all ``frames``."""
    frames = np.asarray(frames, np.int64)
    own = np.searchsorted(bounds, frames, side="right") - 1
    sizes = np.bincount(own, minlength=group.world)
    return torch.cat(group.gather_rows(x, sizes))
