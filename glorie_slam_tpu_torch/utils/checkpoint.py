"""Mid-run SLAM-state checkpoints, in the JAX package's ``.npz`` layout.

Counterpart of ``glorie_slam_tpu/utils/checkpoint.py``: the whole live
tracking state (the ``DepthVideo`` buffers, the frontend's factor graph with
its inactive pool, the motion filter's last keyframe features and the
tracker's cadence counters) and optionally the mapper's (the neural point
cloud and the decoder parameters) go into one ``np.savez_compressed`` file
(written to ``.tmp`` and moved over the old one), from which
``Tracker.run(stream, start=<returned index>)`` continues as the
uninterrupted run would. The layout is the JAX package's, so a JAX-written
``state.npz`` resumes here and a port-written one loads in
``glorie_slam_tpu.utils.checkpoint.load_checkpoint``:

- the same keys (``video.*``, ``videonp.*``, ``graph.*``, ``graphnp.*``,
  ``mf.*``, ``npc.*``, ``mapper.dec_params``, ``__meta__``), dtypes and JSON
  meta fields; bfloat16 tensors are stored as their uint16 bits under
  ``<key>::bf16`` (through ``tensor.view(torch.int16)``: no numpy bf16);
- the JAX factor graph keeps its edge rows in buffers of capacity ``cap``
  (active) and ``pool_cap`` (inactive) that only grow (``bucket`` for the
  first, 8, 128 and then powers of two for the second); the port keeps one
  row per edge, so it writes its rows zero-padded to the smallest
  capacities JAX could hold and reads the live rows back;
- ``video.corr_flat``, the JAX package's level-0 lookup store (``fmaps``
  flattened and zero-padded to ``padded_npix`` pixels), is written from
  ``fmaps`` and, on load, checked against them; ``corr_p1..3`` are the
  port's ``corr_p[0..2]``; ``video.zeros`` (the RGB-D slot) is zeros;
- the motion filter's features are NHWC in the file, NCHW in the port;
- ``mapper.dec_params`` is ``flax.serialization.to_bytes`` of the decoder
  tree (``tree_to_bytes``, through ``msgpack``, imported where it is used);
- ``npc.key`` is the JAX package's PRNG key. The port draws new point
  features from a ``torch.Generator``: its state is written under
  ``port.npc.generator`` and the key is carried through unchanged when it
  came from a file (else ``PRNGKey(seed)``, ``[0, seed]``, is written). A
  JAX-written file seeds the generator from the key, so the draws after
  such a resume differ from the JAX package's (as every port run's do).

State that only the port needs for an exact resume of the mapper goes
under ``port.`` keys and ``__meta__["port"]``, which the JAX loader does
not read: the mapper's keyframe list (its images and radius maps are read
back from the stream), its current radius maps, its sampling generator,
its loss history and ``init``.
"""

import json
import os

import numpy as np
import torch

from ..mapping import sampling
from ..nets.import_flax import (decoder_params_to_state_dict,
                                state_dict_to_decoder_params)
from .buckets import bucket

_VIDEO_ARRAYS = (
    "timestamp", "images", "poses", "disps", "disps_up", "intrinsics",
    "mono_disps", "depth_scale", "depth_shift", "_valid_depth_mask",
    "valid_depth_mask_small", "fmaps", "nets", "inps")
_VIDEO_NP = ("dirty", "npc_dirty")
_GRAPH_ROWS = ("net", "inp", "target", "weight")
_GRAPH_POOL = ("target_inac", "weight_inac")
_GRAPH_NP = ("ii", "jj", "age", "ii_inac", "jj_inac", "ii_bad", "jj_bad")
_NPC_ARRAYS = ("cloud_pos", "geo_feats", "col_feats", "input_pos",
               "input_rgb", "input_depth", "input_video_idx", "input_i",
               "input_j", "full_pcl", "full_mask")


def tree_to_bytes(tree):
    """``flax.serialization.to_bytes`` of a tree of dicts with str keys
    and numpy array leaves: msgpack maps, each array an ext value of type
    1 holding ``[shape, dtype name, raw C-order bytes]``."""
    import msgpack

    def ext(x):
        if not isinstance(x, np.ndarray):
            raise TypeError(f"cannot serialise {type(x).__name__}")
        return msgpack.ExtType(1, msgpack.packb(
            (x.shape, x.dtype.name, x.tobytes("C")), use_bin_type=True))

    return msgpack.packb(tree, default=ext, strict_types=True)


def tree_from_bytes(blob):
    """The tree ``tree_to_bytes`` (or flax) encoded, arrays as numpy."""
    import msgpack

    def ext(code, data):
        if code != 1:
            raise ValueError(f"msgpack ext type {code} is not an array")
        shape, name, buf = msgpack.unpackb(data, raw=True)
        return np.frombuffer(buf, np.dtype(name.decode())).reshape(
            shape).copy()

    return msgpack.unpackb(blob, ext_hook=ext, raw=False)


def padded_npix(npix):
    """The JAX package's level-0 store width (``ops/corr.padded_npix`` at
    its default widest tile, 512): npix padded to a multiple of 512 or 256
    where that adds at most 20%, else of 128."""
    for m in (512, 256):
        pad = (-npix) % m
        if pad <= 0.2 * npix:
            return npix + pad
    return npix + (-npix) % 128


def graph_capacities(E, n_inac):
    """The smallest active and inactive capacities the JAX factor graph
    can hold E and n_inac edges in."""
    pool = 8 if n_inac <= 8 else (128 if n_inac <= 128
                                  else 1 << (n_inac - 1).bit_length())
    return max(bucket(E), 8), pool


def _put(arrs, key, x):
    """Store a tensor or array; bfloat16 as uint16 bits under key::bf16."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            arrs[f"{key}::bf16"] = x.view(torch.int16).cpu().numpy().view(
                np.uint16)
            return
        x = x.cpu().numpy()
    arrs[key] = np.asarray(x)


def _get(data, key, device):
    """A stored array as a tensor on ``device`` (bfloat16 from ::bf16)."""
    if key in data:
        return torch.from_numpy(np.array(data[key])).to(device)
    bits = np.array(data[f"{key}::bf16"]).view(np.int16)
    return torch.from_numpy(bits).view(torch.bfloat16).to(device)


def _padded(x, rows):
    pad = rows - x.shape[0]
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))]) \
        if pad else x


def save_checkpoint(path, tracker, next_frame, mapper=None):
    """Snapshot the live tracking (and, given ``mapper``, mapping) state.

    Call between frames, after a keyframe's frontend update;
    ``next_frame`` is the stream index a resumed run processes first
    (``Tracker.run(stream, start=...)``)."""
    video = tracker.video
    fe = tracker.frontend
    g = fe.graph
    mf = tracker.motion_filter

    arrs = {}
    for n in _VIDEO_ARRAYS:
        _put(arrs, f"video.{n}", getattr(video, n))
    _put(arrs, "video.zeros", np.zeros(tuple(video.disps.shape), np.float32))
    npix = video.h8 * video.w8
    flat = video.fmaps.reshape(video.buffer, npix, 128)
    pad = flat.new_zeros((video.buffer, padded_npix(npix) - npix, 128))
    _put(arrs, "video.corr_flat", torch.cat([flat, pad], 1))
    for k, store in enumerate(video.corr_p):
        _put(arrs, f"video.corr_p{k + 1}", store)
    for n in _VIDEO_NP:
        arrs[f"videonp.{n}"] = np.asarray(getattr(video, n))

    E, n_inac = len(g.ii), len(g.ii_inac)
    cap, pool_cap = graph_capacities(E, n_inac)
    for n in _GRAPH_ROWS:
        _put(arrs, f"graph.{n}", _padded(getattr(g, n), cap))
    for n in _GRAPH_POOL:
        _put(arrs, f"graph.{n}", _padded(getattr(g, n), pool_cap))
    _put(arrs, "graph.damping", g.damping)
    for n in _GRAPH_NP:
        arrs[f"graphnp.{n}"] = np.asarray(getattr(g, n), np.int64)
    if mf.fmap is not None:
        for n in ("fmap", "net", "inp"):
            _put(arrs, f"mf.{n}", getattr(mf, n).permute(0, 2, 3, 1))

    meta = {
        "next_frame": int(next_frame),
        "video": {"counter": int(video.counter),
                  "intr_set": bool(getattr(video, "_intr_set", False))},
        "frontend": {"t1": int(fe.t1),
                     "is_initialized": bool(fe.is_initialized),
                     "last_loop_t": int(fe.last_loop_t)},
        "graph": {"E": E, "cap": cap, "pool_cap": pool_cap},
        "mf": {"count": int(mf.count), "has_state": mf.fmap is not None},
        # the value the tracker holds once the step that saves ends (the
        # save runs inside it, before ``prev_kf_idx`` moves on)
        "tracker": {"prev_kf_idx": int(video.counter) - 1,
                    "prev_ba_idx": int(tracker.prev_ba_idx),
                    "number_of_kf": int(tracker.number_of_kf)},
        "has_mapper": mapper is not None,
    }
    if mapper is not None:
        npc = mapper.npc
        for n in _NPC_ARRAYS:
            _put(arrs, f"npc.{n}", getattr(npc, n))
        key = npc.key if npc.key is not None else np.array(
            [0, npc.seed & 0xFFFFFFFF], np.uint32)
        arrs["npc.key"] = np.asarray(key, np.uint32)
        arrs["port.npc.generator"] = npc.generator.get_state().numpy()
        meta["npc"] = {"count": int(npc.count),
                       "count_in": int(npc.count_in)}
        blob = tree_to_bytes(state_dict_to_decoder_params(
            mapper.decoders.state_dict()))
        arrs["mapper.dec_params"] = np.frombuffer(blob, np.uint8)
        meta["port"] = {"mapper": _mapper_meta(mapper, arrs)}

    arrs["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrs)
    os.replace(tmp, path)


def _mapper_meta(mapper, arrs):
    """The mapper's port-only state: JSON fields, radius maps into arrs."""
    for n in ("dynamic_r_add", "dynamic_r_query"):
        val = getattr(mapper, n)
        if val is not None:
            arrs[f"port.mapper.{n}"] = np.asarray(val)
    return {
        "init": bool(mapper.init),
        "mapping_window_size": int(mapper.mapping_window_size),
        "keyframes": [[int(k["idx"]), int(k["video_idx"])]
                      for k in mapper.keyframe_dict],
        "r_query_idx": [int(i) for i in mapper.r_query_store],
        "loss_history": mapper.loss_history,
        "rng": mapper.rng.bit_generator.state,
    }


def _restore_mapper(mapper, pm, data):
    """Rebuild the mapper's port-only state; keyframe images, depths,
    priors and radius maps are read back from the stream."""
    mapper.init = pm["init"]
    mapper.mapping_window_size = pm["mapping_window_size"]
    mapper.loss_history = list(pm["loss_history"])
    mapper.rng.bit_generator.state = pm["rng"]
    for n in ("dynamic_r_add", "dynamic_r_query"):
        key = f"port.mapper.{n}"
        setattr(mapper, n, np.array(data[key]) if key in data else None)
    mapper.keyframe_dict, mapper.keyframe_list = [], []
    for idx, video_idx in pm["keyframes"]:
        _, color, gt_depth, _ = mapper.frame_reader[idx]
        mono = mapper._load_mono(idx)
        mapper.keyframe_list.append(idx)
        mapper.keyframe_dict.append({
            "idx": idx, "video_idx": video_idx, "color": np.asarray(color),
            "mono_depth": None if mono is None else np.asarray(mono),
            "gt_depth": None if gt_depth is None else np.asarray(gt_depth)})
    mapper.r_query_store = {}
    for idx in pm["r_query_idx"]:
        color = mapper.frame_reader[idx][1]
        mapper.r_query_store[idx] = sampling.dynamic_radius_maps(
            color, mapper.cfg)[1]


def _copy_into(dst, src, name):
    if tuple(dst.shape) != tuple(src.shape):
        raise ValueError(f"checkpoint {name}: shape {tuple(src.shape)} does "
                         f"not fit {tuple(dst.shape)} (another config?)")
    dst.copy_(src.to(dst.dtype))


def load_checkpoint(path, tracker, mapper=None):
    """Restore a checkpoint (the port's or the JAX package's) into a fresh
    tracker (and mapper) built from the same config. Returns the stream
    index to resume from."""
    data = np.load(path)
    meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
    video = tracker.video
    dev = video.device
    fe = tracker.frontend
    g = fe.graph
    mf = tracker.motion_filter

    for n in _VIDEO_ARRAYS:
        _copy_into(getattr(video, n), _get(data, f"video.{n}", dev),
                   f"video.{n}")
    for k, store in enumerate(video.corr_p):
        _copy_into(store, _get(data, f"video.corr_p{k + 1}", dev),
                   f"video.corr_p{k + 1}")
    flat = _get(data, "video.corr_flat", dev)
    npix = video.h8 * video.w8
    want = video.fmaps.reshape(video.buffer, npix, 128)
    if (flat.shape[1] < npix or not torch.equal(flat[:, :npix], want)
            or torch.count_nonzero(flat[:, npix:])):
        raise ValueError("checkpoint video.corr_flat disagrees with "
                         "video.fmaps")
    for n in _VIDEO_NP:
        getattr(video, n)[:] = data[f"videonp.{n}"]
    video.counter = meta["video"]["counter"]
    video._intr_set = meta["video"]["intr_set"]

    for n in _GRAPH_NP:
        setattr(g, n, np.array(data[f"graphnp.{n}"], np.int64))
    E, n_inac = meta["graph"]["E"], len(g.ii_inac)
    if E != len(g.ii):
        raise ValueError("checkpoint graph: E disagrees with graphnp.ii")
    for n in _GRAPH_ROWS:
        setattr(g, n, _get(data, f"graph.{n}", dev)[:E].contiguous())
    for n in _GRAPH_POOL:
        setattr(g, n, _get(data, f"graph.{n}", dev)[:n_inac].contiguous())
    _copy_into(g.damping, _get(data, "graph.damping", dev), "graph.damping")

    fe.t1 = meta["frontend"]["t1"]
    fe.is_initialized = meta["frontend"]["is_initialized"]
    fe.last_loop_t = meta["frontend"]["last_loop_t"]
    mf.count = meta["mf"]["count"]
    mf._pending = None
    if meta["mf"]["has_state"]:
        for n in ("fmap", "net", "inp"):
            setattr(mf, n, _get(data, f"mf.{n}", dev).permute(
                0, 3, 1, 2).contiguous())
    # not the file's value: the JAX package saves inside the keyframe's
    # step, before ``prev_kf_idx`` moves on to it, so a JAX-written file
    # holds the keyframe before, and the next frame would count that
    # keyframe again
    tracker.prev_kf_idx = video.counter - 1
    tracker.prev_ba_idx = meta["tracker"]["prev_ba_idx"]
    tracker.number_of_kf = meta["tracker"]["number_of_kf"]

    if mapper is not None and meta.get("has_mapper"):
        npc = mapper.npc
        arrays = {n: _get(data, f"npc.{n}", "cpu").float().numpy()
                  if n == "full_pcl" else np.array(data[f"npc.{n}"])
                  for n in _NPC_ARRAYS}
        arrays.update(meta["npc"])
        npc.load_arrays(arrays)
        npc.key = np.array(data["npc.key"], np.uint32)
        if "port.npc.generator" in data:
            npc.generator.set_state(torch.from_numpy(
                np.array(data["port.npc.generator"])))
        else:
            npc.generator.manual_seed((int(npc.key[0]) << 32)
                                      | int(npc.key[1]))
        params = tree_from_bytes(data["mapper.dec_params"].tobytes())
        state = decoder_params_to_state_dict(params)
        mapper.decoders.load_state_dict(
            {k: v.to(dev) for k, v in state.items()})
        pm = meta.get("port", {}).get("mapper")
        if pm is not None:
            _restore_mapper(mapper, pm, data)
    return meta["next_frame"]
