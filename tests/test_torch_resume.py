"""Mid-run checkpoints and resume in the port (``utils/checkpoint.py``,
``SLAM.save_state/load_state``, ``SLAM.run(resume_from=)``,
``tracking.checkpoint_every``), against an uninterrupted port run and the
JAX package's loader.

* A 48x64 tracking run with motion-filter and keyframe thresholds saves
  every 2nd keyframe: after the first save the frontend drops the next
  frame, after the second the next frame is a keyframe. A fresh ``SLAM``
  resumed from either save ends with every video and factor-graph array
  equal to the uninterrupted run's, bit for bit, the same tracker counters
  and mapper handshakes, and the same ``video.npz``.
* The same with the mapper on, synchronous and on its worker thread (the
  default): the point cloud, decoder weights, loss history, keyframe list
  and sampling generator equal too, and the handshakes after the save.
  Exactness needs one intra-op torch thread (``torch_parity`` sets it): the
  CPU backward of the feature gradients sums in thread order otherwise.
* A loaded state saved again is the same file, array for array (bf16 as
  uint16 bits, graph rows zero-padded to the JAX capacities).
* ``mapper.dec_params`` is byte-equal to ``flax.serialization.to_bytes`` of
  the JAX decoder tree.
* A port-written file loads into a fresh JAX ``Tracker`` and ``Mapper``
  (``glorie_slam_tpu.utils.checkpoint.load_checkpoint``), their state
  equals the port's on every live row, and the JAX package's re-save reads
  back into the port equal.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread)
from glorie_slam_tpu_torch.nets.import_flax import (
    decoder_params_to_state_dict, state_dict_to_decoder_params)
from glorie_slam_tpu_torch.slam import SLAM
from glorie_slam_tpu_torch.utils import checkpoint
from glorie_slam_tpu_torch.utils.synthetic import (SyntheticStream, base_cfg,
                                                   mapping_cfg)

H, W = 48, 64
GRAPH_STATE = checkpoint._GRAPH_ROWS + checkpoint._GRAPH_POOL + ("damping",)


def _tracking_slam(out, stream, every=2):
    """A tracking run that rejects frames in the motion filter and drops
    keyframes in the frontend; its handshakes go to ``slam.handshakes``."""
    cfg = base_cfg(H, W, buffer=32, out=out)
    cfg["tracking"]["checkpoint_every"] = every
    cfg["tracking"]["motion_filter"]["thresh"] = 0.0318
    cfg["tracking"]["frontend"]["keyframe_thresh"] = 0.05
    slam = SLAM(cfg, stream, device="cpu")
    slam.handshakes = []
    slam.tracker.on_keyframe = slam.handshakes.append
    slam.tracker.every_kf = 1
    return slam


def _mapping_slam(out, stream, async_mapping=False):
    """A mapped run; its handshakes go to ``slam.handshakes``."""
    cfg = base_cfg(H=H, W=W, buffer=24, out=out)
    cfg.update(mapping_cfg())
    cfg["only_tracking"] = False
    cfg["tracking"]["warmup"] = 4
    cfg["tracking"]["checkpoint_every"] = 2
    cfg["mapping"].update(
        async_mapping=async_mapping, pretrained=None, iters_first=4,
        geo_iter_first=2, iters=2, pixels=128, pixels_adding=192,
        pixels_based_on_color_grad=32, mapping_window_size=4)
    cfg["pointcloud"]["capacity"] = 8192
    cfg["rendering"]["N_surface"] = 5
    cfg["mono_prior"] = {"predict_online": False}
    priors = os.path.join(out, "synth_priors", "depths")
    os.makedirs(priors, exist_ok=True)
    for i, d in enumerate(stream.depths):
        np.save(os.path.join(priors, f"{i:05d}.npy"), d)
    slam = SLAM(cfg, stream, device="cpu")
    slam.handshakes, hand = [], slam.tracker.on_keyframe

    def record(info):
        slam.handshakes.append(dict(info))
        hand(info)

    slam.tracker.on_keyframe = record
    return slam


def _keep_saves(slam, out):
    """Copy every checkpoint the run writes; record (number_of_kf, next)."""
    saved, cb = [], slam.tracker.checkpoint_cb

    def keep(nxt):
        cb(nxt)
        path = os.path.join(out, f"state_{nxt}.npz")
        shutil.copy(os.path.join(slam.output, "state.npz"), path)
        saved.append((slam.tracker.number_of_kf, nxt, path))

    slam.tracker.checkpoint_cb = keep
    return saved


@pytest.fixture(scope="module")
def tracked(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tracked"))
    stream = SyntheticStream(n_frames=16, H=H, W=W, seed=1,
                             trajectory="circuit")
    slam = _tracking_slam(os.path.join(out, "a"), stream)
    saved = _keep_saves(slam, out)
    slam.run()
    return stream, slam, saved


def _mapped_run(tmp_path_factory, async_mapping):
    out = str(tmp_path_factory.mktemp("mapped"))
    stream = SyntheticStream(n_frames=9, H=H, W=W, seed=3,
                             trajectory="circuit")
    slam = _mapping_slam(os.path.join(out, "a"), stream, async_mapping)
    saved = _keep_saves(slam, out)
    slam.tracker.run(stream)          # the evaluations are not under test
    return stream, slam, saved


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    return _mapped_run(tmp_path_factory, async_mapping=False)


@pytest.fixture(scope="module")
def mapped_async(tmp_path_factory):
    return _mapped_run(tmp_path_factory, async_mapping=True)


def _assert_tracking_equal(a, b):
    ta, tb = a.tracker, b.tracker
    for n in ("number_of_kf", "prev_kf_idx", "prev_ba_idx"):
        assert getattr(ta, n) == getattr(tb, n), n
    assert ta.motion_filter.count == tb.motion_filter.count
    for n in checkpoint._VIDEO_ARRAYS:
        assert torch.equal(getattr(a.video, n), getattr(b.video, n)), n
    assert a.video.counter == b.video.counter
    ga, gb = a.tracker.frontend.graph, b.tracker.frontend.graph
    for n in GRAPH_STATE:
        assert torch.equal(getattr(ga, n), getattr(gb, n)), n
    for n in checkpoint._GRAPH_NP:
        assert np.array_equal(getattr(ga, n), getattr(gb, n)), n


@pytest.mark.parametrize("save,next_is_keyframe", [(0, False), (1, True)])
def test_tracking_resume_equals_uninterrupted(tracked, tmp_path, save,
                                              next_is_keyframe):
    stream, a, saved = tracked
    _, nxt, path = saved[save]
    assert 0 < nxt < len(stream)
    assert any(h["timestamp"] == nxt for h in a.handshakes) == \
        next_is_keyframe
    b = _tracking_slam(str(tmp_path), stream, every=0)
    b.run(resume_from=path)
    _assert_tracking_equal(a, b)
    assert b.handshakes == [h for h in a.handshakes
                            if h["end"] or h["timestamp"] >= nxt]
    va = np.load(os.path.join(a.output, "video.npz"))
    vb = np.load(os.path.join(b.output, "video.npz"))
    for k in va.files:
        assert np.array_equal(va[k], vb[k]), k


def test_checkpoint_every_cadence(tracked, tmp_path):
    stream, a, saved = tracked
    assert [s[0] for s in saved] == list(range(2, a.tracker.number_of_kf + 1,
                                               2))
    for kf, nxt, path in saved:
        meta = checkpoint.json.loads(
            np.load(path)["__meta__"].tobytes().decode())
        assert meta["tracker"]["number_of_kf"] == kf
        assert meta["next_frame"] == nxt
    assert len(saved) == 2
    b = _tracking_slam(str(tmp_path), stream, every=0)
    assert b.tracker.checkpoint_cb is None
    assert "checkpoint" in a.timer.summary()


def test_mapper_resume_equals_uninterrupted(mapped, tmp_path):
    stream, a, saved = mapped
    _, nxt, path = saved[0]
    b = _mapping_slam(str(tmp_path), stream)
    b.tracker.checkpoint_cb = None
    b.tracker.run(stream, start=b.load_state(path))
    _assert_tracking_equal(a, b)
    ma, mb = a.mapper, b.mapper
    for n in checkpoint._NPC_ARRAYS:
        assert torch.equal(getattr(ma.npc, n), getattr(mb.npc, n)), n
    assert (ma.npc.count, ma.npc.count_in) == (mb.npc.count, mb.npc.count_in)
    for (k, x), y in zip(ma.decoders.state_dict().items(),
                         mb.decoders.state_dict().values()):
        assert torch.equal(x, y), k
    assert ma.loss_history == mb.loss_history
    assert ma.keyframe_list == mb.keyframe_list
    assert ma.rng.bit_generator.state == mb.rng.bit_generator.state
    assert torch.equal(ma.npc.generator.get_state(),
                       mb.npc.generator.get_state())


def test_async_mapper_resume_equals_uninterrupted(mapped_async, tmp_path):
    """Resume with the mapper on its worker thread (the default): the save
    quiesces the worker, and the resumed run queues the same jobs. A job
    reads its snapshot and the ``npc_dirty`` flags, which stay shared with
    the tracker, so the point cloud could depend on when the worker reads
    them; it does not here. Everything the synchronous test holds is equal,
    bit for bit, the point count included, with the resumed run switching
    threads every 10 us (the interpreter's default is 5 ms)."""
    stream, a, saved = mapped_async
    assert a.async_mapper is not None and a.async_mapper.stats["mapped"] > 0
    _, nxt, path = saved[0]
    b = _mapping_slam(str(tmp_path), stream, async_mapping=True)
    b.tracker.checkpoint_cb = None
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        b.tracker.run(stream, start=b.load_state(path))
    finally:
        sys.setswitchinterval(switch)
    assert not b.async_mapper._thread.is_alive()
    _assert_tracking_equal(a, b)
    assert b.handshakes == [h for h in a.handshakes
                            if h["end"] or h["timestamp"] >= nxt]
    assert b.async_mapper.stats["mapped"] == sum(
        not h["end"] for h in b.handshakes)
    ma, mb = a.mapper, b.mapper
    assert ma.keyframe_list == mb.keyframe_list
    assert (ma.npc.count, ma.npc.count_in) == (mb.npc.count, mb.npc.count_in)
    for n in checkpoint._NPC_ARRAYS:
        assert torch.equal(getattr(ma.npc, n), getattr(mb.npc, n)), n
    for (k, x), y in zip(ma.decoders.state_dict().items(),
                         mb.decoders.state_dict().values()):
        assert torch.equal(x, y), k
    assert ma.loss_history == mb.loss_history
    assert ma.rng.bit_generator.state == mb.rng.bit_generator.state
    assert torch.equal(ma.npc.generator.get_state(),
                       mb.npc.generator.get_state())


def test_loaded_state_saves_the_same_file(mapped, tmp_path):
    stream, _, saved = mapped
    _, nxt, path = saved[0]
    c = _mapping_slam(str(tmp_path), stream)
    assert c.load_state(path) == nxt
    again = str(tmp_path / "again.npz")
    c.save_state(again, nxt)
    A, B = np.load(path), np.load(again)
    assert sorted(A.files) == sorted(B.files)
    for k in A.files:
        assert A[k].dtype == B[k].dtype and np.array_equal(A[k], B[k]), k
    assert "video.fmaps::bf16" in A.files and A["video.fmaps::bf16"].dtype \
        == np.uint16
    meta = checkpoint.json.loads(A["__meta__"].tobytes().decode())
    E, n_inac = meta["graph"]["E"], len(A["graphnp.ii_inac"])
    assert (meta["graph"]["cap"], meta["graph"]["pool_cap"]) == \
        checkpoint.graph_capacities(E, n_inac)
    assert A["graph.target::bf16" if "graph.target::bf16" in A.files
             else "graph.target"].shape[0] == meta["graph"]["cap"]
    assert not A["graph.target"][E:].any()
    assert not A["graph.target_inac"][n_inac:].any()


def test_capacities_follow_the_jax_growth_rules():
    from glorie_slam_tpu.utils.buckets import bucket as jbucket
    for E in (0, 1, 8, 9, 47, 48, 49, 100, 300):
        assert checkpoint.graph_capacities(E, 0)[0] == max(jbucket(E), 8)
    for n, pool in ((0, 8), (8, 8), (9, 128), (128, 128), (129, 256),
                    (1000, 1024)):
        assert checkpoint.graph_capacities(1, n)[1] == pool
    from glorie_slam_tpu.ops.corr import padded_npix
    for npix in (48, 6 * 8, 40 * 80, 48 * 64, 85 * 150):
        assert checkpoint.padded_npix(npix) == padded_npix(npix)


class _NoNet:
    """Stands in for the JAX ``TrackerNet``: a checkpoint holds no network
    weights, and the JAX package's load and save never call the net."""

    def __getattr__(self, name):
        return None


@pytest.fixture(scope="module")
def jax_loaded(mapped, tmp_path_factory):
    """A fresh JAX ``Tracker`` and ``Mapper`` that loaded the mapped run's
    first checkpoint, beside a port ``SLAM`` that loaded it too."""
    from glorie_slam_tpu.core.depth_video import DepthVideo as JVideo
    from glorie_slam_tpu.mapping.mapper import Mapper as JMapper
    from glorie_slam_tpu.tracking.tracker import Tracker as JTracker
    from glorie_slam_tpu.utils import checkpoint as jckpt
    from glorie_slam_tpu.utils.printer import Printer as JPrinter
    from torch_parity import SlamShim

    stream, _, saved = mapped
    _, nxt, path = saved[0]
    out = tmp_path_factory.mktemp("jax_loaded")
    port = _mapping_slam(str(out / "port"), stream)
    port.load_state(path)
    cfg = dict(port.cfg, data={"output": str(out / "jax")})
    jt = JTracker(_NoNet(), JVideo(cfg), cfg)
    jm = JMapper(SlamShim(cfg, stream, jt.video, JPrinter(0, True)), cfg)
    assert jckpt.load_checkpoint(path, jt, mapper=jm) == nxt
    return port, jt, jm, nxt


def test_decoder_msgpack_equals_flax(jax_loaded):
    import jax
    from flax import serialization
    # the JAX mapper's decoder tree, as numpy leaves
    tree = jax.tree_util.tree_map(np.asarray, jax_loaded[2].dec_params)
    blob = serialization.to_bytes(tree)
    assert checkpoint.tree_to_bytes(tree) == blob
    want = decoder_params_to_state_dict(tree)
    state = decoder_params_to_state_dict(checkpoint.tree_from_bytes(blob))
    assert state.keys() == want.keys()
    for k in want:
        assert torch.equal(state[k], want[k]), k
    again = state_dict_to_decoder_params(state)
    restored = serialization.from_bytes(tree, checkpoint.tree_to_bytes(again))
    for k, v in decoder_params_to_state_dict(restored).items():
        assert torch.equal(v, want[k]), k


def test_port_file_loads_in_jax_and_back(mapped, jax_loaded, tmp_path):
    from glorie_slam_tpu.utils import checkpoint as jckpt
    from torch_parity import n

    stream = mapped[0]
    port, jt, jm, nxt = jax_loaded
    assert jt.prev_kf_idx == port.tracker.prev_kf_idx

    def live(x, rows=None):
        x = n(x) if rows is None else n(x)[:rows]
        return np.asarray(x, np.float32) if x.dtype.name == "bfloat16" else x

    for name in checkpoint._VIDEO_ARRAYS:
        assert np.array_equal(live(getattr(jt.video, name)),
                              n(getattr(port.video, name))), name
    jg, pg = jt.frontend.graph, port.tracker.frontend.graph
    for name in checkpoint._GRAPH_ROWS:
        assert np.array_equal(live(getattr(jg, name), jg.E),
                              n(getattr(pg, name))), name
    for name in checkpoint._GRAPH_POOL:
        assert np.array_equal(live(getattr(jg, name), len(jg.ii_inac)),
                              n(getattr(pg, name))), name
    pf = port.tracker.motion_filter
    for name in ("fmap", "net", "inp"):
        assert np.array_equal(live(getattr(jt.motion_filter, name)),
                              n(getattr(pf, name).permute(0, 2, 3, 1))), name
    for name in checkpoint._NPC_ARRAYS:
        assert np.array_equal(live(getattr(jm.npc, name)),
                              n(getattr(port.mapper.npc, name))), name
    for k, v in decoder_params_to_state_dict(jm.dec_params).items():
        assert torch.equal(v, port.mapper.decoders.state_dict()[k]), k

    resaved = str(tmp_path / "jax_state.npz")
    jckpt.save_checkpoint(resaved, jt, nxt, mapper=jm)
    back = _mapping_slam(str(tmp_path / "back"), stream)
    assert back.load_state(resaved) == nxt
    _assert_tracking_equal(port, back)
    for name in checkpoint._NPC_ARRAYS:
        assert torch.equal(getattr(port.mapper.npc, name),
                           getattr(back.mapper.npc, name)), name
    assert back.mapper.npc.key.tolist() == [0, 43]
    for (k, x), y in zip(port.mapper.decoders.state_dict().items(),
                         back.mapper.decoders.state_dict().values()):
        assert torch.equal(x, y), k
