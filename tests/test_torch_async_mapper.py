"""The port's asynchronous mapper: the worker maps against a snapshot that
equals the video at the handshake instant, though tracking goes on
mutating the live video in place; the snapshot's scale/shift write-through
touches only its row; a worker exception reaches the tracker; and
``SLAM.run`` with mapping gives the same map asynchronously and
synchronously. Port-only behaviour (the JAX package's counterparts are
``tests/test_async_mapper.py:89-124``); the CPU runs at 64x96.
"""

import os
import time

import numpy as np
import pytest
import torch

from glorie_slam_tpu_torch.core.depth_video import DepthVideo
from glorie_slam_tpu_torch.mapping.async_worker import (AsyncMapper,
                                                        VideoSnapshot)
from glorie_slam_tpu_torch.nets.tracker_net import TrackerNet
from glorie_slam_tpu_torch.slam import SLAM
from glorie_slam_tpu_torch.tracking.tracker import Tracker
from glorie_slam_tpu_torch.utils.synthetic import (SyntheticStream, base_cfg,
                                                   mapping_cfg)
import torch_parity  # noqa: F401  (one torch thread per test process)

H, W = 64, 96


def _capture(view, video_idx):
    """The read surface the mapper consumes, as numpy copies."""
    est_depth, mask, c2w = view.get_depth_and_pose(video_idx)
    return {"t": view.counter,
            "poses": view.poses[:view.counter].cpu().numpy().copy(),
            "est_depth": est_depth.copy(), "mask": mask.copy(),
            "c2w": c2w.copy()}


class RecordingMapper:
    """Sleeps so that tracking runs ahead, then records its view."""

    def __init__(self, video):
        self.live = self.video = video
        self.records = []

    def on_keyframe(self, frame_info):
        time.sleep(0.05)
        rec = _capture(self.video, frame_info["video_idx"])
        rec["live_t"] = self.live.counter
        self.records.append(rec)


@pytest.fixture(scope="module")
def tracked():
    N = 16
    stream = SyntheticStream(n_frames=N, H=H, W=W, seed=3)
    cfg = base_cfg(H=H, W=W, buffer=32)
    cfg["tracking"]["warmup"] = 6
    cfg["mapping"] = {"every_keyframe": 1}
    video = DepthVideo(cfg, device="cpu")
    stub = RecordingMapper(video)
    asyncm = AsyncMapper(stub, video)
    expected = []

    def on_kf(info):
        if not info.get("end"):
            # the synchronous instant, on the tracker's thread
            expected.append(_capture(video, info["video_idx"]))
        asyncm.on_keyframe(info)

    tracker = Tracker(TrackerNet(seed=0, device="cpu"), video, cfg,
                      mono_predictor=lambda ts, img: stream.depths[int(ts)],
                      on_keyframe=on_kf)
    tracker.run(stream)
    asyncm.join()
    return stub, expected, video, asyncm


def test_snapshot_matches_handshake_instant(tracked):
    stub, expected, _, asyncm = tracked
    assert len(stub.records) == len(expected) >= 5
    assert asyncm.stats["mapped"] == len(expected)
    for got, want in zip(stub.records, expected):
        assert got["t"] == want["t"]
        for k in ("poses", "est_depth", "mask", "c2w"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # jobs ran while tracking was ahead of their snapshot, so the live
    # tensors had been updated in place after the snapshot was taken
    assert any(r["live_t"] > r["t"] for r in stub.records)


def test_write_through_row_does_not_clobber_live(tracked):
    _, _, video, _ = tracked
    snap = VideoSnapshot(video)
    pose_before = video.poses[1].clone()
    video.depth_scale[0] = 7.0          # tracking writes after the snapshot
    video.poses[1, 0] += 1.0
    snap.set_depth_scale_shift(3, 2.5, 0.25)
    assert float(video.depth_scale[0]) == 7.0
    assert float(video.depth_scale[3]) == 2.5
    assert float(video.depth_shift[3]) == 0.25
    assert float(snap.depth_scale[3]) == 2.5
    assert float(snap.depth_scale[0]) != 7.0
    assert torch.equal(snap.poses[1], pose_before)


def test_worker_exception_propagates_and_join_idempotent(tracked):
    _, _, video, _ = tracked

    class Boom:
        def __init__(self):
            self.video = video

        def on_keyframe(self, info):
            raise RuntimeError("boom")

    am = AsyncMapper(Boom(), video)
    am.on_keyframe({"video_idx": 0, "timestamp": 0, "end": False})
    with pytest.raises(RuntimeError, match="boom"):
        am.join()
    am.join()
    assert not am._thread.is_alive()


def test_quiesce_drains_without_stopping(tracked):
    _, _, video, _ = tracked
    rec = RecordingMapper(video)
    am = AsyncMapper(rec, video)
    for ix in (1, 2, 3):
        am.on_keyframe({"video_idx": ix, "timestamp": ix, "end": False})
    am.quiesce()
    assert len(rec.records) == am.stats["mapped"] == 3
    assert am._thread.is_alive()
    am.on_keyframe({"end": True})
    assert not am._thread.is_alive()


def test_slam_maps_alike_async_and_sync(tmp_path):
    """``SLAM.run`` with mapping, asynchronous then synchronous, from the
    same stream and seeds: the snapshot makes the worker's inputs those of
    the synchronous schedule, so the maps agree: the same anchors, losses
    to 1e-4 relative, positions to 1e-4 and features to 1e-4 on all but
    1% of the entries. Not exactly: the full-resolution validity mask is
    refreshed lazily, for frames marked stale. The synchronous mapper
    refreshes the live video's rows at each handshake and clears their
    flags; the worker refreshes its snapshot's copy, and the live rows stay
    stale until read. A frame at a window's border whose neighbours moved
    after its refresh keeps an older mask in the synchronous run (as in the
    JAX package's two schedules), which moves a few depths."""
    stream = SyntheticStream(n_frames=8, H=H, W=W, seed=3,
                             trajectory="circuit")
    runs = {}
    for mode in (True, False):
        out = str(tmp_path / str(mode))
        cfg = base_cfg(H=H, W=W, buffer=24, out=out)
        cfg.update(mapping_cfg())
        cfg["only_tracking"] = False
        cfg["tracking"]["warmup"] = 4
        cfg["mapping"].update(
            async_mapping=mode, pretrained=None, iters_first=4,
            geo_iter_first=2, iters=2, pixels=128, pixels_adding=192,
            pixels_based_on_color_grad=32, mapping_window_size=4)
        cfg["pointcloud"]["capacity"] = 8192
        cfg["rendering"]["N_surface"] = 5
        cfg["mono_prior"] = {"predict_online": False}
        priors = os.path.join(out, "synth_priors", "depths")
        os.makedirs(priors)
        for i, d in enumerate(stream.depths):
            np.save(os.path.join(priors, f"{i:05d}.npy"), d)
        slam = SLAM(cfg, stream, device="cpu")
        slam.run()
        assert (slam.async_mapper is not None) == mode
        runs[mode] = slam
    a, s = runs[True].mapper, runs[False].mapper
    assert runs[True].async_mapper.stats["mapped"] >= 3
    assert a.npc.count_in == s.npc.count_in > 0
    assert len(a.loss_history) == len(s.loss_history) > 0
    for x, y in zip(a.loss_history, s.loss_history):
        np.testing.assert_allclose([x["geo"], x["color"]],
                                   [y["geo"], y["color"]], rtol=1e-4)
    np.testing.assert_allclose(a.npc.input_pos.numpy(),
                               s.npc.input_pos.numpy(), atol=1e-4)
    for name in ("geo_feats", "col_feats"):
        d = np.abs(getattr(a.npc, name).numpy() - getattr(s.npc, name).numpy())
        assert (d > 1e-4).mean() <= 0.01, name
    for slam in runs.values():
        for f in ("final_point_cloud.npy", "npc_cloud.npy",
                  "final_point_cloud.ply", "video.npz"):
            assert os.path.exists(os.path.join(slam.output, f)), f
        assert "final_refine" in slam.timer.summary()
