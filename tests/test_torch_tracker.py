"""Port parity: the whole tracking slice, the port's ``Tracker`` against the
JAX package's ``Tracker`` on one synthetic circuit stream.

The configuration is bench.py's with the window, loop window and online-BA
period cut to fit a 10-frame, 48x64 run: the frontend initializes, runs
DSPO rounds, closes loops past its window and runs online global BA.

Both nets compute in float32 with the same random weights (the JAX net is
wrapped so its GRU state comes back in bf16, the dtype the JAX package's
buffers hold it in). Each side then rounds the same quantities to bf16
where the JAX package stores them. What remains is float32 summation order,
which ~150 recurrent GRU + BA rounds with random weights amplify. So this
test holds the structure of the run exactly (edge sets, keyframes, loop
closure and online BA) and its numbers loosely; the tight numerical checks
are the single-round ones in test_torch_update.py. Readings of this run on
the CPU: poses 2.15e-2, disparities 3.2e-4 relative in median and 1.76e-2
at the 95th percentile (pixels pinned near the 1e-5 disparity floor move
most), full-resolution validity masks (read through save_video) equal in
99.997% of pixels. Limits: poses 5e-2; disparities 3e-3 in median and 0.1
at the 95th percentile; masks in 99.9% of pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glorie_slam_tpu.core.depth_video import DepthVideo as JVideo
from glorie_slam_tpu.nets.tracker_net import TrackerNet as JNet
from glorie_slam_tpu.tracking.tracker import Tracker as JTracker
from glorie_slam_tpu_torch.core.depth_video import DepthVideo
from glorie_slam_tpu_torch.nets.import_flax import flax_params_to_state_dict
from glorie_slam_tpu_torch.nets.tracker_net import TrackerNet
from glorie_slam_tpu_torch.tracking.tracker import Tracker
from glorie_slam_tpu_torch.utils.synthetic import bench_cfg
from synthetic import SyntheticStream, base_cfg

H, W, N_FRAMES = 48, 64, 10


def _small(cfg):
    tc = cfg["tracking"]
    tc["warmup"] = 4
    tc["frontend"].update(window=5, max_factors=48)
    tc["backend"].update(ba_freq=3, loop_window=5, loop_nms=2)
    return cfg


def _jax_cfg():
    cfg = base_cfg(H=H, W=W, buffer=16, out="/tmp/glorie_test")
    tc = cfg["tracking"]
    tc["max_age"] = 50
    tc["multiview_filter"] = {"thresh": 0.01, "visible_num": 2}
    tc["frontend"].update(enable_loop=True, enable_online_ba=True)
    tc["backend"].update(BA_type="DSPO", normalize=True)
    return _small(cfg)


def _bf16_state(update_apply):
    def apply(params, *args, **kw):
        out = update_apply(params, *args, **kw)
        return (out[0].astype(jnp.bfloat16),) + tuple(out[1:])
    return apply


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    stream = SyntheticStream(n_frames=N_FRAMES, H=H, W=W, seed=3,
                             motion_scale=0.02, trajectory="circuit")

    def mono(ts, img):
        return stream.depths[int(ts)]

    jn = JNet(seed=1, dtype=jnp.float32)
    jn.update_apply = _bf16_state(jn.update_apply)
    jv = JVideo(_jax_cfg())
    jt = JTracker(jn, jv, jv.cfg, mono_predictor=mono)
    jt.run(stream)

    params = jax.tree_util.tree_map(np.asarray, jn.params)
    pn = TrackerNet(flax_params_to_state_dict(params), dtype=torch.float32,
                    device="cpu")
    pv = DepthVideo(_small(bench_cfg(H=H, W=W, buffer=16)), device="cpu")
    pt = Tracker(pn, pv, pv.cfg, mono_predictor=mono)
    pt.run(stream)
    path = tmp_path_factory.mktemp("video") / "video.npz"
    pv.save_video(str(path))
    return jt, jv, pt, pv, np.load(path)


def test_slice_runs_the_same_pipeline(runs):
    jt, jv, pt, pv, _ = runs
    assert pv.counter == jv.counter == N_FRAMES
    assert pt.frontend.last_loop_t == jt.frontend.last_loop_t > 0
    assert pt.prev_ba_idx == jt.prev_ba_idx > 0
    np.testing.assert_array_equal(pt.frontend.graph.ii, jt.frontend.graph.ii)
    np.testing.assert_array_equal(pt.frontend.graph.jj, jt.frontend.graph.jj)
    np.testing.assert_array_equal(pt.frontend.graph.ii_inac,
                                  jt.frontend.graph.ii_inac)


def test_slice_poses_and_disparities_match_jax(runs):
    _, jv, _, pv, _ = runs
    n = jv.counter
    np.testing.assert_allclose(pv.poses[:n].numpy(), np.asarray(jv.poses[:n]),
                               atol=5e-2)
    jd = np.asarray(jv.disps[:n])
    rel = np.abs(pv.disps[:n].numpy() - jd) / np.maximum(np.abs(jd), 1e-3)
    assert np.median(rel) < 3e-3
    assert np.percentile(rel, 95) < 0.1


def test_slice_saved_video_matches_jax(runs):
    _, jv, _, pv, saved = runs
    n = jv.counter
    assert saved["poses"].shape == (n, 4, 4)
    assert saved["depths"].shape == saved["valid_depth_masks"].shape \
        == (n, H, W)
    assert np.all(np.isfinite(saved["poses"]))
    jm = np.asarray(jv.valid_depth_mask[:n])
    assert np.mean(saved["valid_depth_masks"] == jm) >= 0.999
