"""The port's visualizer (``utils/visualizer.py``) against the JAX
package's: the same panel and trajectory files under the same names; with
matplotlib blocked it draws nothing and says so once. The mapper calls it
as the JAX one does: unless ``silence``, after the first mapped keyframe's
optimisation (and every ``freq``-th), with the keyframe re-rendered."""

import os
import sys

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread)
from glorie_slam_tpu.utils import visualizer as jvis
from glorie_slam_tpu_torch.slam import SLAM
from glorie_slam_tpu_torch.utils import visualizer
from glorie_slam_tpu_torch.utils.synthetic import (SyntheticStream, base_cfg,
                                                   mapping_cfg)


def _panels(rng, H=24, W=32):
    d = rng.random((H, W)).astype(np.float32) + 0.5
    c = rng.random((H, W, 3)).astype(np.float32)
    return [d, d * 1.1, d * 0.9, d, c, d * 1.05, c * 1.2]


def _files(root):
    return sorted(os.path.relpath(os.path.join(b, f), root)
                  for b, _, fs in os.walk(root) for f in fs)


def test_files_match_the_jax_visualizer(tmp_path):
    rng = np.random.default_rng(0)
    args = _panels(rng)
    poses = np.tile(np.eye(4), (5, 1, 1))
    poses[:, 0, 3] = np.arange(5) * 0.1
    for name, mod, conv in (("jax", jvis, np.asarray),
                            ("port", visualizer, torch.as_tensor)):
        root = tmp_path / name
        v = mod.Visualizer(str(root / "mapping_vis"),
                           img_dir=str(root / "rendered_image"), freq=5)
        v.vis(10, 3, *[conv(a) for a in args], save_rendered_image=True)
        v.vis(7, 3, *args)                                 # off the cadence
        v.vis(7, 9, *args, freq_override=True)
        mod.CameraPoseVisualizer(str(root / "traj.png")).plot(
            poses, poses + 0.01)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax") == [
        "mapping_vis/00007_0009.jpg", "mapping_vis/00010_0003.jpg",
        "rendered_image/frame_00010.png", "traj.png"]


def test_without_matplotlib_skips_with_one_message(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    v = visualizer.Visualizer(str(tmp_path / "vis"), freq=1)
    args = _panels(np.random.default_rng(1))
    v.vis(0, 0, *args)
    v.vis(1, 0, *args)
    visualizer.CameraPoseVisualizer(str(tmp_path / "t.png")).plot(
        np.tile(np.eye(4), (2, 1, 1)))
    out = capsys.readouterr().out
    assert out.count("matplotlib is not installed") == 2     # once per object
    assert os.listdir(tmp_path / "vis") == []
    assert not os.path.exists(tmp_path / "t.png")


def test_other_failures_raise(tmp_path):
    v = visualizer.Visualizer(str(tmp_path / "vis"), freq=1)
    with pytest.raises(Exception):
        v.vis(0, 0, np.zeros((4, 4)), np.zeros((5, 5)), None, None,
              np.zeros((4, 4, 3)), np.zeros((4, 4)), np.zeros((3, 3, 3)))


def test_mapper_draws_the_first_keyframe(tmp_path):
    H, W = 48, 64
    stream = SyntheticStream(n_frames=6, H=H, W=W, seed=3,
                             trajectory="circuit")
    cfg = base_cfg(H=H, W=W, buffer=24, out=str(tmp_path))
    cfg.update(mapping_cfg())
    cfg["only_tracking"] = False
    cfg["silence"] = False
    cfg["tracking"]["warmup"] = 4
    cfg["mapping"].update(
        async_mapping=False, pretrained=None, iters_first=4,
        geo_iter_first=2, iters=2, pixels=128, pixels_adding=192,
        pixels_based_on_color_grad=32, mapping_window_size=4)
    cfg["pointcloud"]["capacity"] = 8192
    cfg["rendering"]["N_surface"] = 5
    cfg["mono_prior"] = {"predict_online": False}
    priors = tmp_path / "synth_priors" / "depths"
    os.makedirs(priors)
    for i, d in enumerate(stream.depths):
        np.save(priors / f"{i:05d}.npy", d)
    slam = SLAM(cfg, stream, device="cpu")
    slam.tracker.run(stream)
    first = slam.mapper.keyframe_list[0]
    out = slam.output
    assert os.listdir(os.path.join(out, "mapping_vis")) == [
        f"{first:05d}_{cfg['mapping']['iters_first'] - 1:04d}.jpg"]
    assert os.listdir(os.path.join(out, "rendered_image")) == [
        f"frame_{first:05d}.png"]
