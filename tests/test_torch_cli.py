"""The port's command-line entry point (``glorie_slam_tpu_torch/cli.py``)
on a 7-Scenes-layout scene written here (PNG frames and pose files of the
synthetic circuit), with a scene YAML that inherits from
``configs/7scenes/7scenes.yaml`` (cut to 60x80 input, a 32-frame buffer,
warmup 5, every frame a keyframe, no mono prior). ``main([..., "--device",
"cpu", "--only_tracking", "--max_frames", "8"])`` writes ``cfg.yaml`` (the
merged config, which PyYAML reads back equal), ``video.npz``, ``traj/``,
``logs/phase_times.json`` and ``state.npz``; ``--resume state.npz``
continues from the checkpoint's next frame and ends with the uninterrupted
run's keyframes and poses, exactly."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import torch_parity  # noqa: F401  (one torch thread)
from glorie_slam_tpu_torch import cli
from glorie_slam_tpu_torch.utils.synthetic import SyntheticStream, \
    write_7scenes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 60, 80

SCENE = """\
inherit_from: {root}/configs/7scenes/7scenes.yaml
scene: synth
setting: test
tracking:
  buffer: 32
  warmup: 5
  checkpoint_every: 3
  motion_filter:
    thresh: 0.0
  frontend:
    keyframe_thresh: 0.0
cam:
  H: {H}
  W: {W}
  fx: {fx}
  fy: {fy}
  cx: {cx}
  cy: {cy}
  H_edge: 4
  W_edge: 4
  H_out: 48
  W_out: 64
mono_prior:
  predict_online: False
data:
  input_folder: {data}
  output: {out}
"""


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli")
    intr = [64.0, 64.0, W / 2 - 0.5, H / 2 - 0.5]
    stream = SyntheticStream(n_frames=10, H=H, W=W, seed=2,
                             trajectory="circuit", intrinsics=intr)
    write_7scenes(str(base / "data"), stream)
    path = base / "synth.yaml"
    path.write_text(SCENE.format(root=ROOT, H=H, W=W, fx=intr[0], fy=intr[1],
                                 cx=intr[2], cy=intr[3], data=base / "data",
                                 out=base / "out"))
    return str(path), str(base / "out" / "test" / "synth")


ARGS = ["--device", "cpu", "--only_tracking", "--max_frames", "8",
        "--silence"]


@pytest.fixture(scope="module")
def first_run(scene):
    path, out = scene
    slam = cli.main([path, *ARGS])
    return slam


def test_cli_writes_its_outputs(scene, first_run):
    path, out = scene
    for f in ("cfg.yaml", "video.npz", "logs/phase_times.json", "state.npz",
              "traj/full_traj_w2c.npy"):
        assert os.path.exists(os.path.join(out, f)), f
    with open(os.path.join(out, "cfg.yaml")) as f:
        written = yaml.full_load(f)
    assert written == first_run.cfg
    assert written["max_frames"] == 8 and written["only_tracking"] is True
    assert written["tracking"]["multiview_filter"]["thresh"] == 0.03
    assert written["silence"] is True and written["verbose"] is False
    assert len(first_run.stream) == 8
    assert first_run.video.counter == 8


def test_cli_resume_continues_to_the_same_end(scene, first_run, tmp_path):
    path, out = scene
    state = str(tmp_path / "state.npz")
    shutil.copy(os.path.join(out, "state.npz"), state)
    nxt = json.loads(np.load(state)["__meta__"].tobytes())["next_frame"]
    assert 5 < nxt < 8
    poses, counter = first_run.video.poses.clone(), first_run.video.counter
    resumed = cli.main([path, *ARGS, "--resume", state])
    assert resumed.video.counter == counter
    assert torch.equal(resumed.video.poses, poses)
    assert torch.equal(resumed.video.timestamp, first_run.video.timestamp)


def test_cli_starts_the_ranks_that_mesh_devices_asks_for(scene, first_run,
                                                         tmp_path):
    """``tracking.mesh_devices: 2``: the CLI starts two CPU ranks itself
    (gloo) and runs the scene edge-sharded; rank 0 writes the outputs,
    which hold the one-rank run's keyframes and, loosely (random weights),
    its poses."""
    path, _ = scene
    sharded = tmp_path / "sharded.yaml"
    sharded.write_text(f"inherit_from: {path}\ntracking:\n  mesh_devices: 2"
                       f"\n  checkpoint_every: 0\ndata:\n  output: "
                       f"{tmp_path / 'out'}\n")
    assert cli.main([str(sharded), *ARGS]) is None
    out = tmp_path / "out" / "test" / "synth"
    with open(out / "cfg.yaml") as f:
        assert yaml.full_load(f)["tracking"]["mesh_devices"] == 2
    video = np.load(out / "video.npz")
    v = first_run.video
    np.testing.assert_array_equal(video["timestamps"],
                                  v.timestamp[:v.counter].numpy())
    np.testing.assert_allclose(video["poses"], np.load(
        os.path.join(scene[1], "video.npz"))["poses"], atol=5e-2)
    assert not (out / "state.npz").exists()


def test_cli_runs_as_a_module():
    out = subprocess.run([sys.executable, "-m", "glorie_slam_tpu_torch.cli",
                          "--help"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for flag in ("--only_tracking", "--max_frames", "--stride", "--resume",
                 "--device", "--silence"):
        assert flag in out.stdout


def test_wandb_absent_prints_a_message(tmp_path, monkeypatch, capsys):
    from glorie_slam_tpu_torch.slam import SLAM
    from glorie_slam_tpu_torch.utils.synthetic import base_cfg

    monkeypatch.setitem(sys.modules, "wandb", None)      # import wandb fails
    cfg = base_cfg(48, 64, buffer=16, out=str(tmp_path))
    cfg.update(wandb=True, silence=False)
    stream = SyntheticStream(n_frames=2, H=48, W=64)
    assert SLAM(cfg, stream, device="cpu").logger is None
    out = capsys.readouterr()
    assert "wandb is not installed" in out.out + out.err
