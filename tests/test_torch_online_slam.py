"""Port parity: ``SLAM.run`` with the online mono prior and the mapper, the
end-of-run evaluations included, against the JAX package's run, on the
CPU (in a file of its own: it takes minutes, and the test workers run
files side by side).
"""

import functools
import os
import re

import jax
import numpy as np

import glorie_slam_tpu.mapping.mono_prior as jmono_mod
from glorie_slam_tpu.mapping import dpt as jdpt
from glorie_slam_tpu_torch.mapping import dpt, mono_prior
from synthetic import SyntheticStream, base_cfg
import torch_parity  # noqa: F401  (one torch thread per test process)

SMALL = dict(n_blocks=2, hooks=(0, 1))
F32 = "float32"


def test_slam_run_online_prior_and_evaluations_match_jax(tmp_path,
                                                         monkeypatch):
    """``SLAM.run`` with the online prior (the small DPT at 64x64) and the
    mapper, on the CPU at 40x64 over 6 frames, in both packages: the same
    prior files, output files and metric keys (random weights make whole
    runs chaotic, so their numbers are held by the unit tests here and in
    ``test_torch_eval.py``). The port also gets a ground-truth mesh (the
    synthetic plane) and writes ``logs/metrics_recon.txt`` with the JAX
    package's keys; its depth L1 takes 3 views here (1000 in a run): the
    JAX package's Python rasterizer would take hours for 1000 views of the
    run's mesh, so its run gets no ground truth."""
    import json

    import glorie_slam_tpu.slam as jslam_mod
    import glorie_slam_tpu.utils.warmup as jwarmup
    import glorie_slam_tpu_torch.slam as slam_mod
    from glorie_slam_tpu_torch.mapping import mesher

    H, W = 40, 64
    stream = SyntheticStream(n_frames=6, H=H, W=W, seed=3)
    for mod, pkg_dpt in ((jmono_mod, jdpt), (mono_prior, dpt)):
        monkeypatch.setattr(mod, "DPTDepthModel", functools.partial(
            pkg_dpt.DPTDepthModel, **SMALL))
    monkeypatch.setattr(jmono_mod, "MonoDepthEstimator", functools.partial(
        jmono_mod.MonoDepthEstimator, infer_size=64))
    monkeypatch.setattr(slam_mod, "MonoDepthEstimator", functools.partial(
        mono_prior.MonoDepthEstimator, infer_size=64))
    # the JAX run's shape profile goes to the test's directory, not the
    # repository's shape_profiles/
    monkeypatch.setattr(jwarmup, "save_shape_profile", functools.partial(
        jwarmup.save_shape_profile, root=str(tmp_path)))
    monkeypatch.setattr(slam_mod, "eval_recon_with_cfg", functools.partial(
        slam_mod.eval_recon_with_cfg, n_imgs_2d=3))
    gt_mesh = str(tmp_path / "plane.ply")
    z = stream.depths[0].max() + 0.0            # the plane's depth
    mesher.write_ply_mesh(gt_mesh, np.array(
        [[-5, -5, z], [5, -5, z], [5, 5, z], [-5, 5, z]], np.float64),
        np.array([[0, 1, 2], [0, 2, 3]]))
    outs = {}
    for side, SLAM in (("jax", jslam_mod.SLAM), ("port", slam_mod.SLAM)):
        cfg = base_cfg(H=H, W=W, buffer=16, out=str(tmp_path / side))
        cfg["only_tracking"] = False
        cfg["tracking"]["warmup"] = 4
        cfg["tracking"]["warmup_compile"] = False
        # random weights leave too few multiview-consistent depths to map
        cfg["tracking"]["multiview_filter"]["thresh"] = 1000.0
        cfg["mapping"].update(async_mapping=False, iters_first=2,
                              geo_iter_first=1, iters=1, every_frame=5)
        cfg["mono_prior"] = {"depth": "omnidata", "predict_online": True}
        if side == "port":
            cfg["meshing"] = {"gt_mesh_path": gt_mesh}
            slam = SLAM(cfg, stream, device="cpu")
        else:
            slam = SLAM(cfg, stream)
        with jax.default_matmul_precision(F32):
            slam.run()
        outs[side] = slam.output
    for side in outs:
        priors = tmp_path / side / "synth_priors" / "depths"
        outs[side] = (outs[side], sorted(os.listdir(priors)))

    (jout, jpriors), (out, priors) = outs["jax"], outs["port"]
    assert priors == jpriors and "00005.npy" in priors

    def kinds(root):
        """The run's files, frame numbers masked (which keyframes the
        random-weight trackers map differs)."""
        return {re.sub(r"\d{5}", "#####", os.path.relpath(
            os.path.join(d, f), root)) for d, _, fs in os.walk(root)
            for f in fs}

    jkinds = kinds(jout)
    assert kinds(out) == jkinds | {"logs/metrics_recon.txt"}
    assert {"mesh/rendered_mesh_kf.ply", "logs/metrics_render_kf.txt",
            "rendered_every_keyframe/depth_#####.npy",
            "rendered_every_frame/color_#####.npy"} <= jkinds
    for name in ("metrics_render_kf.txt", "metrics_render_full.txt"):
        with open(f"{out}/logs/{name}") as f1, open(f"{jout}/logs/{name}") as f2:
            keys = [line.split(":")[0] for line in f1]
            assert keys == [line.split(":")[0] for line in f2] and keys
    with open(f"{out}/logs/metrics_recon.txt") as f:
        recon = dict(line.rstrip("\n").split(": ") for line in f)
    assert set(recon) == {f"{k}_kf" for k in (
        "accuracy", "completion", "completion_ratio", "precision", "recall",
        "normal consistency", "f-score", "depth l1")}
    with open(f"{out}/logs/phase_times.json") as f:
        phases = json.load(f)["phases"]
    for name in ("eval_kf_imgs", "generate_mesh_kf", "eval_imgs",
                 "eval_recon"):
        assert phases[name]["calls"] == 1, name
