"""A cell shrunk for a CPU run: 64x96 frames, a 2-block DPT at 64x64, a
small mapper. The numbers such a run reads say nothing of the card; it
checks control flow, captures and comparisons."""

import functools
import time

CAM = {"H": 64, "W": 96, "H_out": 64, "W_out": 96, "H_edge": 0,
       "W_edge": 0, "fx": 76.8, "fy": 76.8, "cx": 47.5, "cy": 31.5}
DPT = {"n_blocks": 2, "hooks": [0, 1]}


def overrides(cell, control=False):
    over = {"cfg": {"cam": CAM, "tracking": {
                "buffer": 96, "warmup": 6,
                "frontend": {"window": 12, "max_factors": 24},
                "backend": {"loop_window": 12, "ba_freq": 4}}},
            "traffic": {"frames": 20, "warmup_max_frames": 40,
                        "check_keyframe": [0, 2], "trace_keyframes": [1, 3],
                        "trace_iters": [1, 3]},
            "dpt": DPT, "control": control}
    if cell == "replica-map":
        over["cfg"].update({
            "mapping": {"pixels": 200, "pixels_adding": 300,
                        "pixels_based_on_color_grad": 50, "iters": 20,
                        "mapping_window_size": 4},
            "pointcloud": {"capacity": 16384}})
        over["traffic"].update(frames=8, anchor_keyframes=3, setup_iters=1,
                               anchor_min_points=0, window_geometry_steps=2)
    return over


def small_dpt(monkeypatch):
    """The program's DPT at 2 blocks and 64x64 input."""
    from glorie_slam_tpu_torch import slam as slam_mod
    from glorie_slam_tpu_torch.mapping import mono_prior

    monkeypatch.setattr(mono_prior, "DPTDepthModel", functools.partial(
        mono_prior.DPTDepthModel, n_blocks=2, hooks=(0, 1)))
    monkeypatch.setattr(slam_mod, "MonoDepthEstimator", functools.partial(
        slam_mod.MonoDepthEstimator, infer_size=64))


def run(cell, seconds=None, trace=False, control=False, seed=2 ** 31 + 7):
    """Run ``cell`` shrunk; the mapper's window is long enough to reach
    the colour stage's captured steps."""
    from benchmark import harness

    if seconds is None:
        seconds = 6.0 if cell == "replica-map" else 2.0
    return harness.run_cell(cell, seed, seconds, trace, "cpu",
                            time.perf_counter(),
                            overrides=overrides(cell, control))
