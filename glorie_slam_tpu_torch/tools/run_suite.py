"""Run every scene config of a dataset suite through the port.

    python -m glorie_slam_tpu_torch.tools.run_suite <configs/Dataset>
        [--only_tracking] [--max_frames N] [--stride N] [--out F]
        [--device cpu]

(installed as ``glorie-slam-torch-suite``). Counterpart of
``scripts/run_suite.py``: the scene configs are every ``*.yaml`` of the
directory except ``demo_*`` files and the dataset's base config, the one
the scene files ``inherit_from`` (``scene_configs``). Each scene runs in
turn through ``config.load_config``, ``utils/datasets.get_dataset`` and
``SLAM(...).run()``, on the card unless ``--device cpu``; its
``traj/metrics_*.txt`` (``parse_metrics_txt``), ``logs/render_metrics.json``
and ``logs/phase_times.json`` are gathered into one JSON (``--out``, by
default ``<dataset>_suite.json``) and a markdown table beside it.

A scene that fails is recorded (its error and traceback) and the suite goes
on to the next, as the JAX runner does; unlike it, the runner then exits
with 1, so that no caller passes over a failed scene.
"""

import argparse
import glob
import json
import os
import re
import sys
import time
import traceback


def parse_metrics_txt(path):
    """traj/metrics_*.txt -> {key: float} (ATE stats + alignment scale)."""
    out = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            m = re.match(r"([\w\- \[\]]+):\s*([-\d.eE+nan]+)", line.strip())
            if m:
                key = m.group(1).strip().replace("ATE-RMSE [m]",
                                                 "ate_rmse_m")
                try:
                    out[key] = float(m.group(2))
                except ValueError:
                    pass
    return out


def scene_configs(suite_dir):
    """The scene YAMLs of ``suite_dir``, sorted: every ``*.yaml`` but the
    ``demo_*`` files and the configs that a scene YAML inherits from
    (matched by path, relative to the working directory or to the
    directory's parent, or by file name)."""
    import yaml

    inherited, scenes = set(), []
    for y in sorted(glob.glob(os.path.join(suite_dir, "*.yaml"))):
        if os.path.basename(y).startswith("demo_"):
            continue
        with open(y) as f:
            d = yaml.safe_load(f) or {}
        base = d.get("inherit_from")
        if base:
            if not os.path.isabs(base):
                inherited.add(os.path.normpath(
                    os.path.join(os.path.dirname(y), "..", base)))
            inherited.add(os.path.normpath(base))
        scenes.append(y)
    names = {os.path.basename(b) for b in inherited}
    return [y for y in scenes if os.path.normpath(y) not in inherited
            and os.path.basename(y) not in names]


def run_scene(cfg_path, args):
    """One scene through the port -> its row of the suite."""
    from .. import config as config_mod
    from ..slam import SLAM
    from ..utils.datasets import get_dataset

    cfg = config_mod.load_config(cfg_path, config_mod.DEFAULT_CONFIG_PATH)
    if args.only_tracking:
        cfg["only_tracking"] = True
    if args.max_frames is not None:
        cfg["max_frames"] = args.max_frames
    if args.stride is not None:
        cfg["stride"] = args.stride
    cfg["silence"] = True

    output = f"{cfg['data']['output']}/{cfg['setting']}/{cfg['scene']}"
    os.makedirs(output, exist_ok=True)
    config_mod.save_config(cfg, f"{output}/cfg.yaml")

    stream = get_dataset(cfg)
    slam = SLAM(cfg, stream, device=args.device)
    t0 = time.perf_counter()
    slam.run()
    wall = time.perf_counter() - t0

    rec = {
        "scene": cfg["scene"],
        "wall_s": wall,
        "n_keyframes": int(slam.video.counter),
        "keyframe_fps": slam.video.counter / max(wall, 1e-9),
        "kf": parse_metrics_txt(f"{output}/traj/metrics_kf_traj.txt"),
        "full": parse_metrics_txt(f"{output}/traj/metrics_full_traj.txt"),
    }
    for key, name in (("render", "render_metrics.json"),
                      ("phase_times", "phase_times.json")):
        path = os.path.join(output, "logs", name)
        if os.path.exists(path):
            with open(path) as f:
                rec[key] = json.load(f)
    return rec


def write_table(path, results, avg=None):
    """The markdown table of the suite's rows."""
    with open(path, "w") as f:
        f.write("| scene | KFs | KF/s | ATE-RMSE kf [m] "
                "| ATE-RMSE full [m] |\n")
        f.write("|---|---|---|---|---|\n")
        for r in results:
            f.write(f"| {r['scene']} | {r['n_keyframes']} "
                    f"| {r['keyframe_fps']:.3f} "
                    f"| {r['kf'].get('ate_rmse_m', '-')} "
                    f"| {r['full'].get('ate_rmse_m', '-')} |\n")
        if avg is not None:
            f.write(f"| **avg** | | | {avg:.5f} | |\n")


def main(argv=None):
    """Run the suite; returns the exit code (1 when no scene was found or
    any scene failed)."""
    ap = argparse.ArgumentParser(
        description="every scene of a configs/<Dataset> directory through "
                    "glorie_slam_tpu_torch")
    ap.add_argument("suite_dir", help="configs/<Dataset> directory")
    ap.add_argument("--only_tracking", action="store_true")
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument("--stride", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu on request)")
    args = ap.parse_args(argv)
    from ..device import resolve_device
    resolve_device(args.device)       # no card and no --device cpu: raise

    scenes = scene_configs(args.suite_dir)
    if not scenes:
        print(f"no scene configs found under {args.suite_dir}")
        return 1

    results, failures = [], []
    for y in scenes:
        print(f"[suite] {y}", flush=True)
        try:
            results.append(run_scene(y, args))
        except Exception as e:  # noqa: BLE001 - recorded; the suite goes on
            tb = traceback.format_exc()
            print(f"[suite] FAILED {y}: {e!r}\n{tb}", flush=True)
            failures.append({"config": y, "error": repr(e),
                             "traceback": tb})

    agg = {"suite": args.suite_dir, "results": results,
           "failures": failures}
    ates = [r["kf"]["ate_rmse_m"] for r in results
            if "ate_rmse_m" in r["kf"]]
    if ates:
        agg["avg_kf_ate_rmse_m"] = sum(ates) / len(ates)
    out = args.out or (os.path.basename(os.path.normpath(args.suite_dir))
                       .lower() + "_suite.json")
    with open(out, "w") as f:
        json.dump(agg, f, indent=2)
    md = out.rsplit(".", 1)[0] + ".md"
    write_table(md, results, agg.get("avg_kf_ate_rmse_m"))
    print(f"[suite] wrote {out} and {md} ({len(results)} scenes, "
          f"{len(failures)} failures)", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
