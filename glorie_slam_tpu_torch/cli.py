"""Command-line entry point of the port.

    python -m glorie_slam_tpu_torch.cli <scene.yaml> [--only_tracking]
        [--silence] [--max_frames N] [--stride S] [--resume state.npz]
        [--device cuda|cpu]

(installed as ``glorie-slam-torch``). Counterpart of
``glorie_slam_tpu/cli.py``: the scene config is loaded through its
``inherit_from`` chain over ``configs/mono_point_slam.yaml``, the flags
override it, ``setup_seed`` seeds ``random`` and ``np.random``, the merged
config is written to ``{data.output}/{setting}/{scene}/cfg.yaml``, and
``SLAM(cfg, get_dataset(cfg)).run(resume_from=...)`` runs on the card
unless ``--device cpu`` asks for the CPU (the port's counterpart of
``JAX_PLATFORMS``; the JAX CLI's compilation-cache setup has none).

With ``tracking.mesh_devices`` n > 1 the CLI starts n ranks itself
(``parallel/launch.py``), each running this command inside the edge group:
rank r on cuda:r with NCCL, or on the CPU with gloo under ``--device cpu``;
the ranks may take ``SHARDED_RUN_TIMEOUT_S`` in all. Started by torchrun
(``RANK`` and ``WORLD_SIZE`` in the environment), it joins torchrun's
group instead. Ranks that share one card (gloo) are started by
``parallel.launch.launch(..., shared_device=True)``, not by the CLI.
"""

import argparse
import os
import random
import sys

import numpy as np

# what the ranks of a sharded run may take in all: a long scene runs hours
SHARDED_RUN_TIMEOUT_S = 7 * 24 * 3600.0


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="GlORIE-SLAM on PyTorch/CUDA")
    parser.add_argument("config", type=str, help="path to scene config yaml")
    parser.add_argument("--only_tracking", action="store_true")
    parser.add_argument("--silence", action="store_true")
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--stride", type=int, default=None)
    parser.add_argument("--resume", type=str, default=None,
                        help="mid-run checkpoint (state.npz of "
                             "SLAM.save_state, or the JAX package's)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card; cpu on "
                             "request)")
    args = parser.parse_args(argv)

    from . import config as config_mod
    from .parallel import mesh as mesh_mod
    from .slam import SLAM
    from .utils.datasets import get_dataset

    cfg = config_mod.load_config(args.config, config_mod.DEFAULT_CONFIG_PATH)
    n = int(cfg["tracking"].get("mesh_devices", 0) or 0)
    if n > 1 and mesh_mod.active_group() is None:
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            mesh_mod.init_edge_group(n, device=args.device)
        else:
            from .parallel.launch import launch

            launch(_rank_main, n, args=(
                list(sys.argv[1:] if argv is None else argv),),
                device=args.device, timeout=SHARDED_RUN_TIMEOUT_S)
            return None
    group = mesh_mod.active_group()
    rank0 = group is None or group.rank == 0
    random.seed(cfg.get("setup_seed", 43))
    np.random.seed(cfg.get("setup_seed", 43))
    if args.only_tracking:
        cfg["only_tracking"] = True
    if args.silence:
        cfg["silence"] = True
        cfg["verbose"] = False
    if args.max_frames is not None:
        cfg["max_frames"] = args.max_frames
    if args.stride is not None:
        cfg["stride"] = args.stride

    output = f"{cfg['data']['output']}/{cfg['setting']}/{cfg['scene']}"
    os.makedirs(output, exist_ok=True)
    if rank0:
        config_mod.save_config(cfg, f"{output}/cfg.yaml")

    stream = get_dataset(cfg)
    slam = SLAM(cfg, stream, device=args.device)
    slam.run(resume_from=args.resume)
    return slam


def _rank_main(argv):
    """One rank of a sharded CLI run."""
    main(argv)


if __name__ == "__main__":
    main()
