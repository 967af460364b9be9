"""Helpers for the port's parity tests: move numpy inputs into both
packages and results back to numpy.

Importing this module sets one intra-op torch thread for the test process:
the quick tier runs six test processes on the CPU at once, and each
process's own team of threads per core (two teams where two of its threads
run torch at once, as the asynchronous mapper's worker beside the tracker)
oversubscribed the cores several times over. The tests' tensors are small.
"""

import numpy as np
import torch

torch.set_num_threads(1)


def t(x, dtype=torch.float32):
    """numpy -> CPU torch tensor."""
    return torch.as_tensor(np.array(x), dtype=dtype)


def n(x):
    """JAX array or torch tensor -> float64-free numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def random_poses(rng, N, scale=0.1):
    """(N, 6) twists for lie.exp on both sides."""
    return (rng.normal(size=(N, 6)) * scale).astype(np.float32)


def oracle_videos(stream, cfg, n):
    """A JAX and a port ``DepthVideo`` (CPU) holding frames 0..n-1 of a
    synthetic stream at their true poses and full-resolution depths, every
    pixel valid and every frame marked for re-anchoring: the state the
    mapper reads, without a tracker. The port's is
    ``utils/synthetic.oracle_video``'s."""
    import jax.numpy as jnp

    from glorie_slam_tpu.core.depth_video import DepthVideo as JVideo
    from glorie_slam_tpu_torch.utils.synthetic import oracle_video

    jv = JVideo(cfg)
    zeros = jnp.zeros((jv.h8, jv.w8, 128))
    for k in range(n):
        depth = stream.depths[k]
        jv.append(k, jnp.asarray((stream.frames[k] * 255).astype(np.uint8)),
                  jnp.asarray(stream.poses_w2c[k]),
                  jnp.asarray(1.0 / depth[3::8, 3::8]), None,
                  stream.intrinsics / 8.0, zeros, zeros, zeros)
        jv.disps_up = jv.disps_up.at[k].set(jnp.asarray(1.0 / depth))
    jv.valid_depth_mask = jv.valid_depth_mask.at[:n].set(True)
    jv.dirty[:n] = False
    jv.npc_dirty[:n] = True
    return jv, oracle_video(stream, cfg, n, "cpu")


def jax_feature_draws(seed, c_dim):
    """The JAX ``NeuralPointCloud``'s feature draws, call by call, as a
    replacement for the port cloud's ``_draw_features``: the same key chain
    from ``PRNGKey(seed)``, so both clouds get the same features."""
    import jax

    state = {"key": jax.random.PRNGKey(seed)}

    def draw(n):
        state["key"], sub = jax.random.split(state["key"])
        k1, k2 = jax.random.split(sub)
        return (t(0.1 * np.asarray(jax.random.normal(k1, (n, c_dim)))),
                t(0.1 * np.asarray(jax.random.normal(k2, (n, c_dim)))))

    return draw


class SlamShim:
    """What a mapper reads of its SLAM object (either package's)."""

    def __init__(self, cfg, stream, video, printer):
        import os

        from glorie_slam_tpu_torch.slam import update_cam

        self.cfg, self.stream, self.video = cfg, stream, video
        self.printer, self.logger = printer, None
        self.output = (f"{cfg['data']['output']}/{cfg['setting']}/"
                       f"{cfg['scene']}")
        os.makedirs(f"{self.output}/logs", exist_ok=True)
        self.H, self.W, self.fx, self.fy, self.cx, self.cy = update_cam(cfg)


def fail_on_rank_1(_):
    """An edge-group rank function (``parallel.launch``) that fails on rank
    1 while rank 0 waits for it in a collective."""
    from glorie_slam_tpu_torch.parallel import mesh

    if mesh.active_group().rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    mesh.active_group().all_gather(torch.zeros(1))
