"""The benchmark's synthetic scene, rendered on the device from the seed.

A textured plane z = ``PLANE_Z`` seen along bench.py's circuit (along +x and
back, so late frames revisit early ones and loop closure fires), as the
port's ``utils/synthetic.SyntheticStream`` draws it, rendered here in torch
on the device: the texture from the run's seed, the path's small rotation
jitter from the traffic's own ``path_seed`` (so that every seed sends the
same path). The frames go to the host once, because ``Tracker.step`` takes
host images.
"""

import numpy as np
import torch

from .reference import lie

PLANE_Z = 3.0


def output_camera(cam):
    """Output intrinsics after the reader's resize and crop (as the port's
    ``slam.update_cam``) -> (H_out, W_out, [fx, fy, cx, cy])."""
    H, W = cam["H"], cam["W"]
    he, we = cam["H_edge"], cam["W_edge"]
    Ho, Wo = cam["H_out"], cam["W_out"]
    return Ho, Wo, [cam["fx"] * (Wo + we * 2) / W,
                    cam["fy"] * (Ho + he * 2) / H,
                    cam["cx"] * (Wo + we * 2) / W - we,
                    cam["cy"] * (Ho + he * 2) / H - he]


def texture(seed, device, size=256):
    """Smooth random RGB texture in [0, 1] (two 5-point averages)."""
    g = torch.Generator(device=device).manual_seed(seed)
    tex = torch.rand((size, size, 3), generator=g, device=device)
    for _ in range(2):
        tex = (tex.roll(1, 0) + tex.roll(-1, 0) + tex.roll(1, 1)
               + tex.roll(-1, 1) + tex) / 5.0
    return (tex - tex.min()) / (tex.max() - tex.min())


def circuit_poses(n, path_seed, motion_scale):
    """World-to-camera poses (n, 7) along the circuit, float32 on the CPU."""
    rng = np.random.default_rng(path_seed)
    t = np.linspace(0, 2 * np.pi, n)
    xi = np.zeros((n, 6))
    xi[:, 0] = 2.0 * np.sin(t / 2) ** 2
    xi[:, 1] = 0.15 * np.sin(t)
    xi[:, 2] = 0.1 * np.sin(t)
    xi[:, 3:] = rng.normal(size=(n, 3)) * motion_scale * 0.2
    return lie.exp(torch.as_tensor(xi, dtype=torch.float32))


@torch.no_grad()
def render(c2w, intr, H, W, tex, tex_scale=50.0):
    """Frames of the plane from c2w (n, 4, 4) -> rgb (n, H, W, 3), depth
    (n, H, W), on ``tex``'s device."""
    dev = tex.device
    fx, fy, cx, cy = intr
    v, u = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                          torch.arange(W, device=dev, dtype=torch.float32),
                          indexing="ij")
    dirs = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], -1)
    R, o = c2w[:, :3, :3], c2w[:, :3, 3]
    dw = torch.einsum("hwj,nij->nhwi", dirs, R)
    t = (PLANE_Z - o[:, None, None, 2]) / dw[..., 2]
    pts = o[:, None, None] + t[..., None] * dw
    depth = torch.einsum("nhwi,nij->nhwj", pts - o[:, None, None], R)[..., 2]
    size = tex.shape[0]
    tu = torch.remainder(pts[..., 0] * tex_scale, size)
    tv = torch.remainder(pts[..., 1] * tex_scale, size)
    i0 = torch.floor(tv).long() % size
    j0 = torch.floor(tu).long() % size
    i1, j1 = (i0 + 1) % size, (j0 + 1) % size
    fv = (tv - torch.floor(tv))[..., None]
    fu = (tu - torch.floor(tu))[..., None]
    rgb = (tex[i0, j0] * (1 - fv) * (1 - fu) + tex[i0, j1] * (1 - fv) * fu
           + tex[i1, j0] * fv * (1 - fu) + tex[i1, j1] * fv * fu)
    return rgb, depth


class LoopStream:
    """Frames of one circuit, repeated: ``stream[i]`` is (i, rgb (H, W, 3),
    depth (H, W), c2w (4, 4)) of circuit frame ``i % n``, all numpy; the
    interface ``SLAM``, ``Tracker`` and ``Mapper`` read."""

    def __init__(self, rgb, depth, poses_w2c, c2w, intrinsics, length):
        self.frames, self.depths = list(rgb), list(depth)
        self.poses_w2c = poses_w2c
        self.n = len(self.frames)
        self.poses = [c2w[i % self.n] for i in range(length)]
        self.intrinsics = np.asarray(intrinsics, np.float32)
        self.length = length

    def __len__(self):
        return self.length

    def get_intrinsic(self):
        return self.intrinsics

    def __getitem__(self, i):
        k = i % self.n
        return i, self.frames[k], self.depths[k], self.poses[i]


def make_stream(cfg, traffic, seed, device, length):
    """The circuit of ``traffic["frames"]`` frames at the configuration's
    output size, rendered on ``device`` from ``seed``."""
    H, W, intr = output_camera(cfg["cam"])
    poses = circuit_poses(traffic["frames"], traffic["path_seed"],
                          traffic["motion_scale"])
    c2w = lie.to_matrix(lie.inv(poses))
    rgb, depth = render(c2w.to(device), intr, H, W,
                        texture(seed, device))
    return LoopStream(rgb.cpu().numpy(), depth.cpu().numpy(),
                      poses.numpy(), c2w.numpy(), intr, length)
