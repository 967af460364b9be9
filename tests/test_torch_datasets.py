"""The port's dataset readers (``utils/datasets.py``) against the JAX
package's. Both read, undistort and resize through ``cv2``, so every
comparison is exact: ``get_dataset`` on fixtures of the four layouts
written here (Replica and ScanNet JPEG colour, 7-Scenes with edges, TUM
with distortion, timestamp association and the 32 fps subsample), with
``stride`` and ``max_frames``, gives equal paths, poses, intrinsics, depth
and colour. Without ``cv2`` a frame read raises an ``ImportError`` that
names it.
"""

import os
import sys

import cv2
import numpy as np
import pytest

from glorie_slam_tpu.utils import datasets as jdatasets
from glorie_slam_tpu_torch.utils import datasets
from glorie_slam_tpu_torch.utils.synthetic import SyntheticStream, \
    write_7scenes

def _same(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the four layouts
# ---------------------------------------------------------------------------

H, W = 60, 80


def _cam(**kw):
    cam = {"H": H, "W": W, "fx": 64.0, "fy": 63.5, "cx": 39.5, "cy": 29.5,
           "H_out": 48, "W_out": 64, "H_edge": 4, "W_edge": 4,
           "png_depth_scale": 1000.0}
    cam.update(kw)
    return cam


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    colors = rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8)
    depths = rng.integers(0, 6000, (n, H, W), dtype=np.uint16)
    depths[:, :3, :5] = 0
    poses = []
    for _ in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = q * np.sign(np.linalg.det(q)), rng.normal(
            size=3)
        poses.append(T)
    return colors, depths, poses


def _replica(root, n=7):
    colors, depths, poses = _frames(n, 3)
    os.makedirs(root / "results")
    for i in range(n):
        cv2.imwrite(str(root / "results" / f"frame{i:06d}.jpg"), colors[i])
        cv2.imwrite(str(root / "results" / f"depth{i:06d}.png"), depths[i])
    np.savetxt(root / "traj.txt", np.stack([p.reshape(-1) for p in poses]))
    return {"dataset": "replica", "cam": _cam(png_depth_scale=6553.5)}


def _scannet(root, n=12):
    colors, depths, poses = _frames(n, 4)
    for sub in ("color", "depth", "pose"):
        os.makedirs(root / sub)
    for i in range(n):                         # 10 sorts after 9, not 1
        cv2.imwrite(str(root / "color" / f"{i}.jpg"), colors[i])
        cv2.imwrite(str(root / "depth" / f"{i}.png"), depths[i])
        np.savetxt(root / "pose" / f"{i}.txt", poses[i])
    return {"dataset": "scannet", "cam": _cam(H_edge=2, W_edge=6)}


def _sevenscenes(root, n=7):
    stream = SyntheticStream(n_frames=n, H=H, W=W, seed=5,
                             trajectory="circuit")
    write_7scenes(str(root), stream)
    return {"dataset": "7scenes", "cam": _cam()}


def _tum(root, n=9):
    colors, depths, poses = _frames(n, 6)
    os.makedirs(root / "rgb")
    os.makedirs(root / "depth")
    t = 100.0 + np.arange(n) / 60.0            # 60 fps: the subsample drops
    t[5] += 0.2                                 # ... and frame 5 has no depth
    rgb, dep, gt = ["# rgb"], ["# depth"], ["# tx ty tz qx qy qz qw"]
    for i in range(n):
        cv2.imwrite(str(root / "rgb" / f"{t[i]:.6f}.png"), colors[i])
        cv2.imwrite(str(root / "depth" / f"{t[i]:.6f}.png"), depths[i])
        rgb.append(f"{t[i]:.6f} rgb/{t[i]:.6f}.png")
        dep.append(f"{t[i] + (0.3 if i == 5 else 0.01):.6f} "
                   f"depth/{t[i]:.6f}.png")
    from scipy.spatial.transform import Rotation
    for i in range(n):
        q = Rotation.from_matrix(poses[i][:3, :3]).as_quat()
        vals = " ".join(f"{v:.6f}" for v in (*poses[i][:3, 3], *q))
        gt.append(f"{t[i] - 0.005:.6f} {vals}")
    for name, lines in (("rgb.txt", rgb), ("depth.txt", dep),
                        ("groundtruth.txt", gt)):
        (root / name).write_text("\n".join(lines) + "\n")
    return {"dataset": "tumrgbd",
            "cam": _cam(distortion=[0.2624, -0.9531, -0.0054, 0.0026,
                                    1.1633])}


LAYOUTS = {"replica": _replica, "scannet": _scannet, "7scenes": _sevenscenes,
           "tumrgbd": _tum}


@pytest.mark.parametrize("layout,stride,max_frames", [
    ("replica", 1, -1), ("replica", 2, 5), ("scannet", 3, -1),
    ("scannet", 1, 11), ("7scenes", 1, -1), ("7scenes", 2, 6),
    ("tumrgbd", 1, -1), ("tumrgbd", 2, 4)])
def test_get_dataset_equals_jax(layout, stride, max_frames, tmp_path):
    cfg = LAYOUTS[layout](tmp_path)
    cfg.update(stride=stride, max_frames=max_frames,
               data={"input_folder": str(tmp_path)})
    want, got = jdatasets.get_dataset(cfg), datasets.get_dataset(cfg)
    assert type(got).__name__ == type(want).__name__
    assert len(got) == len(want) > 0
    assert got.color_paths == want.color_paths
    assert got.depth_paths == want.depth_paths
    assert _same(got.get_intrinsic(), want.get_intrinsic())
    for i in range(len(want)):
        a, b = got[i], want[i]
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            assert _same(x, y), i
    assert a[1].shape == (48, 64, 3) and a[1].dtype == np.float32


def test_frames_without_cv2_raise_naming_it(tmp_path, monkeypatch):
    cfg = _sevenscenes(tmp_path, n=2)
    cfg.update(stride=1, max_frames=-1, data={"input_folder": str(tmp_path)})
    ds = datasets.get_dataset(cfg)
    monkeypatch.setitem(sys.modules, "cv2", None)      # import cv2 fails
    for read in (ds.__getitem__, ds._read_depth):
        with pytest.raises(ImportError, match=r"cv2"):
            read(0)


def test_load_mono_depth_reads_the_cache(tmp_path):
    cfg = {"data": {"output": str(tmp_path)}, "scene": "s"}
    os.makedirs(tmp_path / "s_priors" / "depths")
    d = np.random.default_rng(0).random((4, 5)).astype(np.float32)
    np.save(tmp_path / "s_priors" / "depths" / "00007.npy", d)
    assert _same(datasets.load_mono_depth(7, cfg),
                 jdatasets.load_mono_depth(7, cfg))
