"""Dataset readers: Replica, ScanNet, 7-Scenes and TUM-RGBD.

Counterpart of ``glorie_slam_tpu/utils/datasets.py``. A frame is
``(index, color (H, W, 3) float32 RGB in [0, 1], depth (H, W) float32 or
None, c2w (4, 4) or None)``, resized (colour bilinear, depth nearest) and
cropped to the configured output camera. The images are read, resized
and undistorted by OpenCV, as the JAX package reads them; ``cv2`` is
imported at the first frame read, and without it that read raises an
``ImportError`` naming it. ``load_mono_depth`` reads the cached mono-depth
priors.
"""

import glob
import os

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "reading dataset frames needs OpenCV (cv2), which is not "
            "installed") from e
    return cv2


def load_mono_depth(idx, cfg):
    """A cached mono-depth prior, ``{data.output}/{scene}_priors/depths/
    {idx:05d}.npy`` (reference datasets.py:10-15)."""
    dir_path = f"{cfg['data']['output']}/{cfg['scene']}_priors/depths"
    return np.load(f"{dir_path}/{int(idx):05d}.npy")


class BaseDataset:
    def __init__(self, cfg):
        self.name = cfg["dataset"]
        cam = cfg["cam"]
        self.png_depth_scale = cam.get("png_depth_scale")
        self.n_img = -1
        self.depth_paths = None
        self.color_paths = None
        self.poses = None
        self.H, self.W = cam["H"], cam["W"]
        self.fx, self.fy = cam["fx"], cam["fy"]
        self.cx, self.cy = cam["cx"], cam["cy"]
        self.H_out, self.W_out = cam["H_out"], cam["W_out"]
        self.H_edge, self.W_edge = cam["H_edge"], cam["W_edge"]
        self.distortion = (np.array(cam["distortion"])
                           if "distortion" in cam else None)
        self.input_folder = os.path.expandvars(cfg["data"]["input_folder"])

    def __len__(self):
        return self.n_img

    def _crop(self, img):
        if self.W_edge > 0:
            img = img[:, self.W_edge:-self.W_edge]
        if self.H_edge > 0:
            img = img[self.H_edge:-self.H_edge]
        return img

    def _size(self):
        return (self.W_out + self.W_edge * 2, self.H_out + self.H_edge * 2)

    def _read_color(self, index):
        cv2 = _cv2()
        color = cv2.imread(self.color_paths[index])
        if self.distortion is not None:
            K = np.eye(3)
            K[0, 0], K[0, 2] = self.fx, self.cx
            K[1, 1], K[1, 2] = self.fy, self.cy
            color = cv2.undistort(color, K, self.distortion)
        color = cv2.resize(color, self._size())
        color = color[..., ::-1].astype(np.float32) / 255.0     # BGR -> RGB
        return np.ascontiguousarray(self._crop(color))

    def _read_depth(self, index):
        if self.depth_paths is None:
            return None
        path = self.depth_paths[index]
        if ".png" not in path:
            raise TypeError(path)
        cv2 = _cv2()
        depth = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        depth = depth.astype(np.float32) / self.png_depth_scale
        return self._crop(cv2.resize(depth, self._size(),
                                     interpolation=cv2.INTER_NEAREST))

    def get_color(self, index):
        return self._read_color(index)

    def get_intrinsic(self):
        """Output-camera [fx, fy, cx, cy] (reference datasets.py:85-96)."""
        W_e, H_e = self._size()
        intr = np.array([self.fx, self.fy, self.cx, self.cy], np.float32)
        intr[[0, 2]] *= W_e / self.W
        intr[[1, 3]] *= H_e / self.H
        intr[2] -= self.W_edge
        intr[3] -= self.H_edge
        return intr

    def __getitem__(self, index):
        color = self._read_color(index)
        depth = self._read_depth(index)
        pose = (self.poses[index].astype(np.float32)
                if self.poses is not None else None)
        return index, color, depth, pose

    def _stride(self, cfg, max_frames):
        """Cut the path and pose lists to ``max_frames`` then take every
        ``stride``-th."""
        stride = cfg["stride"]
        for name in ("color_paths", "depth_paths", "poses"):
            setattr(self, name, getattr(self, name)[:max_frames][::stride])
        self.n_img = len(self.color_paths)


class Replica(BaseDataset):
    """reference datasets.py:140-168: ``results/frame*.jpg``,
    ``results/depth*.png``, ``traj.txt`` (one 4x4 row-major c2w a line)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.color_paths = sorted(
            glob.glob(f"{self.input_folder}/results/frame*.jpg"))
        self.depth_paths = sorted(
            glob.glob(f"{self.input_folder}/results/depth*.png"))
        self.n_img = len(self.color_paths)
        max_frames = cfg["max_frames"]
        max_frames = self.n_img if max_frames < 0 else max_frames
        with open(f"{self.input_folder}/traj.txt") as f:
            lines = f.readlines()
        self.poses = [np.array(list(map(float, lines[i].split()))
                               ).reshape(4, 4) for i in range(self.n_img)]
        self._stride(cfg, max_frames)


class ScanNet(BaseDataset):
    """reference datasets.py:170-202: ``color/*.jpg``, ``depth/*.png``,
    ``pose/*.txt``, sorted by frame number."""

    def __init__(self, cfg):
        super().__init__(cfg)

        def key(x):
            return int(os.path.basename(x).split(".")[0])

        def listing(sub, ext):
            return sorted(glob.glob(os.path.join(self.input_folder, sub,
                                                 f"*.{ext}")), key=key)

        self.color_paths = listing("color", "jpg")
        self.depth_paths = listing("depth", "png")
        self.n_img = len(self.color_paths)
        max_frames = cfg["max_frames"]
        max_frames = self.n_img if max_frames < 0 else max_frames
        self.poses = [np.loadtxt(p).reshape(4, 4)
                      for p in listing("pose", "txt")]
        self._stride(cfg, max_frames)


class SevenScenes(BaseDataset):
    """reference datasets.py:204-229: ``*.color.png``, ``*.depth.png`` and
    ``*.pose.txt`` (else ``*.txt``) in one folder."""

    def __init__(self, cfg):
        super().__init__(cfg)

        def listing(pattern):
            return sorted(glob.glob(os.path.join(self.input_folder, pattern)))

        self.color_paths = listing("*.color.png")
        self.depth_paths = listing("*.depth.png")
        self.n_img = len(self.color_paths)
        max_frames = cfg["max_frames"]
        max_frames = self.n_img if max_frames < 0 else max_frames
        pose_paths = listing("*.pose.txt") or listing("*.txt")
        self.poses = [np.loadtxt(p).astype(np.float32) for p in pose_paths]
        self._stride(cfg, max_frames)


class TUM_RGBD(BaseDataset):
    """reference datasets.py:231-326: ``rgb.txt``, ``depth.txt`` and
    ``groundtruth.txt`` (else ``pose.txt``) associated by timestamp within
    0.08 s, subsampled to 32 frames per second, poses made relative to the
    first frame."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.color_paths, self.depth_paths, self.poses = self._loadtum(
            self.input_folder, frame_rate=32)
        self._stride(cfg, cfg["max_frames"])

    @staticmethod
    def _parse_list(filepath, skiprows=0):
        return np.loadtxt(filepath, delimiter=" ", dtype=np.str_,
                          skiprows=skiprows)

    @staticmethod
    def _associate(t_img, t_depth, t_pose, max_dt=0.08):
        assoc = []
        for i, t in enumerate(t_img):
            j = np.argmin(np.abs(t_depth - t))
            k = np.argmin(np.abs(t_pose - t))
            if abs(t_depth[j] - t) < max_dt and abs(t_pose[k] - t) < max_dt:
                assoc.append((i, j, k))
        return assoc

    def _loadtum(self, datapath, frame_rate=-1):
        from scipy.spatial.transform import Rotation

        pose_list = os.path.join(datapath, "groundtruth.txt")
        if not os.path.isfile(pose_list):
            pose_list = os.path.join(datapath, "pose.txt")
        image_data = self._parse_list(os.path.join(datapath, "rgb.txt"))
        depth_data = self._parse_list(os.path.join(datapath, "depth.txt"))
        pose_data = self._parse_list(pose_list, skiprows=1)
        pose_vecs = pose_data[:, 1:].astype(np.float64)
        t_img = image_data[:, 0].astype(np.float64)
        t_depth = depth_data[:, 0].astype(np.float64)
        t_pose = pose_data[:, 0].astype(np.float64)
        assoc = self._associate(t_img, t_depth, t_pose)

        indices = [0]
        for i in range(1, len(assoc)):
            t0 = t_img[assoc[indices[-1]][0]]
            t1 = t_img[assoc[i][0]]
            if t1 - t0 > 1.0 / frame_rate:
                indices.append(i)

        images, depths, poses = [], [], []
        inv_pose = None
        for ix in indices:
            i, j, k = assoc[ix]
            images.append(os.path.join(datapath, str(image_data[i, 1])))
            depths.append(os.path.join(datapath, str(depth_data[j, 1])))
            pv = pose_vecs[k]
            c2w = np.eye(4)
            c2w[:3, :3] = Rotation.from_quat(pv[3:]).as_matrix()
            c2w[:3, 3] = pv[:3]
            if inv_pose is None:
                inv_pose = np.linalg.inv(c2w)
                c2w = np.eye(4)
            else:
                c2w = inv_pose @ c2w
            poses.append(c2w)
        return images, depths, poses


dataset_dict = {
    "replica": Replica,
    "scannet": ScanNet,
    "tumrgbd": TUM_RGBD,
    "7scenes": SevenScenes,
}


def get_dataset(cfg) -> BaseDataset:
    return dataset_dict[cfg["dataset"]](cfg)
