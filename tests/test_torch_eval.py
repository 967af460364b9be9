"""Port parity: the end-of-run evaluations against the JAX package, on the
CPU.

* ``psnr``, ``ssim`` and ``ms_ssim`` (host numpy on both sides) on random
  images: 1e-5 relative (they agree to rounding).
* ``LPIPS`` against the JAX ``lpips``, fixed-seed ("untrained") and with an
  ``alexnet.pth`` / ``alex.pth`` pair the test writes in the torchvision
  and lpips layouts ("pretrained"): 1e-5 relative (the JAX side at float32
  matmul precision), and the same ``variant``.
* ``TSDFVolume.integrate`` of a tilted plane and of a sphere seen from a
  ring of cameras, in one slab and (the sphere) in 60: the TSDF, weights
  and colours equal to 1e-6; the meshes of ``extract_mesh`` equal as sorted
  vertex sets to 1e-9 and as face sets.
* PLY files written by either package read back by the other, exactly.
* ``render_mesh_depth`` (tensor ops here, a Python z-buffer loop there) on
  the sphere's mesh from three views: the same pixels covered, depth to
  1e-6 relative. ``calc_3d_metric`` (a sphere mesh against a shifted copy,
  ICP on) and ``calc_2d_metric`` (3 views, with a ``_pc_unseen.npy`` that
  forces redraws) from the same numpy seed: 1e-5 relative.
* End to end on a mapper over the true poses and depths of a 32x48 stream
  (``torch_parity.oracle_videos``; one padded 3000-ray batch per frame),
  two keyframes anchored on both sides and the JAX cloud's features and
  decoder weights carried across: ``eval_kf_imgs`` and ``eval_imgs``
  write the JAX package's files with its keys and dumps, the dumps to
  2e-4 on all but 2% of the pixels and the metrics to 5e-2 relative.
  Whole-frame renders agree so on all but 0.5% of the pixels at 64x96
  (``test_torch_mapper.py``): a near-cloud probe at the query radius may
  flip and move its ray. At 32x48 one ray is 0.07% of the frame, and the
  full-trajectory render takes its pose from each package's own
  quaternion-to-matrix, whose rounding moves splatted points across pixel
  borders too: 15 rays of 1536 differ, which moves the 2-scale MS-SSIM of
  the frame by 4% (PSNR by 0.2%); the metric functions themselves agree to
  1e-5 (above); ``generate_mesh_kf`` fuses
  the JAX run's keyframe dumps into the JAX run's mesh (sorted vertices
  to 1e-9, faces as sets).
"""

import contextlib
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from glorie_slam_tpu.mapping import mesher as jmesher
from glorie_slam_tpu.mapping import sampling as jsampling
from glorie_slam_tpu.mapping.mapper import Mapper as JMapper
from glorie_slam_tpu.utils import eval_recon as jrecon
from glorie_slam_tpu.utils import eval_render as jrender
from glorie_slam_tpu.utils import generate_mesh as jgen
from glorie_slam_tpu.utils import image_metrics as jim
from glorie_slam_tpu.utils.printer import Printer as JPrinter
from glorie_slam_tpu_torch.mapping import mesher
from glorie_slam_tpu_torch.mapping.mapper import Mapper
from glorie_slam_tpu_torch.nets.import_flax import \
    decoder_params_to_state_dict
from glorie_slam_tpu_torch.utils import (eval_recon, eval_render,
                                         generate_mesh, image_metrics)
from glorie_slam_tpu_torch.utils.printer import Printer
from synthetic import SyntheticStream, base_cfg
from torch_parity import SlamShim, jax_feature_draws, oracle_videos, t

F32 = "float32"


# ---------------------------------------------------------------------------
# image metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(48, 64, 3), (180, 200, 3), (64, 64)])
def test_psnr_ssim_ms_ssim_match_jax(shape):
    rng = np.random.default_rng(len(shape) + shape[0])
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    for name in ("psnr", "ssim", "ms_ssim"):
        ref = getattr(jim, name)(a, b)
        got = getattr(image_metrics, name)(a, b)
        np.testing.assert_allclose(got, ref, rtol=1e-5, err_msg=name)
    _, jmap = jim.ssim(a, b, full=True)
    _, pmap = image_metrics.ssim(a, b, full=True)
    np.testing.assert_allclose(pmap, jmap, rtol=1e-5, atol=1e-12)


def _write_lpips_weights(wdir, seed=3):
    """Random ``alexnet.pth`` (torchvision layout) and ``alex.pth`` (lpips
    layout) in ``wdir``."""
    rng = np.random.default_rng(seed)
    astate, lstate = {}, {}
    cin = 3
    for li, (ci, (cout, k, *_)) in enumerate(zip(
            image_metrics._ALEX_IDX, image_metrics._ALEX_CFG)):
        astate[f"features.{ci}.weight"] = torch.tensor(
            rng.normal(0, 0.1, (cout, cin, k, k)).astype(np.float32))
        astate[f"features.{ci}.bias"] = torch.tensor(
            rng.normal(0, 0.1, cout).astype(np.float32))
        lstate[f"lin{li}.model.1.weight"] = torch.tensor(
            rng.uniform(-0.05, 0.2, (1, cout, 1, 1)).astype(np.float32))
        cin = cout
    torch.save(astate, os.path.join(wdir, "alexnet.pth"))
    torch.save(lstate, os.path.join(wdir, "alex.pth"))


@pytest.fixture
def jax_lpips(monkeypatch):
    """The JAX package's LPIPS cache, emptied before and after a test that
    points ``$LPIPS_WEIGHTS`` elsewhere."""
    jim._LPIPS_STATE.clear()
    yield monkeypatch
    jim._LPIPS_STATE.clear()


@pytest.mark.parametrize("variant", ["untrained", "pretrained"])
def test_lpips_matches_jax(variant, tmp_path, jax_lpips):
    if variant == "pretrained":
        _write_lpips_weights(str(tmp_path))
    jax_lpips.setenv("LPIPS_WEIGHTS", str(tmp_path))
    rng = np.random.default_rng(7)
    a = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), 0, 1).astype(np.float32)
    lp = image_metrics.LPIPS()
    with jax.default_matmul_precision(F32):
        ref = jim.lpips(a, b)
        assert jim.lpips_variant() == lp.variant == variant
    np.testing.assert_allclose(float(lp(a, b)), ref, rtol=1e-5)
    assert float(lp(a, a)) == 0.0


# ---------------------------------------------------------------------------
# TSDF fusion, meshes, PLY files
# ---------------------------------------------------------------------------

def _look_at(origin, target):
    z = target - origin
    z = z / np.linalg.norm(z)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    T = np.eye(4)
    T[:3, :3] = np.stack([x, np.cross(z, x), z], 1)
    T[:3, 3] = origin
    return T


def _ray_depth(c2w, W, H, f, hit):
    """Depth image (camera z) of the first hit of ``hit(o, d) -> t``."""
    cx, cy = W / 2 - 0.5, H / 2 - 0.5
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    dirs = np.stack([(u - cx) / f, (v - cy) / f, np.ones_like(u)], -1)
    tt = hit(c2w[:3, 3], dirs @ c2w[:3, :3].T)
    return np.where(np.isfinite(tt) & (tt > 0), tt, 0.0).astype(np.float32)


def _sphere_hit(o, d, r=1.0):
    b = np.sum(d * o, -1) / np.sum(d * d, -1)
    c = (np.sum(o * o) - r * r) / np.sum(d * d, -1)
    disc = b * b - c
    return np.where(disc > 0, -b - np.sqrt(np.maximum(disc, 0)), np.inf)


def _plane_hit(o, d, n=np.array([0.2, -0.1, 1.0]), h=2.0):
    return (h - o @ n) / (d @ n)


SCENES = {
    # (bounds, voxel, frames: [(c2w, hit)], image W, H, f)
    "plane": (([-1.5, -1.0, 1.0], [1.5, 1.0, 3.0]), 0.05,
              [(_look_at(np.array([0.3 * i, 0.1, 0.0]),
                         np.array([0.0, 0.0, 2.0])), _plane_hit)
               for i in range(-2, 3)], 64, 48, 50.0),
    "sphere": (([-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]), 0.06,
               [(_look_at(np.array([3.0 * np.cos(a), 0.4, 3.0 * np.sin(a)]),
                          np.zeros(3)), _sphere_hit)
                for a in np.linspace(0, 2 * np.pi, 8, endpoint=False)],
               80, 60, 60.0),
}


def _fuse(scene, slab=None):
    """Both packages' volumes of ``scene``; the port's integrated and
    (``_extract``) extracted in slabs of ``slab`` voxels when given."""
    (bmin, bmax), voxel, frames, W, H, f = SCENES[scene]
    jvol = jmesher.TSDFVolume(bmin, bmax, voxel_size=voxel)
    vol = mesher.TSDFVolume(bmin, bmax, voxel_size=voxel, device="cpu")
    vol.slab = slab
    rng = np.random.default_rng(1)
    for c2w, hit in frames:
        depth = _ray_depth(c2w, W, H, f, hit)
        color = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
        intr = (f, f, W / 2 - 0.5, H / 2 - 0.5)
        jvol.integrate(depth, color, intr, c2w)
        with _slabs(slab):
            vol.integrate(depth, color, intr, c2w)
    return jvol, vol


@contextlib.contextmanager
def _slabs(slab):
    old = mesher.SLAB_VOXELS
    mesher.SLAB_VOXELS = slab or old
    try:
        yield
    finally:
        mesher.SLAB_VOXELS = old


def _extract(vol):
    with _slabs(vol.slab):
        return vol.extract_mesh()


def assert_same_mesh(a, b):
    """(verts, faces[, colours]) equal as sorted vertex sets (to 1e-9) and
    as face sets over them."""
    (va, fa), (vb, fb) = a[:2], b[:2]
    assert va.shape == vb.shape and fa.shape == fb.shape and len(fa) > 0
    # sorted on coordinates rounded to 1e-6: welded vertices may differ in
    # their last bits (means summed in another order)
    oa, ob = (np.lexsort(np.round(v * 1e6).T[::-1]) for v in (va, vb))
    np.testing.assert_allclose(va[oa], vb[ob], atol=1e-9)
    ra, rb = np.argsort(oa), np.argsort(ob)
    sa = {tuple(sorted(x)) for x in ra[fa].tolist()}
    sb = {tuple(sorted(x)) for x in rb[fb].tolist()}
    assert sa == sb


@pytest.fixture(scope="module", params=[("plane", None), ("sphere", None),
                                        ("sphere", 3000)])
def fused(request):
    return request.param[0], _fuse(*request.param)


def test_tsdf_integrate_and_extract_match_jax(fused):
    """In one slab and, for the sphere, in slabs of 3000 voxels (under
    one x-plane of its 51x51x51 volume: 60 slabs)."""
    _, (jvol, vol) = fused
    assert (vol.weight > 0).mean() > 0.01
    for name in ("tsdf", "weight", "color"):
        np.testing.assert_allclose(getattr(vol, name), getattr(jvol, name),
                                   atol=1e-6, err_msg=name)
    a, b = _extract(vol), jvol.extract_mesh()
    assert_same_mesh(a, b)
    np.testing.assert_allclose(np.sort(a[2], 0), np.sort(b[2], 0),
                               atol=1e-6)


def test_ply_files_cross_packages(fused, tmp_path):
    _, (jvol, _) = fused
    verts, faces, colors = jvol.extract_mesh()
    mine, theirs = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    mesher.write_ply_mesh(mine, verts, faces, colors)
    jmesher.write_ply_mesh(theirs, verts, faces, colors)
    with open(mine) as f1, open(theirs) as f2:
        assert f1.read() == f2.read()
    for a, b in ((jmesher.read_ply_mesh(mine), mesher.read_ply_mesh(theirs)),
                 (mesher.read_ply_mesh(mine), jmesher.read_ply_mesh(mine))):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# reconstruction metrics
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """The fused sphere's mesh, as the ground truth, and a copy shifted by
    2 cm and turned by 0.02 rad, as the reconstruction; the ground truth
    gets a ``_pc_unseen.npy`` of points some views must not see."""
    d = tmp_path_factory.mktemp("meshes")
    verts, faces, _ = _fuse("sphere")[0].extract_mesh()
    ang = 0.02
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    gt, rec = str(d / "gt.ply"), str(d / "rec.ply")
    jmesher.write_ply_mesh(gt, verts, faces)
    jmesher.write_ply_mesh(rec, verts @ R.T + [0.02, 0.0, 0.0], faces)
    np.save(str(d / "gt_pc_unseen.npy"),
            np.array([[0.0, 0.0, 1.0], [0.0, 0.9, 0.0]]))
    return gt, rec, verts, faces


def test_render_mesh_depth_matches_jax(meshes):
    _, _, verts, faces = meshes
    for c2w in (_look_at(np.array([0.0, 0.3, -3.0]), np.zeros(3)),
                _look_at(np.array([2.0, -1.0, 1.5]), np.array([0.2, 0, 0])),
                _look_at(np.array([0.0, 0.0, 0.5]), np.array([0, 0, 3.0]))):
        ref = jrecon.render_mesh_depth(verts, faces, c2w, W=64, H=48,
                                       fx=40.0, fy=40.0)
        got = eval_recon.render_mesh_depth(verts, faces, c2w, W=64, H=48,
                                           fx=40.0, fy=40.0, device="cpu")
        np.testing.assert_array_equal(got > 0, ref > 0)
        np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert (got > 0).mean() > 0.2


def test_calc_3d_metric_matches_jax(meshes):
    gt, rec, _, _ = meshes
    np.random.seed(0)
    ref = jrecon.calc_3d_metric(rec, gt, n_samples=20000)
    np.random.seed(0)
    got = eval_recon.calc_3d_metric(rec, gt, n_samples=20000)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    assert 0 < got["accuracy"] < 5


def test_calc_2d_metric_matches_jax(meshes):
    gt, rec, _, _ = meshes
    np.random.seed(1)
    ref = jrecon.calc_2d_metric(rec, gt, n_imgs=3, seed=2)
    state = np.random.get_state()
    np.random.seed(1)
    got = eval_recon.calc_2d_metric(rec, gt, n_imgs=3, seed=2, device="cpu")
    # the same number of numpy draws: the same views were redrawn
    assert np.random.get_state()[2] == state[2]
    assert got.keys() == ref.keys() == {"depth l1"}
    np.testing.assert_allclose(got["depth l1"], ref["depth l1"], rtol=1e-5)
    assert np.isfinite(got["depth l1"])


# ---------------------------------------------------------------------------
# end to end on an oracle-video mapper
# ---------------------------------------------------------------------------

H, W = 32, 48
KEYFRAMES = (0, 2)           # mapped; video.npz holds frames 0-2


def _read_metrics(path):
    with open(path) as f:
        rows = [line.split(": ", 1) for line in f.read().splitlines()]
    return {k: v for k, v in rows}


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    """Both packages' mappers over the same true state, two keyframes
    anchored, the JAX features and decoder weights carried across, the
    true trajectory as ``video.npz`` and ``traj/full_traj_w2c.npy`` and the
    true depths as cached priors; then ``eval_kf_imgs`` and ``eval_imgs``
    on each side. Yields (JAX mapper, port mapper, stream)."""
    tmp = str(tmp_path_factory.mktemp("eval"))
    stream = SyntheticStream(n_frames=3, H=H, W=W, seed=5)
    cfgs = {}
    for side in ("jax", "port"):
        cfg = base_cfg(H=H, W=W, buffer=16, out=os.path.join(tmp, side))
        cfg["only_tracking"] = False
        cfg["mapping"]["every_frame"] = 3      # renders frame 0
        cfgs[side] = cfg
        priors = os.path.join(tmp, side, "synth_priors", "depths")
        os.makedirs(priors)
        for i, d in enumerate(stream.depths):
            np.save(os.path.join(priors, f"{i:05d}.npy"), d)
    jv, pv = oracle_videos(stream, cfgs["jax"], len(stream))
    jm = JMapper(SlamShim(cfgs["jax"], stream, jv, JPrinter(0, True)),
                 cfgs["jax"])
    pm = Mapper(SlamShim(cfgs["port"], stream, pv, Printer(0, True)),
                cfgs["port"])
    pm.npc._draw_features = jax_feature_draws(cfgs["jax"]["setup_seed"],
                                              pm.npc.c_dim)
    for m in (jm, pm):
        for k in KEYFRAMES:
            m.dynamic_r_add, m.dynamic_r_query = (
                jsampling.dynamic_radius_maps(stream.frames[k], m.cfg))
            m.r_query_store[k] = m.dynamic_r_query
            c2w, _, droid = m.get_c2w_and_depth(k, k, None)
            m.anchor_points(np.array(droid), stream.frames[k], c2w, k)
            m.keyframe_dict.append({"idx": k, "video_idx": k,
                                    "mono_depth": None})
        os.makedirs(f"{m.output}/traj", exist_ok=True)
        np.save(f"{m.output}/traj/full_traj_w2c.npy",
                np.stack(stream.poses_w2c).astype(np.float32))
        np.savez(f"{m.output}/video.npz", poses=np.stack(stream.poses),
                 timestamps=np.arange(len(stream), dtype=np.float32))
    assert pm.npc.count == jm.npc.count > 0
    pm.npc.geo_feats.copy_(t(np.asarray(jm.npc.geo_feats)))
    pm.npc.col_feats.copy_(t(np.asarray(jm.npc.col_feats)))
    pm.decoders.load_state_dict(decoder_params_to_state_dict(jm.dec_params))
    mp = pytest.MonkeyPatch()
    mp.setenv("LPIPS_WEIGHTS", tmp)
    jim._LPIPS_STATE.clear()
    try:
        with jax.default_matmul_precision(F32):
            jrender.eval_kf_imgs(jm)
            jrender.eval_imgs(jm)
        assert eval_render.eval_kf_imgs(pm) == len(KEYFRAMES)
        assert eval_render.eval_imgs(pm) == 1
    finally:
        jim._LPIPS_STATE.clear()
        mp.undo()
    yield jm, pm, stream


@pytest.mark.parametrize("name,dump_dir", [
    ("metrics_render_kf.txt", "rendered_every_keyframe"),
    ("metrics_render_full.txt", "rendered_every_frame")])
def test_render_evaluations_match_jax(evaluated, name, dump_dir):
    jm, pm, _ = evaluated
    ref = _read_metrics(f"{jm.output}/logs/{name}")
    got = _read_metrics(f"{pm.output}/logs/{name}")
    assert list(got) == list(ref)
    for k, v in ref.items():
        if k == "lpips_variant":
            assert got[k] == v == "untrained"
        else:
            np.testing.assert_allclose(float(got[k]), float(v), rtol=5e-2,
                                       err_msg=k)
    files = sorted(os.listdir(f"{pm.output}/{dump_dir}"))
    assert files == sorted(os.listdir(f"{jm.output}/{dump_dir}")) and files
    for f in files:
        a = np.load(f"{pm.output}/{dump_dir}/{f}")
        b = np.load(f"{jm.output}/{dump_dir}/{f}")
        assert a.shape == b.shape
        off = np.abs(a - b) > 2e-4 + 2e-4 * np.abs(b)
        if a.ndim == 3:
            off = off.any(-1)
        assert off.mean() <= 0.02, (f, off.sum())


def test_generate_mesh_kf_matches_jax(evaluated):
    """Both packages fuse the JAX run's keyframe dumps (the port's own
    differ from them by the renders' rounding, see above) at the true
    trajectory's alignment: the same mesh file."""
    jm, pm, stream = evaluated
    shutil.rmtree(f"{pm.output}/rendered_every_keyframe")
    shutil.copytree(f"{jm.output}/rendered_every_keyframe",
                    f"{pm.output}/rendered_every_keyframe")
    ref = jgen.generate_mesh_kf(jm.cfg, stream=stream)
    got = generate_mesh.generate_mesh_kf(pm.cfg, stream=stream, device="cpu")
    assert len(got[0]) > 100
    assert_same_mesh(got, ref)
    path = "mesh/rendered_mesh_kf.ply"
    assert_same_mesh(mesher.read_ply_mesh(f"{pm.output}/{path}"),
                     jmesher.read_ply_mesh(f"{jm.output}/{path}"))
