"""The port's edge sharding (``glorie_slam_tpu_torch/parallel``) on CPU
ranks: gloo, one process and one torch thread per rank, started by
``parallel.launch`` (a rendezvous file, a timeout on every collective and
on the join).

The ranks run the seeded problems of ``tests/torch_drills.py`` (a module
that imports no JAX: the spawned ranks import it by name) and are held against
the same problem on one rank, in this process, and, for the tracking step,
against the JAX ``tracking_step`` on a 4-device mesh of the 8 virtual CPU
devices that ``conftest.py`` provides. The bounds are the JAX package's
own for its mesh (``tests/test_parallel.py``): the step within 1e-5 of one
rank; 12 DSPO rounds within poses 5e-4, damping 1e-4, disparities 5e-3
(pose_depth) or 1e-2 (DSPO), scale 1e-1 and shift 5e-2, under 2% of
validity flips, scale and validity bitwise for pose_depth; the backend's
GRU sweep bitwise; ``dense_ba(steps=2)`` within poses 1e-5 and disparities
1e-4. Every rank ends bitwise equal to the others.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import torch_drills as drills
import torch_parity  # one torch thread
from glorie_slam_tpu.parallel import mesh as jmesh
from glorie_slam_tpu.parallel.step import tracking_step as jstep
from glorie_slam_tpu_torch.core.depth_video import DepthVideo
from glorie_slam_tpu_torch.nets.import_flax import flax_params_to_state_dict
from glorie_slam_tpu_torch.parallel import launch, mesh
from glorie_slam_tpu_torch.slam import SLAM
from glorie_slam_tpu_torch.utils.synthetic import SyntheticStream, base_cfg

TIMEOUT = 240


def _ranks(fn, n, spec):
    return launch.launch(fn, n, args=(spec,), device="cpu", threads=1,
                         timeout=TIMEOUT)


def _batch(n, checks):
    """Several drills on n ranks in one launch (``drills.card_drill``):
    {name: every rank's result}."""
    outs = _ranks(drills.card_drill, n, {"checks": checks})
    return {name: [o[name]["det"] for o in outs] for name in checks}


def _same_on_every_rank(outs, keys):
    for k in keys:
        for r, o in enumerate(outs[1:], 1):
            np.testing.assert_array_equal(
                outs[0][k], o[k], err_msg=f"rank {r} differs in {k}")


# ---------------------------------------------------------------------------
# the tracking step (GRU update + BA with the RGB-D term)
# ---------------------------------------------------------------------------

STEP_KEYS = ("poses", "disps", "net", "target", "weight", "eta_agg",
             "upmask")


@pytest.fixture(scope="module")
def problem():
    """``__graft_entry__._example_problem`` (16 edges over frames 0-7 of a
    16-frame buffer, the JAX net in bf16) with sensor disparities on half
    the pixels, and the same inputs for the port."""
    args, statics = graft._example_problem(E=16)
    rng = np.random.default_rng(3)
    disps = np.asarray(args["disps"])
    sensor = np.where(rng.random(disps.shape) < 0.5,
                      disps * (1 + 0.05 * rng.normal(size=disps.shape)),
                      0.0).astype(np.float32)
    args["sensor_disps"] = jnp.asarray(sensor)
    N, h, w = disps.shape
    f32 = np.float32
    inputs = dict(
        state_dict={k: v.float().numpy() for k, v in flax_params_to_state_dict(
            jax.tree_util.tree_map(np.asarray, args["params"])).items()},
        dtype=torch.bfloat16,
        fmaps=np.asarray(args["feat_pyr"][0][:, :h * w], f32).reshape(
            N, h, w, -1),
        poses=np.asarray(args["poses"]), disps=disps,
        intrinsics=np.asarray(args["intrinsics"]),
        net=np.asarray(args["net"], f32), inp=np.asarray(args["inp"], f32),
        target=np.asarray(args["target"]), eta=np.asarray(args["eta"]),
        sensor_disps=sensor, ii=np.asarray(args["ii"]),
        jj=np.asarray(args["jj"]), t0=1, t1=statics["P_max"], kbase=0,
        P_max=statics["P_max"], K_max=statics["K_max"],
        iters=statics["iters"])
    return args, statics, inputs


def _uneven(inputs):
    """5 edges (not a multiple of 4) from source frames 0-2."""
    keep = np.where(inputs["ii"] < 3)[0][:-1]
    sub = dict(inputs)
    for k in ("net", "inp", "target", "ii", "jj"):
        sub[k] = inputs[k][keep]
    return sub


@pytest.fixture(scope="module")
def step_ranks(problem):
    """Both tracking-step problems on 4 ranks, in one launch."""
    _, _, inputs = problem
    return _batch(4, {"full": ("step", inputs),
                      "uneven": ("step", _uneven(inputs))})


def test_tracking_step_sharded_matches_one_rank_and_jax_mesh(problem,
                                                             step_ranks):
    """4 ranks against 1 within 1e-5 (JAX's bound for its mesh), every
    rank bitwise equal; and against the JAX step on a 4-device mesh: one
    bf16 GRU step and two BA iterations, where bf16 rounding of the GRU
    activations (one ulp apart between the two packages' convolutions)
    bounds the agreement: poses 1e-3, disparities 2e-3 + 1%, flow targets
    5e-2 px, weights 1e-2."""
    args, statics, inputs = problem
    one = drills.step_rank(inputs)
    outs = step_ranks["full"]
    _same_on_every_rank(outs, STEP_KEYS)
    for k in STEP_KEYS:
        np.testing.assert_allclose(outs[0][k], one[k], atol=1e-5, rtol=1e-5,
                                   err_msg=f"sharded {k} diverged")
    assert min(o["bytes_received"] for o in outs) > 0

    jmesh4 = jmesh.make_mesh(4)
    es, rep = jmesh.edge_sharding(jmesh4), jmesh.replicated(jmesh4)
    jargs = dict(args)
    update_apply = jargs.pop("update_apply")
    for k in ("net", "inp", "target", "ii", "jj", "kk", "edge_mask"):
        jargs[k] = jax.device_put(jargs[k], es)
    jargs["feat_pyr"] = tuple(jax.device_put(p, rep)
                              for p in jargs["feat_pyr"])
    for k in ("params", "poses", "disps", "intrinsics", "eta",
              "sensor_disps", "adj", "adj_mask", "coords0"):
        jargs[k] = jax.tree_util.tree_map(lambda x: jax.device_put(x, rep),
                                          jargs[k])
    ref = dict(zip(STEP_KEYS, (np.asarray(x, np.float32) for x in jstep(
        update_apply, **jargs, **statics))))
    assert np.abs(ref["poses"] - inputs["poses"]).max() > 1e-3
    np.testing.assert_allclose(outs[0]["poses"], ref["poses"], atol=1e-3)
    np.testing.assert_allclose(outs[0]["disps"], ref["disps"], atol=2e-3,
                               rtol=1e-2)
    np.testing.assert_allclose(outs[0]["target"], ref["target"], atol=5e-2)
    np.testing.assert_allclose(outs[0]["weight"], ref["weight"], atol=1e-2)


def test_tracking_step_uneven_edges_and_an_idle_rank(problem, step_ranks):
    """5 edges (not a multiple of 4) from source frames 0-2, so that a
    rank's frame range holds no edge: 4 ranks still equal 1."""
    _, _, inputs = problem
    sub = _uneven(inputs)
    bounds = mesh.frame_bounds(sub["ii"], 4, inputs["disps"].shape[0])
    sizes = [len(e) for e in mesh.rank_edges(sub["ii"], bounds)]
    assert len(sub["ii"]) % 4 and 0 in sizes, sizes
    one = drills.step_rank(sub)
    outs = step_ranks["uneven"]
    _same_on_every_rank(outs, STEP_KEYS)
    for k in STEP_KEYS:
        np.testing.assert_allclose(outs[0][k], one[k], atol=1e-5, rtol=1e-5,
                                   err_msg=f"sharded {k} diverged")


# ---------------------------------------------------------------------------
# the DSPO rounds, the backend sweep and dense_ba
# ---------------------------------------------------------------------------


def _rounds_spec(alternate):
    return dict(state=dict(H=64, W=96, n=6), rounds=12, alternate=alternate)


@pytest.fixture(scope="module")
def round_ranks():
    """Both rounds problems on 2 ranks, in one launch."""
    return _batch(2, {alt: ("rounds", _rounds_spec(alt))
                      for alt in (False, True)})


@pytest.mark.parametrize("alternate", [False, True],
                         ids=["pose_depth", "dspo"])
def test_rounds_sharded_match_one_rank(alternate, round_ranks):
    """12 rounds of ``graph_update_rounds`` at 64x96, 2 ranks against 1."""
    spec = _rounds_spec(alternate)
    a = drills.rounds_rank(spec)
    outs = round_ranks[alternate]
    _same_on_every_rank(outs, drills.SNAP_KEYS)
    b = outs[0]
    assert all(o["launches"]["lookup_pyramid"] == 0 for o in outs)  # CPU
    np.testing.assert_array_equal(a["ii"], b["ii"])
    np.testing.assert_allclose(b["poses"], a["poses"], atol=5e-4)
    np.testing.assert_allclose(b["damping"], a["damping"], atol=1e-4)
    if not alternate:
        np.testing.assert_allclose(b["disps"], a["disps"], atol=5e-3)
        np.testing.assert_allclose(b["disps_up"], a["disps_up"], atol=5e-3)
        np.testing.assert_array_equal(b["scale"], a["scale"])
        np.testing.assert_array_equal(b["vmask"], a["vmask"])
    else:
        np.testing.assert_allclose(b["disps"], a["disps"], atol=1e-2)
        np.testing.assert_allclose(b["scale"], a["scale"], atol=1e-1)
        np.testing.assert_allclose(b["shift"], a["shift"], atol=5e-2)
        assert np.mean(a["vmask"] != b["vmask"]) < 0.02
    # the rounds moved the state, and both ranks worked
    assert np.abs(a["poses"] - drills.rounds_rank(
        dict(spec, rounds=1))["poses"]).max() > 1e-5
    assert all(o["bytes_received"] > 0 for o in outs)


BACKEND = dict(state=dict(H=64, W=96, n=24))


@pytest.fixture(scope="module")
def backend_ranks():
    """The backend sweep and dense_ba on 2 ranks, in one launch."""
    return _batch(2, {"sweep": ("sweep", BACKEND),
                      "dense_ba": ("dense_ba", dict(BACKEND, steps=2))})


def test_lowmem_sweep_sharded_bitwise(backend_ranks):
    """The backend's GRU sweep (``update_lowmem``, its BA left out) on 2
    ranks is bitwise the one-rank sweep: each rank runs whole 8-frame
    chunks exactly as one rank does."""
    a = drills.sweep_rank(BACKEND)
    outs = backend_ranks["sweep"]
    _same_on_every_rank(outs, drills.SNAP_KEYS)
    for k in ("net", "target", "weight", "damping", "disps_up"):
        np.testing.assert_array_equal(outs[0][k], a[k],
                                      err_msg=f"sharded sweep: {k}")
    assert len(a["ii"]) > 100


def test_dense_ba_sharded_matches_one_rank(backend_ranks):
    """``Backend.dense_ba(steps=2)`` (proposals, sweeps, pose_depth and
    depth_scale solves) on 2 ranks."""
    a = drills.dense_ba_rank(dict(BACKEND, steps=2))
    outs = backend_ranks["dense_ba"]
    _same_on_every_rank(outs, ("poses", "disps", "disps_up"))
    b = outs[0]
    assert a["n_edges"] == b["n_edges"] > 0
    np.testing.assert_allclose(b["poses"], a["poses"], atol=1e-5)
    np.testing.assert_allclose(b["disps"], a["disps"], atol=1e-4)
    np.testing.assert_allclose(b["disps_up"], a["disps_up"], atol=1e-4)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def test_mesh_devices_without_a_group_raises(tmp_path):
    cfg = base_cfg(H=48, W=64, buffer=8, out=str(tmp_path))
    cfg["tracking"]["mesh_devices"] = 4
    with pytest.raises(ValueError, match="mesh_devices=4"):
        DepthVideo(cfg, device="cpu")
    stream = SyntheticStream(n_frames=2, H=48, W=64)
    with pytest.raises(ValueError, match="1-rank group"):
        SLAM(cfg, stream, device="cpu")


def test_slam_run_on_two_ranks(tmp_path):
    """A tracking-only ``SLAM.run`` (48x64, 10 frames, loop closure and
    online BA on) through the entry point on 2 ranks: the keyframes and
    the frontend's edges of one rank, poses and disparities close (random
    weights make whole runs chaotic), every rank bitwise equal."""
    track = dict(warmup=4, frontend=dict(
        enable_loop=True, enable_online_ba=True, keyframe_thresh=0.0,
        thresh=25.0, window=6, radius=2, nms=1, max_factors=24),
        backend=dict(final_ba=True, ba_freq=3, thresh=25.0, radius=1,
                     nms=2, loop_window=6, loop_thresh=25.0, loop_radius=1,
                     loop_nms=2, BA_type="DSPO", normalize=True))
    base = base_cfg()["tracking"]
    for k in ("frontend", "backend"):
        track[k] = dict(base[k], **track[k])
    spec = dict(H=48, W=64, n_frames=10, tracking=track)
    a = drills.slam_rank(dict(spec, out=str(tmp_path / "one")))
    outs = _ranks(drills.slam_rank, 2, dict(spec, out=str(tmp_path / "two")))
    _same_on_every_rank(outs, drills.SNAP_KEYS + (
        "timestamps", "final_poses", "final_disps"))
    b = outs[0]
    assert a["n_keyframes"] == b["n_keyframes"] == 10
    np.testing.assert_array_equal(a["ii"], b["ii"])
    np.testing.assert_array_equal(a["jj"], b["jj"])
    np.testing.assert_allclose(b["poses"], a["poses"], atol=5e-2)
    assert np.median(np.abs(b["disps"] - a["disps"])) < 5e-2
    np.testing.assert_allclose(b["final_poses"], a["final_poses"], atol=5e-2)
    # rank 0 alone writes the run's files
    assert (tmp_path / "two" / "test" / "synth" / "video.npz").exists()


def test_batch_invariant_drill_net_gives_the_same_rounds():
    """The drills' batch-invariant net only changes the memory layout of
    the update's inputs (contiguous NCHW, for the card's cuDNN): on the
    CPU its pose_depth rounds are the default net's to float32 rounding
    (the convolutions sum in a layout-dependent order), and to one bf16
    step in the hidden state, which is stored in bf16."""
    spec = dict(state=dict(H=64, W=96, n=6), rounds=2, alternate=False)
    a = drills.rounds_rank(spec)
    b = drills.rounds_rank(dict(spec, state=dict(spec["state"],
                                                 batch_invariant=True)))
    for k in drills.SNAP_KEYS:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-5,
                                   atol=4e-3 if k == "net" else 1e-5,
                                   err_msg=k)


def test_a_failing_rank_fails_the_launch_without_hanging():
    """Rank 1 raises while rank 0 waits in a collective for it: the launch
    raises with rank 1's traceback instead of waiting."""
    with pytest.raises(launch.RankFailure, match="rank 1 fails on purpose"):
        launch.launch(torch_parity.fail_on_rank_1, 2, args=(None,),
                      device="cpu", timeout=60)
