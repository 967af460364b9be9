"""Port parity: geom/lie.py and geom/projective.py against the JAX package.

Tolerances: both sides run the same float32 formulas; differences are
float32 rounding of transcendental functions and operation order (1e-5
absolute on unit-scale values, 1e-4 on pixel coordinates ~10-100 px).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from glorie_slam_tpu.geom import lie as jlie, projective as jproj
from glorie_slam_tpu_torch.geom import lie, projective
from torch_parity import n, random_poses, t


@pytest.mark.parametrize("scale", [1e-6, 0.3])
def test_lie_group_ops_match_jax(scale):
    rng = np.random.default_rng(0)
    xi = random_poses(rng, 16, scale)
    xi2 = random_poses(rng, 16, 0.3)
    X = rng.normal(size=(16, 4)).astype(np.float32)
    Y = rng.normal(size=(16, 6)).astype(np.float32)
    ja, jb = jlie.exp(jnp.asarray(xi)), jlie.exp(jnp.asarray(xi2))
    pa, pb = lie.exp(t(xi)), lie.exp(t(xi2))
    np.testing.assert_allclose(n(pa), n(ja), atol=1e-6)
    for jf, pf in [
        (jlie.inv(ja), lie.inv(pa)),
        (jlie.mul(ja, jb), lie.mul(pa, pb)),
        (jlie.rel(ja, jb), lie.rel(pa, pb)),
        (jlie.log(ja), lie.log(pa)),
        (jlie.retr(ja, jnp.asarray(xi2)), lie.retr(pa, t(xi2))),
        (jlie.act(ja, jnp.asarray(X)), lie.act(pa, t(X))),
        (jlie.adjT(ja, jnp.asarray(Y)), lie.adjT(pa, t(Y))),
        (jlie.to_matrix(ja), lie.to_matrix(pa)),
    ]:
        np.testing.assert_allclose(n(pf), n(jf), atol=2e-5)


@pytest.mark.parametrize("stereo", [False, True])
def test_projective_transform_and_jacobians_match_jax(stereo):
    rng = np.random.default_rng(1)
    N, ht, wd = 5, 6, 8
    poses = jlie.exp(jnp.asarray(random_poses(rng, N, 0.05)))
    disps = (0.5 + rng.random((N, ht, wd))).astype(np.float32)
    intr = np.array([10.0, 11.0, 3.5, 2.5], np.float32)
    ii = np.array([0, 1, 2, 3, 4, 2])
    jj = np.array([1, 0, 3, 2, 4 if stereo else 0, 2 if stereo else 1])
    jo = jproj.projective_transform(
        poses, jnp.asarray(disps), jnp.asarray(intr), jnp.asarray(ii),
        jnp.asarray(jj), jacobian=True)
    po = projective.projective_transform(
        t(n(poses)), t(disps), t(intr), t(ii, dtype=None).long(),
        t(jj, dtype=None).long(), jacobian=True)
    np.testing.assert_allclose(n(po[0]), n(jo[0]), atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(n(po[1]), n(jo[1]))
    for a, b in zip(po[2], jo[2]):
        np.testing.assert_allclose(n(a), n(b), atol=1e-3, rtol=1e-4)


def test_synthetic_stream_matches_tests_stream():
    """The port's own copy of the synthetic stream renders what the JAX
    tests' stream renders (pose maths in torch vs JAX float32: poses to
    1e-6, texture samples to 1e-3, depths to 1e-5 relative)."""
    from glorie_slam_tpu_torch.utils.synthetic import SyntheticStream
    from synthetic import SyntheticStream as JStream

    for traj in ("circuit", "walk"):
        a = SyntheticStream(n_frames=4, H=24, W=32, seed=3, trajectory=traj)
        b = JStream(n_frames=4, H=24, W=32, seed=3, trajectory=traj)
        np.testing.assert_allclose(a.poses_w2c, b.poses_w2c, atol=1e-6)
        np.testing.assert_array_equal(a.intrinsics, b.intrinsics)
        for i in range(4):
            np.testing.assert_allclose(a[i][1], b[i][1], atol=1e-3)
            np.testing.assert_allclose(a[i][2], b[i][2], rtol=1e-5)
            np.testing.assert_allclose(a[i][3], b[i][3], atol=1e-5)
