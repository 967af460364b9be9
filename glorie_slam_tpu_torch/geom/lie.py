"""SE(3) group operations on ``[tx, ty, tz, qx, qy, qz, qw]`` 7-vectors.

Counterpart of ``glorie_slam_tpu/geom/lie.py`` with the same conventions:
poses map world -> camera, the relative transform is ``G_ij = T_j ∘ T_i^-1``,
and the retraction is the LEFT update ``T <- exp(xi) ∘ T`` with
``xi = [tau(3), phi(3)]``. Every function broadcasts over leading batch
dimensions; small-angle branches use ``torch.where`` with Taylor series.
"""

import torch

_EPS = 1e-8


def identity(shape=(), dtype=torch.float32, device=None):
    """Identity pose(s) with the given leading batch shape."""
    out = torch.zeros(tuple(shape) + (7,), dtype=dtype, device=device)
    out[..., 6] = 1.0
    return out


def _cross(a, b):
    return torch.cross(a, b, dim=-1)


def quat_mul(q1, q2):
    """Hamilton product, xyzw layout: rot(q1*q2) = rot(q1) @ rot(q2)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
        w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_inv(q):
    """Conjugate (unit quaternion)."""
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_rotate(q, v):
    """v' = v + w (2 u x v) + u x (2 u x v), u = q.xyz."""
    shape = torch.broadcast_shapes(q.shape[:-1], v.shape[:-1])
    q = q.expand(shape + (4,))
    v = v.expand(shape + (3,))
    u = q[..., :3]
    w = q[..., 3:4]
    uv = 2.0 * _cross(u, v)
    return v + w * uv + _cross(u, uv)


def quat_to_matrix(q):
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_from_matrix(R):
    """Rotation matrix -> quaternion (xyzw), branchless Shepperd's method."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) * 2

    s0 = root(tr + 1.0)                              # w largest
    c0 = torch.stack([(m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0, 0.25 * s0], -1)
    s1 = root(1.0 + m00 - m11 - m22)                 # x largest
    c1 = torch.stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1,
                      (m21 - m12) / s1], -1)
    s2 = root(1.0 + m11 - m00 - m22)                 # y largest
    c2 = torch.stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2,
                      (m02 - m20) / s2], -1)
    s3 = root(1.0 + m22 - m00 - m11)                 # z largest
    c3 = torch.stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3,
                      (m10 - m01) / s3], -1)
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where((tr > 0.0)[..., None], c0,
                    torch.where(cond1, c1, torch.where(cond2, c2, c3)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def mul(a, b):
    """Compose: (a ∘ b)(x) = a(b(x))."""
    a, b = torch.broadcast_tensors(a, b)
    t = a[..., :3] + quat_rotate(a[..., 3:7], b[..., :3])
    q = quat_mul(a[..., 3:7], b[..., 3:7])
    return torch.cat([t, q], dim=-1)


def inv(a):
    qi = quat_inv(a[..., 3:7])
    t = -quat_rotate(qi, a[..., :3])
    return torch.cat([t, qi], dim=-1)


def rel(pose_i, pose_j):
    """G_ij = T_j ∘ T_i^-1: camera-i coordinates -> camera-j coordinates."""
    return mul(pose_j, inv(pose_i))


def act(pose, X):
    """Act on homogeneous points X = [x, y, z, h]: [R x + h t, h]."""
    shape = torch.broadcast_shapes(pose.shape[:-1], X.shape[:-1])
    pose = pose.expand(shape + (7,))
    X = X.expand(shape + (4,))
    v = quat_rotate(pose[..., 3:7], X[..., :3]) + X[..., 3:4] * pose[..., :3]
    return torch.cat([v, X[..., 3:4]], dim=-1)


def act3(pose, X):
    """Act on ordinary 3D points: R x + t."""
    return quat_rotate(pose[..., 3:7], X) + pose[..., :3]


def _so3_coeffs(theta_sq):
    theta = torch.sqrt(torch.clamp(theta_sq, min=0.0))
    theta_p4 = theta_sq * theta_sq
    small = theta_sq < 1e-8
    safe_theta = torch.where(small, torch.ones_like(theta), theta)
    imag = torch.where(small, 0.5 - theta_sq / 48.0 + theta_p4 / 3840.0,
                       torch.sin(0.5 * safe_theta) / safe_theta)
    real = torch.where(small, 1.0 - theta_sq / 8.0 + theta_p4 / 384.0,
                       torch.cos(0.5 * safe_theta))
    return imag, real


def exp_so3(phi):
    """so(3) -> unit quaternion (xyzw)."""
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    imag, real = _so3_coeffs(theta_sq)
    return torch.cat([imag * phi, real], dim=-1)


def exp(xi):
    """se(3) -> SE(3): xi = [tau, phi] -> 7-vector pose."""
    tau, phi = xi[..., :3], xi[..., 3:6]
    q = exp_so3(phi)
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta_sq, min=0.0))
    small = theta_sq < 1e-8
    one = torch.ones_like(theta_sq)
    safe_sq = torch.where(small, one, theta_sq)
    a = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / safe_sq)
    b = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta))
                    / (safe_sq * torch.where(small, one, theta)))
    c1 = _cross(phi, tau)
    c2 = _cross(phi, c1)
    t = tau + a * c1 + b * c2
    return torch.cat([t, q], dim=-1)


def log_so3(q):
    """Unit quaternion -> so(3)."""
    u = q[..., :3]
    w = q[..., 3:4]
    sign = torch.where(w < 0, -torch.ones_like(w), torch.ones_like(w))
    u, w = u * sign, w * sign
    norm_u = torch.linalg.norm(u, dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(norm_u, w)
    small = norm_u < 1e-8
    scale = torch.where(small, 2.0 / torch.clamp(w, min=_EPS),
                        theta / torch.where(small, torch.ones_like(norm_u),
                                            norm_u))
    return scale * u


def log(pose):
    """SE(3) -> se(3) twist [tau, phi] with exp(log(T)) = T."""
    phi = log_so3(pose[..., 3:7])
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta_sq, min=0.0))
    small = theta_sq < 1e-8
    one = torch.ones_like(theta_sq)
    safe_sq = torch.where(small, one, theta_sq)
    half = 0.5 * theta
    cot = torch.where(small, torch.zeros_like(half),
                      torch.cos(half) / torch.where(small, one,
                                                    torch.sin(half)))
    e = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                    (1.0 - half * cot) / safe_sq)
    t = pose[..., :3]
    c1 = _cross(phi, t)
    c2 = _cross(phi, c1)
    tau = t - 0.5 * c1 + e * c2
    return torch.cat([tau, phi], dim=-1)


def retr(pose, xi):
    """Left retraction T <- exp(xi) ∘ T."""
    return mul(exp(xi), pose)


def adjT(pose, X):
    """Dual adjoint on row covectors X = [Xv, Xw]:
    Y_v = R^T Xv, Y_w = R^T (Xw - t x Xv)."""
    shape = torch.broadcast_shapes(pose.shape[:-1], X.shape[:-1])
    pose = pose.expand(shape + (7,))
    X = X.expand(shape + (6,))
    t, q = pose[..., :3], pose[..., 3:7]
    qi = quat_inv(q)
    Xv, Xw = X[..., :3], X[..., 3:6]
    Yv = quat_rotate(qi, Xv)
    Yw = quat_rotate(qi, Xw - _cross(t, Xv))
    return torch.cat([Yv, Yw], dim=-1)


def to_matrix(pose):
    """7-vector -> 4x4 homogeneous matrix."""
    R = quat_to_matrix(pose[..., 3:7])
    t = pose[..., :3]
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(pose.shape[:-1] + (1, 4), dtype=pose.dtype,
                         device=pose.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def from_matrix(T):
    """4x4 homogeneous matrix -> 7-vector."""
    q = quat_from_matrix(T[..., :3, :3])
    return torch.cat([T[..., :3, 3], q], dim=-1)


def scale_translation(pose, s):
    """Rescale the translation part (monocular gauge fix)."""
    return torch.cat([pose[..., :3] * s, pose[..., 3:7]], dim=-1)
