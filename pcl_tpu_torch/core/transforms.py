"""Rigid transforms and SE(3)/SO(3) utilities.

Counterpart of ``pcl_tpu/core/transforms.py``. Transforms are ``[..., 4, 4]``
float32 homogeneous matrices; every function takes leading batch dimensions.
"""

from __future__ import annotations

import math

import torch

from pcl_tpu_torch.core.cloud import ATTR_NORMAL, Cloud

_EPS = 1e-9


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = R.new_zeros(R.shape[:-2] + (4, 4))
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def invert_rigid(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return from_rt(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def transform_points(T: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Apply ``[..., 4, 4]`` to ``[..., N, 3]``."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", R, xyz) + t[..., None, :]


def transform_cloud(T: torch.Tensor, cloud: Cloud) -> Cloud:
    """Transform positions and rotate the ``normal`` attribute, if any."""
    xyz = transform_points(T, cloud.xyz)
    xyz = torch.where(cloud.mask[..., None], xyz, 0.0)
    out = cloud.with_xyz(xyz)
    if ATTR_NORMAL in cloud.attrs:
        R = T[..., :3, :3]
        n = torch.einsum("...ij,...nj->...ni", R, cloud.attrs[ATTR_NORMAL])
        n = torch.where(cloud.mask[..., None], n, 0.0)
        out = out.with_attrs(**{ATTR_NORMAL: n})
    return out


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def hat(w: torch.Tensor) -> torch.Tensor:
    """``[..., 3]`` -> ``[..., 3, 3]`` skew-symmetric."""
    zero = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], zero, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )


def _coefficients(theta2: torch.Tensor):
    """Rodrigues coefficients A = sin/theta, B = (1-cos)/theta^2 and
    C = (1-A)/theta^2, with Taylor forms below theta^2 = 1e-8."""
    small = theta2 < 1e-8
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe2)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / safe2)
    return A, B, C


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: ``[..., 3]`` axis-angle -> ``[..., 3, 3]`` rotation."""
    A, B, _ = _coefficients(torch.sum(w * w, dim=-1))
    W = hat(w)
    W2 = W @ W
    I = torch.eye(3, dtype=w.dtype, device=w.device)
    return I + A[..., None, None] * W + B[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """``[..., 3, 3]`` rotation -> ``[..., 3]`` axis-angle, theta in [0, pi]."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_t = torch.sin(theta)
    small = theta < 1e-4
    near_pi = theta > math.pi - 1e-3
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        theta / torch.clamp(2.0 * sin_t, min=_EPS))
    w_generic = v * scale[..., None]
    # near pi: the axis from the diagonal, signs from the off-diagonal sums,
    # anchored at the largest axis component
    d = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis2 = torch.clamp((d - cos_t[..., None])
                        / torch.clamp(1.0 - cos_t[..., None], min=_EPS), min=0.0)
    axis = torch.sqrt(axis2)
    k = torch.argmax(axis, dim=-1)
    off = torch.stack([R[..., 0, 1] + R[..., 1, 0],
                       R[..., 0, 2] + R[..., 2, 0],
                       R[..., 1, 2] + R[..., 2, 1]], dim=-1)
    sgn = torch.sign(off)
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    sxy, sxz, syz = sgn[..., 0], sgn[..., 1], sgn[..., 2]
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    cands = torch.stack([
        torch.stack([ax, ay * sxy, az * sxz], dim=-1),   # anchor x
        torch.stack([ax * sxy, ay, az * syz], dim=-1),   # anchor y
        torch.stack([ax * sxz, ay * syz, az], dim=-1),   # anchor z
    ], dim=-2)
    idx = k[..., None, None].expand(k.shape + (1, 3))
    w_pi = torch.gather(cands, -2, idx)[..., 0, :] * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist ``[..., 6]`` (rho, omega) -> ``[..., 4, 4]``."""
    rho, w = xi[..., :3], xi[..., 3:]
    A, B, C = _coefficients(torch.sum(w * w, dim=-1))
    W = hat(w)
    W2 = W @ W
    I = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = I + A[..., None, None] * W + B[..., None, None] * W2
    V = I + B[..., None, None] * W + C[..., None, None] * W2
    t = torch.einsum("...ij,...j->...i", V, rho)
    return from_rt(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """``[..., 4, 4]`` -> twist ``[..., 6]`` (rho, omega)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < 1e-12
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    W = hat(w)
    W2 = W @ W
    I = torch.eye(3, dtype=T.dtype, device=T.device)
    # V^-1 = I - W/2 + (1/theta^2)(1 - A/(2B)) W^2
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                       (1.0 - A / (2.0 * B)) / torch.clamp(theta2, min=_EPS))
    Vinv = I - 0.5 * W + coef[..., None, None] * W2
    rho = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([rho, w], dim=-1)


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """Rotation magnitude in radians."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))


# ---------------------------------------------------------------------------
# Quaternions (wxyz)
# ---------------------------------------------------------------------------

def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (wxyz, w >= 0), branch-free by the
    four-candidate method."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tw = 1.0 + m00 + m11 + m22
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22
    qw = torch.stack([tw, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, tx, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, ty, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, tz], dim=-1)
    k = torch.argmax(torch.stack([tw, tx, ty, tz], dim=-1), dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)
    q = torch.gather(cands, -2, k[..., None, None].expand(k.shape + (1, 4)))[..., 0, :]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    s = torch.sign(q[..., :1])
    return q * torch.where(s == 0, torch.ones_like(s), s)
