"""Geometric SAC models: batched minimal solvers and distance fields.

Counterpart of ``pcl_tpu/sac/models.py``. Each model is a stateless frozen
dataclass with

- ``sample_size`` points per minimal sample;
- ``fit(samples [..., m, 3], normals or None) -> coeffs [..., C]``, NaN
  coefficients for a degenerate sample (which then scores as no model);
- ``distances(coeffs [..., C], xyz [N, 3]) -> [..., N]``;
- ``refine(coeffs, xyz, weights) -> coeffs``, least squares on the inliers;
- ``project(coeffs, xyz) -> xyz`` where defined.

Coefficient layouts are PCL's (plane ``[nx, ny, nz, d]`` with ``n.p + d = 0``,
sphere ``[cx, cy, cz, r]``, ...). The JAX package's three ``lax.scan``
refinements are Python loops of the same fixed length.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from pcl_tpu_torch.core import geometry
from pcl_tpu_torch.core.geometry import _cross

_EPS = 1e-12
_NAN = float("nan")


def _norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1, keepdim=keepdim)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(_norm(v, True), min=_EPS)


def _nan_where(bad: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return torch.where(bad[..., None], _NAN, c)


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``A x = b`` without a check: a singular system gives non-finite
    values, as in the JAX package, instead of an error (and no host
    synchronisation on the card)."""
    return torch.linalg.solve_ex(A, b)[0]


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


class SacModel:
    sample_size: int = 3
    coeff_size: int = 4
    needs_normals: bool = False

    def fit(self, samples: torch.Tensor, normals: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError

    def distances(self, coeffs: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def refine(self, coeffs: torch.Tensor, xyz: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        return coeffs

    def project(self, coeffs: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(f"{type(self).__name__} has no projection")


@dataclasses.dataclass(frozen=True)
class PlaneModel(SacModel):
    """``[nx, ny, nz, d]``, unit normal; distance ``|n.p + d|``."""
    sample_size: int = 3
    coeff_size: int = 4

    def fit(self, samples, normals=None):
        p0, p1, p2 = samples[..., 0, :], samples[..., 1, :], samples[..., 2, :]
        n = _cross(p1 - p0, p2 - p0)
        nn = _norm(n, True)
        n = n / torch.clamp(nn, min=_EPS)
        d = -torch.sum(n * p0, dim=-1, keepdim=True)
        return _nan_where(nn[..., 0] < 1e-9, torch.cat([n, d], dim=-1))   # collinear

    def distances(self, coeffs, xyz):
        return torch.abs(torch.sum(coeffs[..., None, :3] * xyz, dim=-1) + coeffs[..., None, 3])

    def refine(self, coeffs, xyz, weights):
        # weighted plane fit: centroid and smallest eigenvector, oriented as
        # the input estimate
        mu, cov, _ = geometry.mean_and_covariance(xyz, weights > 0, weights)
        n, _ = geometry.smallest_eigenvector33(cov)
        flip = torch.sum(n * coeffs[..., :3], dim=-1) < 0
        n = torch.where(flip[..., None], -n, n)
        return torch.cat([n, -torch.sum(n * mu, dim=-1, keepdim=True)], dim=-1)

    def project(self, coeffs, xyz):
        n = coeffs[..., None, :3]
        t = torch.sum(n * xyz, dim=-1) + coeffs[..., None, 3]
        return xyz - t[..., None] * n


@dataclasses.dataclass(frozen=True)
class LineModel(SacModel):
    """``[px, py, pz, dx, dy, dz]`` point and unit direction; perpendicular
    distance."""
    sample_size: int = 2
    coeff_size: int = 6

    def fit(self, samples, normals=None):
        p0, p1 = samples[..., 0, :], samples[..., 1, :]
        d = p1 - p0
        nn = _norm(d, True)
        d = d / torch.clamp(nn, min=_EPS)
        return _nan_where(nn[..., 0] < 1e-9, torch.cat([p0, d], dim=-1))

    def distances(self, coeffs, xyz):
        d = coeffs[..., None, 3:6]
        r = xyz - coeffs[..., None, :3]
        t = torch.sum(r * d, dim=-1)
        return _norm(r - t[..., None] * d)

    def project(self, coeffs, xyz):
        p, d = coeffs[..., None, :3], coeffs[..., None, 3:6]
        t = torch.sum((xyz - p) * d, dim=-1)
        return p + t[..., None] * d


@dataclasses.dataclass(frozen=True)
class StickModel(SacModel):
    """Line segment between the two sample points ``[p0, p1]``; distance to
    the segment."""
    sample_size: int = 2
    coeff_size: int = 6

    def fit(self, samples, normals=None):
        p0, p1 = samples[..., 0, :], samples[..., 1, :]
        return _nan_where(_norm(p1 - p0) < 1e-9, torch.cat([p0, p1], dim=-1))

    def distances(self, coeffs, xyz):
        p0, p1 = coeffs[..., None, :3], coeffs[..., None, 3:6]
        d = p1 - p0
        len2 = torch.clamp(torch.sum(d * d, dim=-1), min=_EPS)
        t = torch.clamp(torch.sum((xyz - p0) * d, dim=-1) / len2, 0.0, 1.0)
        return _norm(xyz - (p0 + t[..., None] * d))


def _solve_newton(c, r, diff_fn, weights, dims):
    """One Gauss-Newton step on ``|p - c| - r`` (``dims`` coordinates of c)."""
    diff = diff_fn(c)
    dist = _norm(diff)
    u = diff / torch.clamp(dist, min=_EPS)[..., None]
    res = dist - r[..., None]
    w = weights
    cr = torch.einsum("...n,...ni->...i", w, u)
    H = c.new_zeros(c.shape[:-1] + (dims + 1, dims + 1))
    H[..., :dims, :dims] = torch.einsum("...n,...ni,...nj->...ij", w, u, u)
    H[..., :dims, dims] = cr
    H[..., dims, :dims] = cr
    H[..., dims, dims] = torch.sum(w, dim=-1)
    g = torch.cat([torch.einsum("...n,...ni->...i", w * res, u),
                   torch.sum(w * res, dim=-1)[..., None]], dim=-1)
    dx = _solve(H + 1e-9 * _eye(dims + 1, H), g)
    return c + dx[..., :dims], r + dx[..., dims]


@dataclasses.dataclass(frozen=True)
class SphereModel(SacModel):
    """``[cx, cy, cz, r]``; distance ``| |p - c| - r |``. Minimal solve: four
    points in the algebraic form ``|p|^2 = 2 c.p + (r^2 - |c|^2)``."""
    sample_size: int = 4
    coeff_size: int = 4
    radius_min: float = 0.0
    radius_max: float = float("inf")

    def fit(self, samples, normals=None):
        p = samples
        A = torch.cat([p, torch.ones(p.shape[:-1] + (1,), dtype=p.dtype, device=p.device)], dim=-1)
        b = torch.sum(p * p, dim=-1)
        det_ok = torch.abs(torch.linalg.det(A)) > 1e-9
        A_safe = torch.where(det_ok[..., None, None], A, _eye(4, A))
        x = _solve(A_safe, b[..., None])[..., 0]
        c = 0.5 * x[..., :3]
        r2 = x[..., 3] + torch.sum(c * c, dim=-1)
        r = torch.sqrt(torch.clamp(r2, min=0.0))
        ok = det_ok & (r2 > 0) & (r >= self.radius_min) & (r <= self.radius_max)
        return _nan_where(~ok, torch.cat([c, r[..., None]], dim=-1))

    def distances(self, coeffs, xyz):
        return torch.abs(_norm(xyz - coeffs[..., None, :3]) - coeffs[..., None, 3])

    def refine(self, coeffs, xyz, weights, iters: int = 3):
        """Gauss-Newton on ``|p - c| - r``."""
        c, r = coeffs[..., :3], coeffs[..., 3]
        for _ in range(iters):
            c, r = _solve_newton(c, r, lambda cc: xyz - cc[..., None, :], weights, 3)
        return torch.cat([c, r[..., None]], dim=-1)

    def project(self, coeffs, xyz):
        c, r = coeffs[..., None, :3], coeffs[..., None, 3:4]
        return c + _unit(xyz - c) * r


@dataclasses.dataclass(frozen=True)
class CircleModel3D(SacModel):
    """``[cx, cy, cz, r, nx, ny, nz]``; Euclidean distance to the circle."""
    sample_size: int = 3
    coeff_size: int = 7

    def fit(self, samples, normals=None):
        p0, p1, p2 = samples[..., 0, :], samples[..., 1, :], samples[..., 2, :]
        a, b = p1 - p0, p2 - p0
        n = _cross(a, b)
        n2 = torch.sum(n * n, dim=-1, keepdim=True)
        aa = torch.sum(a * a, dim=-1, keepdim=True)
        bb = torch.sum(b * b, dim=-1, keepdim=True)
        c_rel = _cross(aa * b - bb * a, n) / torch.clamp(2.0 * n2, min=_EPS)
        r = _norm(c_rel, True)
        nrm = n / torch.clamp(torch.sqrt(n2), min=_EPS)
        return _nan_where(n2[..., 0] < 1e-12, torch.cat([p0 + c_rel, r, nrm], dim=-1))

    def distances(self, coeffs, xyz):
        c, r, n = coeffs[..., None, :3], coeffs[..., None, 3], coeffs[..., None, 4:7]
        d = xyz - c
        h = torch.sum(d * n, dim=-1)
        rho = _norm(d - h[..., None] * n)
        return torch.sqrt((rho - r) ** 2 + h * h)


@dataclasses.dataclass(frozen=True)
class CylinderModel(SacModel):
    """``[px, py, pz, dx, dy, dz, r]`` axis point, direction and radius; the
    minimal sample is two points with normals."""
    sample_size: int = 2
    coeff_size: int = 7
    needs_normals: bool = True
    radius_min: float = 0.0
    radius_max: float = float("inf")

    def fit(self, samples, normals=None):
        if normals is None:
            raise ValueError("CylinderModel requires normals")
        p0, p1 = samples[..., 0, :], samples[..., 1, :]
        n0, n1 = normals[..., 0, :], normals[..., 1, :]
        d = _cross(n0, n1)                        # the axis is normal to both
        dn = _norm(d, True)
        bad = dn[..., 0] < 1e-9
        d = d / torch.clamp(dn, min=_EPS)
        # closest point between the normal lines p0 + s n0 and p1 + t n1
        w0 = p0 - p1
        a_ = torch.sum(n0 * n0, dim=-1)
        b_ = torch.sum(n0 * n1, dim=-1)
        c_ = torch.sum(n1 * n1, dim=-1)
        d_ = torch.sum(n0 * w0, dim=-1)
        e_ = torch.sum(n1 * w0, dim=-1)
        den = a_ * c_ - b_ * b_
        s = (b_ * e_ - c_ * d_) / torch.clamp(den, min=_EPS)
        axis_pt = p0 + s[..., None] * n0
        r0 = p0 - axis_pt
        r = _norm(r0 - torch.sum(r0 * d, dim=-1, keepdim=True) * d, True)
        bad = bad | (den < 1e-12) | (r[..., 0] < self.radius_min) | (r[..., 0] > self.radius_max)
        return _nan_where(bad, torch.cat([axis_pt, d, r], dim=-1))

    def distances(self, coeffs, xyz):
        p, d, r = coeffs[..., None, :3], coeffs[..., None, 3:6], coeffs[..., None, 6]
        rel = xyz - p
        t = torch.sum(rel * d, dim=-1)
        return torch.abs(_norm(rel - t[..., None] * d) - r)

    def project(self, coeffs, xyz):
        p, d, r = coeffs[..., None, :3], coeffs[..., None, 3:6], coeffs[..., None, 6:7]
        t = torch.sum((xyz - p) * d, dim=-1)
        onaxis = p + t[..., None] * d
        return onaxis + _unit(xyz - onaxis) * r


@dataclasses.dataclass(frozen=True)
class Circle2DModel(SacModel):
    """``[cx, cy, r]`` circle in the x/y projection (z ignored)."""
    sample_size: int = 3
    coeff_size: int = 3
    radius_min: float = 0.0
    radius_max: float = float("inf")

    def fit(self, samples, normals=None):
        p = samples[..., :2]
        p0, p1, p2 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
        a, b = p1 - p0, p2 - p0
        det = a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
        bad = torch.abs(det) < 1e-12
        aa = torch.sum(a * a, dim=-1)
        bb = torch.sum(b * b, dim=-1)
        den = torch.where(bad, 1.0, 2.0 * det)
        ux = (b[..., 1] * aa - a[..., 1] * bb) / den
        uy = (a[..., 0] * bb - b[..., 0] * aa) / den
        c = p0 + torch.stack([ux, uy], dim=-1)
        r = _norm(c - p0)
        bad = bad | (r < self.radius_min) | (r > self.radius_max)
        return _nan_where(bad, torch.cat([c, r[..., None]], dim=-1))

    def distances(self, coeffs, xyz):
        return torch.abs(_norm(xyz[..., :2] - coeffs[..., None, :2]) - coeffs[..., None, 2])

    def refine(self, coeffs, xyz, weights, iters: int = 3):
        c, r = coeffs[..., :2], coeffs[..., 2]
        for _ in range(iters):
            c, r = _solve_newton(c, r, lambda cc: xyz[..., :2] - cc[..., None, :], weights, 2)
        return torch.cat([c, r[..., None]], dim=-1)

    def project(self, coeffs, xyz):
        c, r = coeffs[..., None, :2], coeffs[..., None, 2:3]
        p2 = c + _unit(xyz[..., :2] - c) * r
        return torch.cat([p2, xyz[..., 2:3] + torch.zeros_like(p2[..., :1])], dim=-1)


@dataclasses.dataclass(frozen=True)
class ConeModel(SacModel):
    """``[ax, ay, az, dx, dy, dz, alpha]`` apex, unit axis and half opening
    angle; three points with normals. Each tangent plane passes through the
    apex (``N A = N.p``); the unit vectors from the apex make one angle with
    the axis, so the axis is normal to their differences."""
    sample_size: int = 3
    coeff_size: int = 7
    needs_normals: bool = True

    def fit(self, samples, normals=None):
        if normals is None:
            raise ValueError("ConeModel requires normals")
        N = normals
        b = torch.sum(normals * samples, dim=-1)
        det_ok = torch.abs(torch.linalg.det(N)) > 1e-9
        N_safe = torch.where(det_ok[..., None, None], N, _eye(3, N))
        apex = _solve(N_safe, b[..., None])[..., 0]
        u = _unit(samples - apex[..., None, :])
        ax = _cross(u[..., 0, :] - u[..., 1, :], u[..., 0, :] - u[..., 2, :])
        axn = _norm(ax, True)
        ax = ax / torch.clamp(axn, min=_EPS)
        cosang = torch.mean(torch.sum(u * ax[..., None, :], dim=-1), dim=-1)
        ax = torch.where((cosang < 0)[..., None], -ax, ax)      # apex towards the points
        alpha = torch.arccos(torch.clamp(torch.abs(cosang), -1.0, 1.0))
        bad = (~det_ok) | (axn[..., 0] < 1e-9) | (alpha < 1e-4) | (alpha > 1.5)
        return _nan_where(bad, torch.cat([apex, ax, alpha[..., None]], dim=-1))

    def distances(self, coeffs, xyz):
        apex, ax, alpha = coeffs[..., None, :3], coeffs[..., None, 3:6], coeffs[..., None, 6]
        v = xyz - apex
        h = torch.sum(v * ax, dim=-1)
        rho = _norm(v - h[..., None] * ax)
        # distance to the surface line rho = h tan(alpha) in the meridian
        # half-plane; points behind the apex measure to the apex
        d_line = torch.abs(rho * torch.cos(alpha) - h * torch.sin(alpha))
        d_apex = torch.sqrt(h * h + rho * rho)
        behind = (h * torch.cos(alpha) + rho * torch.sin(alpha)) < 0
        return torch.where(behind, d_apex, d_line)


@dataclasses.dataclass(frozen=True)
class TorusModel(SacModel):
    """``[R, r, cx, cy, cz, nx, ny, nz]`` radii, centre and unit axis; four
    points with normals. The axis is the principal line of the normal lines'
    pairwise closest-approach midpoints; the tube radius makes the tube
    centres' distances to it vary least."""
    sample_size: int = 4
    coeff_size: int = 8
    needs_normals: bool = True

    @staticmethod
    def _pair_midpoints(p, n):
        """Closest-approach midpoints of the 6 pairs of normal lines and
        their weights (1 where the lines are not parallel)."""
        mids, wts = [], []
        for i, j in ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)):
            p1, d1 = p[..., i, :], n[..., i, :]
            p2, d2 = p[..., j, :], n[..., j, :]
            w0 = p1 - p2
            a_ = torch.sum(d1 * d1, dim=-1)
            b_ = torch.sum(d1 * d2, dim=-1)
            c_ = torch.sum(d2 * d2, dim=-1)
            d_ = torch.sum(d1 * w0, dim=-1)
            e_ = torch.sum(d2 * w0, dim=-1)
            den = a_ * c_ - b_ * b_
            ok = den > 1e-9
            den_s = torch.where(ok, den, 1.0)
            s = (b_ * e_ - c_ * d_) / den_s
            t = (a_ * e_ - b_ * d_) / den_s
            mids.append(0.5 * ((p1 + s[..., None] * d1) + (p2 + t[..., None] * d2)))
            wts.append(ok.to(p.dtype))
        return torch.stack(mids, dim=-2), torch.stack(wts, dim=-1)

    def fit(self, samples, normals=None):
        if normals is None:
            raise ValueError("TorusModel requires normals")
        mids, w = self._pair_midpoints(samples, normals)
        wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=_EPS)
        mu = torch.sum(mids * w[..., None], dim=-2) / wsum
        d = (mids - mu[..., None, :]) * w[..., None]
        cov = torch.einsum("...ki,...kj->...ij", d, d)
        ax = _unit(geometry._eigvec(cov, geometry.eigvals33(cov)[..., 2]))
        rel = samples - mu[..., None, :]
        h = torch.sum(rel * ax[..., None, :], dim=-1)
        radial = rel - h[..., None] * ax[..., None, :]
        rho = _norm(radial)
        u_rad = radial / torch.clamp(rho, min=_EPS)[..., None]
        g = -torch.sum(normals * u_rad, dim=-1)       # d rho / d r along -n
        gm = g - torch.mean(g, dim=-1, keepdim=True)
        rm = rho - torch.mean(rho, dim=-1, keepdim=True)
        r = -torch.sum(rm * gm, dim=-1) / torch.clamp(torch.sum(gm * gm, dim=-1), min=_EPS)
        centers = samples - r[..., None, None] * normals
        ch = torch.sum((centers - mu[..., None, :]) * ax[..., None, :], dim=-1)
        center = mu + torch.mean(ch, dim=-1)[..., None] * ax
        crel = centers - center[..., None, :]
        crad = crel - torch.sum(crel * ax[..., None, :], dim=-1)[..., None] * ax[..., None, :]
        R = torch.mean(_norm(crad), dim=-1)
        r = torch.abs(r)
        bad = (R < 1e-6) | (r < 1e-6) | (r > R)
        return _nan_where(bad, torch.cat([R[..., None], r[..., None], center, ax], dim=-1))

    def distances(self, coeffs, xyz):
        R, r = coeffs[..., None, 0], coeffs[..., None, 1]
        c, ax = coeffs[..., None, 2:5], coeffs[..., None, 5:8]
        v = xyz - c
        h = torch.sum(v * ax, dim=-1)
        rho = _norm(v - h[..., None] * ax)
        return torch.abs(torch.sqrt((rho - R) ** 2 + h * h) - r)


@dataclasses.dataclass(frozen=True)
class Ellipse3DModel(SacModel):
    """``[cx, cy, cz, a, b, nx, ny, nz, ux, uy, uz]`` centre, semi-axes
    (``a >= b``), plane normal and major-axis direction. Fit: PCA plane of
    six points, a conic by least squares, centre and axes from it. Distance:
    height over the plane and a Newton solve for the closest in-plane point."""
    sample_size: int = 6
    coeff_size: int = 11

    def fit(self, samples, normals=None):
        mu = torch.mean(samples, dim=-2)
        d = samples - mu[..., None, :]
        cov = torch.einsum("...ki,...kj->...ij", d, d)
        evals = geometry.eigvals33(cov)
        n = _unit(geometry._eigvec(cov, evals[..., 0]))
        e1 = _unit(geometry._eigvec(cov, evals[..., 2]))
        e2 = _cross(n, e1)
        x = torch.sum(d * e1[..., None, :], dim=-1)
        y = torch.sum(d * e2[..., None, :], dim=-1)
        # conic a x^2 + b xy + c y^2 + d x + e y = 1
        A = torch.stack([x * x, x * y, y * y, x, y], dim=-1)
        AtA = torch.einsum("...ki,...kj->...ij", A, A)
        Atb = torch.einsum("...ki,...k->...i", A, torch.ones_like(x))
        sol = _solve(AtA + 1e-9 * _eye(5, A), Atb[..., None])[..., 0]
        ca, cb, cc, cd, ce = (sol[..., i] for i in range(5))
        det = 4 * ca * cc - cb * cb
        bad = det < 1e-12                              # not an ellipse
        det_s = torch.where(bad, 1.0, det)
        x0 = (cb * ce - 2 * cc * cd) / det_s
        y0 = (cb * cd - 2 * ca * ce) / det_s
        fc = ca * x0 * x0 + cb * x0 * y0 + cc * y0 * y0 + cd * x0 + ce * y0 - 1.0
        tr = ca + cc
        dq = torch.sqrt(torch.clamp((ca - cc) ** 2 + cb * cb, min=0.0))
        l1 = 0.5 * (tr - dq)                           # minor curvature: major axis
        l2 = 0.5 * (tr + dq)
        sa2 = -fc / torch.where(torch.abs(l1) < _EPS, 1.0, l1)
        sb2 = -fc / torch.where(torch.abs(l2) < _EPS, 1.0, l2)
        bad = bad | (sa2 <= 0) | (sb2 <= 0)
        sa = torch.sqrt(torch.clamp(sa2, min=_EPS))
        sb = torch.sqrt(torch.clamp(sb2, min=_EPS))
        has_b = torch.abs(cb) > 1e-12
        vx = torch.where(has_b, cb / 2.0, 1.0)
        vy = torch.where(has_b, l1 - ca, 0.0)
        vn = torch.clamp(torch.sqrt(vx * vx + vy * vy), min=_EPS)
        u3 = (vx / vn)[..., None] * e1 + (vy / vn)[..., None] * e2
        center = mu + x0[..., None] * e1 + y0[..., None] * e2
        return _nan_where(bad, torch.cat([center, sa[..., None], sb[..., None], n, u3], dim=-1))

    def distances(self, coeffs, xyz, newton_iters: int = 8):
        c, a, b = coeffs[..., None, :3], coeffs[..., None, 3], coeffs[..., None, 4]
        n, u = coeffs[..., None, 5:8], coeffs[..., None, 8:11]
        v = _cross(n, u)
        rel = xyz - c
        h = torch.sum(rel * n, dim=-1)
        qx = torch.abs(torch.sum(rel * u, dim=-1))
        qy = torch.abs(torch.sum(rel * v, dim=-1))
        t = torch.atan2(a * qy, b * qx)
        for _ in range(newton_iters):
            ct, st = torch.cos(t), torch.sin(t)
            ex, ey = a * ct, b * st
            f = -(ex - qx) * a * st + (ey - qy) * b * ct
            fp = -(ex - qx) * a * ct + a * a * st * st - (ey - qy) * b * st + b * b * ct * ct
            t = torch.clamp(t - f / torch.where(torch.abs(fp) < _EPS, 1.0, fp), 0.0, math.pi / 2)
        d_in = torch.sqrt((a * torch.cos(t) - qx) ** 2 + (b * torch.sin(t) - qy) ** 2)
        return torch.sqrt(d_in * d_in + h * h)


def _angle_between(v: torch.Tensor, axis: Tuple[float, float, float]) -> torch.Tensor:
    a = torch.tensor(axis, dtype=v.dtype, device=v.device)
    a = a / torch.clamp(_norm(a), min=_EPS)
    return torch.arccos(torch.clamp(torch.abs(torch.sum(v * a, dim=-1)), 0.0, 1.0))


@dataclasses.dataclass(frozen=True)
class PerpendicularPlaneModel(PlaneModel):
    """Plane whose normal lies within ``eps_angle`` of ``axis``."""
    axis: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    eps_angle: float = 0.2

    def fit(self, samples, normals=None):
        c = PlaneModel.fit(self, samples, normals)
        return _nan_where(_angle_between(c[..., :3], self.axis) > self.eps_angle, c)


@dataclasses.dataclass(frozen=True)
class ParallelPlaneModel(PlaneModel):
    """Plane parallel to ``axis``: its normal perpendicular to it."""
    axis: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    eps_angle: float = 0.2

    def fit(self, samples, normals=None):
        c = PlaneModel.fit(self, samples, normals)
        ang = _angle_between(c[..., :3], self.axis)
        return _nan_where(torch.abs(ang - math.pi / 2) > self.eps_angle, c)


@dataclasses.dataclass(frozen=True)
class ParallelLineModel(LineModel):
    """Line within ``eps_angle`` of ``axis``."""
    axis: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    eps_angle: float = 0.2

    def fit(self, samples, normals=None):
        c = LineModel.fit(self, samples, normals)
        return _nan_where(_angle_between(c[..., 3:6], self.axis) > self.eps_angle, c)


def _normal_mix(w: float, d_pt: torch.Tensor, direction: torch.Tensor,
                normals: torch.Tensor) -> torch.Tensor:
    """``w * angle(direction, normal) + (1 - w) * d_pt``."""
    cosang = torch.abs(torch.sum(direction * normals, dim=-1))
    return w * torch.arccos(torch.clamp(cosang, 0.0, 1.0)) + (1.0 - w) * d_pt


@dataclasses.dataclass(frozen=True)
class NormalPlaneModel(PlaneModel):
    """Plane scored by a weighted mix of point distance and the angle
    between the plane's and the point's normals."""
    normal_distance_weight: float = 0.1
    scores_with_normals: bool = True
    needs_normals: bool = True

    def distances(self, coeffs, xyz, normals=None):
        d_pt = PlaneModel.distances(self, coeffs, xyz)
        if normals is None:
            return d_pt
        return _normal_mix(self.normal_distance_weight, d_pt, coeffs[..., None, :3], normals)


@dataclasses.dataclass(frozen=True)
class NormalParallelPlaneModel(NormalPlaneModel):
    """Normal-scored plane whose normal lies within ``eps_angle`` of
    ``axis``."""
    axis: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    eps_angle: float = 0.2

    def fit(self, samples, normals=None):
        c = PlaneModel.fit(self, samples, normals)
        return _nan_where(_angle_between(c[..., :3], self.axis) > self.eps_angle, c)


@dataclasses.dataclass(frozen=True)
class NormalSphereModel(SphereModel):
    """Sphere scored with the angle between the radial direction and the
    point's normal."""
    normal_distance_weight: float = 0.1
    scores_with_normals: bool = True
    needs_normals: bool = True

    def distances(self, coeffs, xyz, normals=None):
        d_pt = SphereModel.distances(self, coeffs, xyz)
        if normals is None:
            return d_pt
        radial = _unit(xyz - coeffs[..., None, :3])
        return _normal_mix(self.normal_distance_weight, d_pt, radial, normals)


@dataclasses.dataclass(frozen=True)
class RegistrationModel(SacModel):
    """Rigid transform between paired clouds, flattened ``[16]``. Its
    "points" are correspondences: ``fit`` takes source and target samples,
    ``distances`` the residuals ``|T s_i - t_i|``."""
    sample_size: int = 3
    coeff_size: int = 16

    def fit(self, samples, normals=None, target_samples=None):
        if target_samples is None:
            raise ValueError("RegistrationModel requires target_samples")
        w = torch.ones(samples.shape[:-1], dtype=samples.dtype, device=samples.device)
        T = geometry.umeyama(samples, target_samples, w)
        return T.reshape(T.shape[:-2] + (16,))

    def distances(self, coeffs, xyz, target_xyz=None):
        """``coeffs [..., 16]`` and paired ``xyz``/``target_xyz [N, 3]`` ->
        ``[..., N]``."""
        if target_xyz is None:
            raise ValueError("RegistrationModel requires target_xyz")
        T = coeffs.reshape(coeffs.shape[:-1] + (4, 4))
        src_t = torch.einsum("...ij,nj->...ni", T[..., :3, :3], xyz) + T[..., None, :3, 3]
        return _norm(src_t - target_xyz)

    def refine(self, coeffs, xyz, weights, target_xyz=None):
        if target_xyz is None:
            return coeffs
        T = geometry.umeyama(xyz, target_xyz, weights)
        return T.reshape(T.shape[:-2] + (16,))
