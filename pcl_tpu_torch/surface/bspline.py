"""B-spline surface and curve fitting.

Counterpart of ``pcl_tpu/surface/bspline.py`` (PCL's ``on_nurbs`` fitting,
re-designed in the JAX package): uniform cubic B-splines, a dense design
matrix assembled in one pass, normal equations with a Laplacian (surfaces)
or second-difference (closed curves) smoothness prior, one dense solve.

- Surfaces are height fields over the cloud's PCA plane. The frame comes
  from ``torch.linalg.eigh``, as the JAX package's from ``jnp.linalg.eigh``:
  LAPACK and cuSOLVER may return an eigenvector with the other sign, which
  mirrors ``(u, v)`` and the control net but not the fitted surface in the
  world (ROADMAP C57). Compare world points, meshes and residuals.
- ``fit_bspline_surface_iterated`` (fitting_surface_pdm): solve, then move
  every point's ``(u, v)`` by damped gradient steps of its distance to the
  current surface (autograd; the clip's gradient at its bounds is the JAX
  package's half), and solve again.
- ``fit_trimmed_bspline_surface``: the iterated surface and a closed trim
  curve fitted to its footprint's outer contour in the parameter plane.
- Closed curves in 2-D and 3-D, parameterized by angle about the centroid
  (3-D: in the PCA plane).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from pcl_tpu_torch.core.casts import xla_int32
from pcl_tpu_torch.core.cloud import Cloud


def _cubic_basis(t: torch.Tensor) -> torch.Tensor:
    """Uniform cubic B-spline weights ``[..., 4]`` of control points
    ``i-1 .. i+2`` at the fraction ``t`` in ``[0, 1)``."""
    t2 = t * t
    t3 = t2 * t
    b0 = (1 - t) ** 3 / 6.0
    b1 = (3 * t3 - 6 * t2 + 4) / 6.0
    b2 = (-3 * t3 + 3 * t2 + 3 * t + 1) / 6.0
    b3 = t3 / 6.0
    return torch.stack([b0, b1, b2, b3], dim=-1)


class BSplineSurface(NamedTuple):
    control: torch.Tensor    # [Gu, Gv] control heights over the (u, v) grid
    origin: torch.Tensor     # [2] (u, v) domain minimum
    scale: torch.Tensor      # [2] domain extent
    frame: torch.Tensor      # [3, 3] rows: u axis, v axis, normal
    centroid: torch.Tensor   # [3]


class BSplineCurve2D(NamedTuple):
    control: torch.Tensor    # [G, 2] control points (closed: wraps mod G)


class BSplineCurve3D(NamedTuple):
    control: torch.Tensor    # [G, 3] control points (closed: wraps mod G)
    centroid: torch.Tensor   # [3]
    frame: torch.Tensor      # [3, 3] PCA rows (the parameterization plane)


class TrimmedBSplineSurface(NamedTuple):
    surface: BSplineSurface
    trim: BSplineCurve2D     # closed curve in normalized (u, v)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: ``minimum(hi, maximum(lo, x))``; at a bound the
    gradient is a half, as for JAX's."""
    lo_t = torch.tensor(lo, dtype=x.dtype, device=x.device)
    hi_t = torch.tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(hi_t, torch.maximum(lo_t, x))


def _uv_cells(uv: torch.Tensor, gu: int, gv: int):
    """Normalized ``(u, v)`` in ``[0, 1]`` -> cell indices and fractions,
    clamped to the boundary cells. A NaN ``(u, v)`` (a cloud with no valid
    point) passes the clip and takes cell 0 with a NaN fraction, as XLA's
    cast gives it (ROADMAP F5, C71)."""
    pu = _clip(uv[:, 0] * (gu - 3), 0.0, gu - 3 - 1e-6)
    pv = _clip(uv[:, 1] * (gv - 3), 0.0, gv - 3 - 1e-6)
    iu = xla_int32(torch.floor(pu)).to(torch.int64)
    iv = xla_int32(torch.floor(pv)).to(torch.int64)
    return iu, pu - iu, iv, pv - iv


def _pca_frame(xyz: torch.Tensor, w: torch.Tensor):
    """``(n, centroid, frame)``: the weighted PCA with rows major, mid,
    normal."""
    n = torch.clamp(w.sum(), min=1.0)
    mu = (xyz * w[:, None]).sum(0) / n
    d = (xyz - mu) * w[:, None]
    cov = d.T @ d / n
    _, V = torch.linalg.eigh(cov)            # ascending
    return n, mu, V.flip(1).T


def _plane_params(cloud: Cloud):
    """The cloud in its PCA frame: ``(w, n, mu, frame, local [N, 3], lo,
    scale)``, ``(u, v)`` normalized by the valid points' extent."""
    xyz, m = cloud.xyz, cloud.mask
    w = m.to(torch.float32)
    n, mu, frame = _pca_frame(xyz, w)
    local = (xyz - mu) @ frame.T
    lo = torch.amin(torch.where(m[:, None], local[:, :2], math.inf), dim=0)
    hi = torch.amax(torch.where(m[:, None], local[:, :2], -math.inf), dim=0)
    return w, n, mu, frame, local, lo, torch.clamp(hi - lo, min=1e-9)


def _design(uv: torch.Tensor, w: torch.Tensor, gu: int, gv: int) -> torch.Tensor:
    """Dense ``[N, Gu Gv]`` design matrix: 16 basis products a row."""
    iu, tu, iv, tv = _uv_cells(uv, gu, gv)
    bu, bv = _cubic_basis(tu), _cubic_basis(tv)
    N = uv.shape[0]
    rows = torch.arange(N, device=uv.device)
    A = torch.zeros((N, gu * gv), dtype=torch.float32, device=uv.device)
    for a in range(4):
        for b in range(4):
            A.index_put_((rows, (iu + a) * gv + (iv + b)), bu[:, a] * bv[:, b] * w,
                         accumulate=True)
    return A


def _grid_laplacian(gu: int, gv: int, device) -> torch.Tensor:
    """The control grid's graph Laplacian ``[C, C]`` (4-neighbours)."""
    C = gu * gv
    idx = torch.arange(C, device=device).reshape(gu, gv)
    Lap = torch.zeros((C, C), dtype=torch.float32, device=device)
    for du, dv in ((1, 0), (0, 1)):
        a = idx[:gu - du, :gv - dv].reshape(-1)
        b = idx[du:, dv:].reshape(-1)
        one = torch.ones(a.shape[0], device=device)
        for i, j, s in ((a, a, 1.0), (b, b, 1.0), (a, b, -1.0), (b, a, -1.0)):
            Lap.index_put_((i, j), s * one, accumulate=True)
    return Lap


def _solve(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(M, b if b.ndim == 2 else b[:, None])[0].reshape(b.shape)


def _height(control: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    gu, gv = control.shape
    iu, tu, iv, tv = _uv_cells(uv, gu, gv)
    bu, bv = _cubic_basis(tu), _cubic_basis(tv)
    h = torch.zeros(uv.shape[0], dtype=torch.float32, device=uv.device)
    for a in range(4):
        for b in range(4):
            h = h + bu[:, a] * bv[:, b] * control[torch.clamp(iu + a, 0, gu - 1),
                                                  torch.clamp(iv + b, 0, gv - 1)]
    return h


def fit_bspline_surface(cloud: Cloud, grid_u: int = 10, grid_v: int = 10,
                        smoothness: float = 1e-3) -> BSplineSurface:
    """Least-squares cubic B-spline height field over the cloud's dominant
    plane (FittingSurface's open case): heights along the smallest
    eigenvector on ``grid_u x grid_v`` control points, with a Laplacian prior
    weighted ``smoothness * max(n / C, 1)``."""
    w, n, mu, frame, local, lo, scale = _plane_params(cloud)
    uv = (local[:, :2] - lo) / scale
    gu, gv = grid_u, grid_v
    C = gu * gv
    A = _design(uv, w, gu, gv)
    reg = float(np.float32(smoothness)) * torch.clamp(n / C, min=1.0)
    M = A.T @ A + reg * _grid_laplacian(gu, gv, A.device) \
        + 1e-6 * torch.eye(C, device=A.device)
    ctrl = _solve(M, A.T @ (local[:, 2] * w))
    return BSplineSurface(control=ctrl.reshape(gu, gv), origin=lo, scale=scale, frame=frame,
                          centroid=mu)


def eval_bspline_surface(surf: BSplineSurface, uv) -> torch.Tensor:
    """World points ``[M, 3]`` of the surface at normalized ``(u, v)``."""
    uv = torch.as_tensor(uv, dtype=torch.float32, device=surf.control.device)
    h = _height(surf.control, uv)
    u = surf.origin[0] + uv[:, 0] * surf.scale[0]
    v = surf.origin[1] + uv[:, 1] * surf.scale[1]
    return torch.stack([u, v, h], dim=1) @ surf.frame + surf.centroid


def fit_bspline_surface_iterated(cloud: Cloud, grid_u: int = 10, grid_v: int = 10,
                                 interior_smoothness: float = 1e-3,
                                 boundary_smoothness: float = 1e-1, iterations: int = 3,
                                 refine_steps: int = 2) -> BSplineSurface:
    """Iterated PDM fitting (fitting_surface_pdm.h): solve, re-parameterize
    every point by ``refine_steps`` damped gradient steps of its squared
    distance to the current surface (inverseMapping), solve again; the
    control grid's outer ring carries ``boundary_smoothness``, the rest
    ``interior_smoothness``."""
    w, n, mu, frame, local, lo, scale = _plane_params(cloud)
    uv0 = (local[:, :2] - lo) / scale
    gu, gv = grid_u, grid_v
    C = gu * gv
    dev = uv0.device
    on_boundary = torch.zeros((gu, gv), dtype=torch.bool, device=dev)
    on_boundary[0, :] = on_boundary[-1, :] = True
    on_boundary[:, 0] = on_boundary[:, -1] = True
    wreg = torch.where(on_boundary.reshape(-1), float(np.float32(boundary_smoothness)),
                       float(np.float32(interior_smoothness))) * torch.clamp(n / C, min=1.0)
    R = _grid_laplacian(gu, gv, dev) * torch.sqrt(wreg[None, :] * wreg[:, None]) \
        + 1e-6 * torch.eye(C, device=dev)
    target_h = local[:, 2]

    def solve(uv):
        A = _design(uv, w, gu, gv)
        return _solve(A.T @ A + R, A.T @ (target_h * w))

    def reparam(ctrl, uv):
        cg = ctrl.reshape(gu, gv)
        cur = uv
        for _ in range(refine_steps):
            with torch.enable_grad():
                q = cur.detach().requires_grad_(True)
                ru = (q[:, 0] - uv0[:, 0]) * scale[0]
                rv = (q[:, 1] - uv0[:, 1]) * scale[1]
                rh = _height(cg, q) - target_h
                g, = torch.autograd.grad(torch.sum(ru * ru + rv * rv + rh * rh), q)
            cur = torch.clamp(cur - 0.1 * g / (scale[None, :] ** 2 + 1.0), 0.0, 1.0)
        return cur

    uv = uv0
    ctrl = solve(uv)
    for _ in range(iterations - 1):
        uv = reparam(ctrl, uv)
        ctrl = solve(uv)
    return BSplineSurface(control=ctrl.reshape(gu, gv), origin=lo, scale=scale, frame=frame,
                          centroid=mu)


def _polygon_contains(poly: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Even-odd ray casting: closed polygon ``[P, 2]``, points ``[M, 2]``."""
    x, y = pts[:, 0:1], pts[:, 1:2]
    x0, y0 = poly[None, :, 0], poly[None, :, 1]
    x1 = torch.roll(poly[:, 0], -1)[None, :]
    y1 = torch.roll(poly[:, 1], -1)[None, :]
    cond = (y0 <= y) != (y1 <= y)
    t = (y - y0) / torch.where(torch.abs(y1 - y0) > 1e-12, y1 - y0, 1e-12)
    xi = x0 + t * (x1 - x0)
    return (torch.sum(cond & (xi > x), dim=1) % 2) == 1


def fit_trimmed_bspline_surface(cloud: Cloud, grid_u: int = 10, grid_v: int = 10,
                                n_trim_control: int = 16, iterations: int = 3,
                                interior_smoothness: float = 1e-3,
                                boundary_smoothness: float = 1e-1) -> TrimmedBSplineSurface:
    """The iterated surface and its outer trim: a closed curve fitted to the
    footprint's contour in the parameter plane (per angular bin about the
    footprint's centroid the largest radius, 2% out; empty bins take the
    largest of all)."""
    surf = fit_bspline_surface_iterated(cloud, grid_u, grid_v, interior_smoothness,
                                        boundary_smoothness, iterations=iterations)
    local = (cloud.xyz - surf.centroid) @ surf.frame.T
    uv = (local[:, :2] - surf.origin) / surf.scale
    w = cloud.mask.to(torch.float32)
    cuv = (uv * w[:, None]).sum(0) / torch.clamp(w.sum(), min=1.0)
    rel = uv - cuv
    rad = torch.linalg.vector_norm(rel, dim=1)
    nbins = 64
    two_pi = float(np.float32(2 * math.pi))
    abin = torch.clamp(xla_int32((torch.atan2(rel[:, 1], rel[:, 0]) / two_pi + 0.5) * nbins)
                       .to(torch.int64), 0, nbins - 1)
    rmax = torch.full((nbins,), -math.inf, device=uv.device).scatter_reduce(
        0, abin, torch.where(cloud.mask, rad, 0.0), reduce="amax", include_self=False)
    rmax = torch.where(rmax > 0, rmax, torch.amax(rmax))
    pi32 = float(np.float32(math.pi))
    ang = (torch.arange(nbins, device=uv.device) + 0.5) / nbins * two_pi - pi32
    contour = cuv[None, :] + 1.02 * rmax[:, None] * torch.stack([torch.cos(ang), torch.sin(ang)],
                                                                dim=1)
    trim = fit_bspline_curve2d(contour, torch.ones(nbins, dtype=torch.bool, device=uv.device),
                               n_control=n_trim_control, smoothness=1e-3)
    return TrimmedBSplineSurface(surface=surf, trim=trim)


def trimmed_surface_contains(ts: TrimmedBSplineSurface, uv, n_poly: int = 128) -> torch.Tensor:
    """Inside-the-trim test of normalized ``(u, v)`` ``[M, 2]``."""
    dev = ts.trim.control.device
    uv = torch.as_tensor(uv, dtype=torch.float32, device=dev)
    t = torch.arange(n_poly, dtype=torch.float32, device=dev) / float(n_poly)
    return _polygon_contains(eval_bspline_curve2d(ts.trim, t), uv)


def eval_trimmed_bspline_surface(ts: TrimmedBSplineSurface, nu: int = 32, nv: int = 32,
                                 n_poly: int = 128):
    """The trimmed surface sampled on an ``nu x nv`` parameter grid:
    ``(points [nu nv, 3], inside [nu nv])``; points outside the trim are
    evaluated and masked."""
    from pcl_tpu_torch.surface.reconstruction import linspace32

    dev = ts.surface.control.device
    zero, one = torch.tensor(0.0, device=dev), torch.tensor(1.0, device=dev)
    uu, vv = torch.meshgrid(linspace32(zero, one, nu), linspace32(zero, one, nv), indexing="ij")
    uv = torch.stack([uu.reshape(-1), vv.reshape(-1)], dim=1)
    return eval_bspline_surface(ts.surface, uv), trimmed_surface_contains(ts, uv, n_poly=n_poly)


def create_mesh_indices(seg_x: int, seg_y: int, vidx: int = 0) -> np.ndarray:
    """Grid triangulation in the reference's order (on_nurbs
    Triangulation::createIndices): per quad ``(j, i)`` the triangles
    ``(i0, i1, i2)`` and ``(i0, i2, i3)`` over a ``seg_x + 1`` wide vertex
    grid, quads row-major: ``[2 seg_x seg_y, 3]`` int32."""
    j, i = np.meshgrid(np.arange(seg_y), np.arange(seg_x), indexing="ij")
    j, i = j.reshape(-1), i.reshape(-1)
    i0 = vidx + (seg_x + 1) * j + i
    i2 = vidx + (seg_x + 1) * (j + 1) + i + 1
    t1 = np.stack([i0, i0 + 1, i2], 1)
    t2 = np.stack([i0, i2, i2 - 1], 1)
    return np.stack([t1, t2], 1).reshape(-1, 3).astype(np.int32)


def convert_surface_to_mesh(surf: BSplineSurface, resolution: int):
    """``(vertices [(r+1)^2, 3] tensor, triangles [2 r^2, 3])``: the surface
    on its whole domain, vertices row ``j`` (v) outer and column ``i`` (u)
    inner (convertSurface2PolygonMesh)."""
    r = resolution
    u = np.linspace(0.0, 1.0, r + 1, dtype=np.float32)
    uv = np.stack([np.tile(u, r + 1), np.repeat(u, r + 1)], 1)
    return eval_bspline_surface(surf, uv), create_mesh_indices(r, r)


def _closed_curve_fit(points: torch.Tensor, w: torch.Tensor, theta: torch.Tensor,
                      n_control: int, smoothness: float) -> torch.Tensor:
    """Control points ``[G, D]`` of a closed cubic B-spline through
    ``points`` parameterized by angle ``theta``, with a periodic
    second-difference prior."""
    G = n_control
    dev = points.device
    two_pi = float(np.float32(2 * math.pi))
    t = (theta / two_pi + 0.5) * n_control
    i0 = xla_int32(torch.floor(t)).to(torch.int64)
    B = _cubic_basis(t - i0)
    N = points.shape[0]
    rows = torch.arange(N, device=dev)
    A = torch.zeros((N, G), dtype=torch.float32, device=dev)
    for a in range(4):
        A.index_put_((rows, torch.remainder(i0 + a - 1, G)), B[:, a] * w, accumulate=True)
    ii = torch.arange(G, device=dev)
    eye = torch.eye(G, device=dev)
    D = eye * 2.0 - eye[torch.remainder(ii + 1, G)] - eye[torch.remainder(ii - 1, G)]
    reg = float(np.float32(smoothness)) * torch.clamp(w.sum() / G, min=1.0)
    M = A.T @ A + reg * (D.T @ D) + 1e-6 * eye
    return _solve(M, A.T @ (points * w[:, None]))


def fit_bspline_curve2d(points, mask, n_control: int = 12, smoothness: float = 1e-2
                        ) -> BSplineCurve2D:
    """Closed cubic B-spline fit to 2-D points (FittingCurve2d), points
    parameterized by angle about their centroid."""
    points = torch.as_tensor(points, dtype=torch.float32)
    mask = torch.as_tensor(mask, device=points.device)
    w = mask.to(torch.float32)
    mu = (points * w[:, None]).sum(0) / torch.clamp(w.sum(), min=1.0)
    d = points - mu
    theta = torch.atan2(d[:, 1], d[:, 0])
    return BSplineCurve2D(control=_closed_curve_fit(points, w, theta, n_control, smoothness))


def fit_bspline_curve3d(points, mask, n_control: int = 12, smoothness: float = 1e-2
                        ) -> BSplineCurve3D:
    """Closed cubic B-spline space curve (on_nurbs FittingCurve): points
    parameterized by angle in their PCA plane."""
    points = torch.as_tensor(points, dtype=torch.float32)
    w = torch.as_tensor(mask, device=points.device).to(torch.float32)
    _, mu, frame = _pca_frame(points, w)
    local = (points - mu) @ frame.T
    theta = torch.atan2(local[:, 1], local[:, 0])
    ctrl = _closed_curve_fit(points, w, theta, n_control, smoothness)
    return BSplineCurve3D(control=ctrl, centroid=mu, frame=frame)


def _eval_closed(control: torch.Tensor, t) -> torch.Tensor:
    t = torch.as_tensor(t, dtype=torch.float32, device=control.device)
    G = control.shape[0]
    s = t * G
    i0 = xla_int32(torch.floor(s)).to(torch.int64)
    B = _cubic_basis(s - i0)
    out = torch.zeros((t.shape[0], control.shape[1]), dtype=torch.float32, device=control.device)
    for a in range(4):
        out = out + B[:, a:a + 1] * control[torch.remainder(i0 + a - 1, G)]
    return out


def eval_bspline_curve3d(curve: BSplineCurve3D, t) -> torch.Tensor:
    """The closed space curve at parameters ``t`` in ``[0, 1)``: ``[M, 3]``."""
    return _eval_closed(curve.control, t)


def eval_bspline_curve2d(curve: BSplineCurve2D, t) -> torch.Tensor:
    """The closed curve at parameters ``t`` in ``[0, 1)``: ``[M, 2]``."""
    return _eval_closed(curve.control, t)
