"""Float64 margin checks of descriptor decisions (ROADMAP C19, C45), shared
by the descriptor parity tests and ``chip_smoke.py`` path K. numpy only: no
JAX and no torch, so the smoke script can load it on the card's machine.

Each check redoes a descriptor's decisions in float64 from given neighbour
lists and flags each query with a decision within a stated margin of its
cut: those rows are counted, and every other row is held to the stated
tolerance.
"""

import math

import numpy as np

EDGE = 1e-5       # FPFH-type pair features: the margin, in the features' own units


def near_grid(u, eps):
    """``u`` within ``eps`` of an integer (never where ``u`` is not finite)."""
    with np.errstate(invalid="ignore"):
        return np.abs(u - np.round(u)) < eps


def isolated(lam, rel):
    """All three eigenvalues (ascending, float64) more than ``rel`` of the
    largest apart."""
    scale = np.maximum(np.abs(lam[..., 2]), 1e-30)
    return ((lam[..., 1] - lam[..., 0]) > rel * scale) & ((lam[..., 2] - lam[..., 1]) > rel * scale)


def hard_lrf64(xyz, idx, valid, radius, rel=0.05, eps=1e-4):
    """SHOT's ``local_reference_frames`` in float64 on the given neighbour
    lists: ``(frames [N, 3, 3], firm [N])``, firm where the eigenvalues are
    ``rel`` apart and each sign sum is more than ``eps`` of its absolute sum
    from 0."""
    x = xyz.astype(np.float64)
    d = x[idx] - x[:, None, :]
    dist = np.linalg.norm(d, axis=-1)
    w = np.where(valid, np.maximum(radius - dist, 0.0), 0.0)
    cov = np.einsum("nk,nki,nkj->nij", w, d, d) / np.maximum(w.sum(1), 1e-12)[:, None, None]
    lam, V = np.linalg.eigh(cov)
    firm = isolated(lam, rel)
    axes = []
    for col in (2, 0):
        v = V[..., :, col]
        t = np.einsum("nk,nki,ni->nk", w, d, v)
        s = t.sum(1)
        firm &= np.abs(s) > eps * np.maximum(np.abs(t).sum(1), 1e-30)
        axes.append(np.where((s < 0)[:, None], -v, v))
    xa, za = axes
    return np.stack([xa, np.cross(za, xa), za], axis=-2), firm & (valid.sum(1) >= 5)


def shot_firm(xyz, nrm, qxyz, idx, d2, valid, radius, rel=0.05, eps=1e-4):
    """Queries of ``estimate_shot_interpolated`` with every decision firm,
    in float64 on the given neighbour lists (``idx``, ``d2`` of the queries
    ``qxyz`` into ``xyz``): the LRF's eigenvalues ``rel`` apart, no
    neighbour's projection on x or z within ``eps`` radius of 0 (the sign
    votes; a tie's median window likewise), and for every neighbour no
    coordinate, ``|x| - |y|``, distance shell (or the radius), cosine bin, inclination or
    azimuth cut within ``eps`` (in radii, bins or radians)."""
    x = xyz.astype(np.float64)
    q = qxyz.astype(np.float64)
    r = float(np.float32(radius))
    e = eps * r
    ok = valid & (d2 <= np.float32(r) ** 2) & (d2 > 0)
    v = x[idx] - q[:, None, :]
    d = np.sqrt(np.maximum(d2.astype(np.float64), 0.0))
    w = np.where(ok, r - d, 0.0)
    lam, V = np.linalg.eigh(np.einsum("nk,nki,nkj->nij", w, v, v))
    firm = isolated(lam, rel) & (ok.sum(1) >= 5)
    nvalid = ok.sum(1)
    pos = np.clip((nvalid // 2 + 1)[:, None] - np.arange(-2, 3)[None, :], 0, idx.shape[1] - 1)
    axes = []
    for col in (2, 0):
        a = V[..., :, col]
        dp = np.einsum("nki,ni->nk", v, a)
        dpm = np.take_along_axis(dp, pos, 1)
        firm &= ~np.any(ok & (np.abs(dp) < e), axis=1) & ~np.any(np.abs(dpm) < e, axis=1)
        s = np.sum((dp >= 0) & ok, axis=1) * 2 - nvalid
        flip = (s < 0) | ((s == 0) & (np.sum(dpm > 0, axis=1) < 3))
        axes.append(np.where(flip[:, None], -a, a))
    v1, v3 = axes
    v2 = np.cross(v3, v1)
    xf, yf, zf = (np.einsum("nki,ni->nk", v, a) for a in (v1, v2, v3))
    nn = nrm.astype(np.float64)[idx]
    bin_d = (1.0 + np.clip(np.einsum("nki,ni->nk", nn, v3), -1, 1)) * 5.0
    incl = np.arccos(np.clip(zf / np.maximum(d, 1e-12), -1, 1))
    azim = np.arctan2(yf, xf)
    cut = ((np.abs(xf) < e) | (np.abs(yf) < e) | (np.abs(zf) < e)
           | (np.abs(np.abs(xf) - np.abs(yf)) < e)
           | (np.min(np.abs(d[..., None] - r * np.array([0.25, 0.5, 0.75, 1.0])), -1) < e)
           | near_grid(2.0 * bin_d, eps) | near_grid(incl / (np.pi / 4), eps)
           | near_grid(azim / (np.pi / 8), eps))
    return firm & ~np.any(ok & cut, axis=1)


def hard_firm(xyz, nrm, idx, valid, radius, n_cos_bins=11, lab=None, n_color_bins=31,
              eps=1e-4):
    """Queries of ``estimate_shot_hard`` / ``estimate_shot_color`` with every
    decision firm (float64 on the given radius lists): the LRF firm
    (``hard_lrf64``) and no neighbour within ``eps`` (radii or bins) of an
    azimuth sector edge, the elevation plane, the half radius, a cosine bin
    edge or, with ``lab``, a colour bin edge."""
    frames, firm = hard_lrf64(xyz, idx, valid, radius, eps=eps)
    x = xyz.astype(np.float64)
    rel = x[idx] - x[:, None, :]
    loc = np.einsum("nai,nki->nka", frames, rel)
    r = float(np.float32(radius))
    dist = np.linalg.norm(rel, axis=-1)
    cosang = np.einsum("ni,nki->nk", frames[:, 2, :], nrm.astype(np.float64)[idx])
    cut = (near_grid(np.arctan2(loc[..., 1], loc[..., 0]) / (np.pi / 4), eps)
           | (np.abs(loc[..., 2]) < eps * r) | (np.abs(dist - 0.5 * r) < eps * r)
           | near_grid((cosang + 1.0) * 0.5 * n_cos_bins, eps))
    if lab is not None:
        lab = lab.astype(np.float64)
        dl = np.abs(lab[idx] - lab[:, None, :])
        ld = np.clip((dl[..., 0] / 100 + (dl[..., 1] / 120 + dl[..., 2] / 120) * 0.5) / 3, 0, 1)
        cut |= near_grid(ld * n_color_bins, eps)
    return firm & ~np.any(valid & cut, axis=1)


def sc_firm(frames, xyz, idx, valid, d2, radius, min_r, radial_bins=15, elevation_bins=11,
            azimuth_bins=12, eps=1e-4):
    """Rows of a shape context (3DSC, USC) with no neighbour within ``eps``
    (bins, or radii for the log-radial shells and the radius) of a bin edge,
    in float64 in ``frames``."""
    x = xyz.astype(np.float64)
    rel = np.einsum("nij,nkj->nki", frames.astype(np.float64), x[idx] - x[:, None, :])
    d = np.linalg.norm(rel, axis=-1)
    edges = min_r * (radius / min_r) ** (np.arange(radial_bins + 1) / radial_bins)
    el = np.arccos(np.clip(rel[..., 2] / np.maximum(d, 1e-12), -1, 1))
    az = np.arctan2(rel[..., 1], rel[..., 0])
    cut = ((np.min(np.abs(d[..., None] - edges), -1) < eps * radius)
           | near_grid(el / np.pi * elevation_bins, eps)
           | near_grid(az / (2 * np.pi) * azimuth_bins, eps))
    return ~np.any(valid & (d2 > 1e-12) & cut, axis=1)


def rot(axis, angle):
    """3x3 rotation about coordinate axis ``axis`` by ``angle`` (RoPS's)."""
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[[1, 0, 0], [0, c, -s], [0, s, c]],
                     [[c, 0, s], [0, 1, 0], [-s, 0, c]],
                     [[c, -s, 0], [s, c, 0], [0, 0, 1]]][axis], np.float64)


def rops_firm(frames, xyz, idx, valid, radius, n_rotations=3, grid=8, eps=1e-4):
    """Rows of cloud RoPS with no neighbour within ``eps`` bins of a grid
    edge (each rotated projection's grid spans its bounding box), in float64
    from ``frames``."""
    x = xyz.astype(np.float64)
    rel = np.einsum("nij,nkj->nki", frames.astype(np.float64), x[idx] - x[:, None, :]) / radius
    firm = np.ones(len(idx), bool)
    for axis in range(3):
        for ai in range(n_rotations):
            p = np.einsum("ij,nkj->nki", rot(axis, (ai + 1.0) / (n_rotations + 1.0) * 0.5 * np.pi),
                          rel)
            for c in range(3):
                u = p[..., c]
                lo = np.min(np.where(valid, u, np.inf), 1)[:, None]
                hi = np.max(np.where(valid, u, -np.inf), 1)[:, None]
                pos = (u - lo) / np.maximum(hi - lo, 1e-12) * grid
                firm &= ~np.any(valid & near_grid(pos, eps) & (pos > eps)
                                & (pos < grid - eps), axis=1)
    return firm


def _edge_gap(f, lo, hi, nbins):
    """Distance of f (in its own units) from the nearest bin edge."""
    u = nbins * (f - lo) / (hi - lo)
    return np.abs(u - np.round(u)) * (hi - lo) / nbins


def pair_features64(p1, n1, p2, n2, swap):
    """FPFH's pair features in float64 with the source chosen by ``swap``:
    ``(f1, f2, f3, |v|, hypot of atan2's arguments)``."""
    p1, n1, p2, n2 = (np.broadcast_to(x, np.broadcast_shapes(
        p1.shape, n1.shape, p2.shape, n2.shape)).astype(np.float64) for x in (p1, n1, p2, n2))
    d = p2 - p1
    inv = 1.0 / np.maximum(np.linalg.norm(d, axis=-1), 1e-12)
    sw = swap[..., None]
    n1c, n2c, dc = np.where(sw, n2, n1), np.where(sw, n1, n2), np.where(sw, -d, d)
    f3 = np.sum(n1c * dc, -1) * inv
    v = np.cross(dc, n1c)
    vn = np.linalg.norm(v, axis=-1)
    v = v / np.maximum(vn, 1e-12)[..., None]
    w = np.cross(n1c, v)
    y, x = np.sum(w * n2c, -1), np.sum(n1c * n2c, -1)
    return np.arctan2(y, x), np.sum(v * n2c, -1), f3, vn * inv, np.hypot(y, x)


def pair_bins(f1, f2, f3, nbins):
    """The three pair features' bins."""
    b = [np.clip(np.floor(nbins * (f - lo) / (hi - lo)), 0, nbins - 1)
         for f, lo, hi in ((f1, -math.pi, math.pi), (f2, -1.0, 1.0), (f3, -1.0, 1.0))]
    return np.stack(b, -1)


def pair_unsure(p1, n1, p2, n2, nbins, edge=EDGE):
    """Pairs whose bins a rounding can change: a feature within ``edge`` of a
    bin edge (atan2's cut at +-pi included), the source choice within
    ``edge`` of flipping where the other choice bins differently, or a
    degenerate frame (``|d x n1|`` or both atan2 arguments within ``edge``
    of 0)."""
    a1 = np.sum(n1 * (p2 - p1), -1)
    a2 = np.sum(n2 * (p2 - p1), -1)
    dn = np.maximum(np.linalg.norm(np.broadcast_to(p2 - p1, np.broadcast_shapes(
        p1.shape, p2.shape)), axis=-1), 1e-12)
    swap = np.abs(a1) < np.abs(a2)
    f1, f2, f3, vn, r = pair_features64(p1, n1, p2, n2, swap)
    g1, g2, g3, _, _ = pair_features64(p1, n1, p2, n2, ~swap)
    near = ((_edge_gap(f1, -math.pi, math.pi, nbins) <= edge)
            | (_edge_gap(f2, -1.0, 1.0, nbins) <= edge)
            | (_edge_gap(f3, -1.0, 1.0, nbins) <= edge))
    flip = (np.abs(np.abs(a1) - np.abs(a2)) / dn <= edge) & np.any(
        pair_bins(f1, f2, f3, nbins) != pair_bins(g1, g2, g3, nbins), -1)
    return near | flip | (vn <= edge) | (r <= edge)


def spfh_firm(xyz, nrm, idx, valid, nbins=11):
    """Per point: none of its pairs (the neighbour lists ``idx``, ``valid``;
    the point itself aside) is ``pair_unsure``."""
    ic = np.clip(idx, 0, len(xyz) - 1)
    near = pair_unsure(xyz[:, None], nrm[:, None], xyz[ic], nrm[ic], nbins)
    self_pair = np.all(xyz[ic] == xyz[:, None], axis=-1)
    return ~(near & valid & ~self_pair).any(axis=1)


def fpfh_firm(spfh_ok, idx, valid):
    """FPFH mixes the neighbours' SPFH rows: firm where they all are."""
    ic = np.clip(idx, 0, len(spfh_ok) - 1)
    return spfh_ok & np.all(spfh_ok[ic] | ~valid, axis=1)
