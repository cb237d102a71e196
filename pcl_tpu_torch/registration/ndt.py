"""Normal Distributions Transform: voxel Gaussians and a damped Newton loop
with analytic derivatives.

Counterpart of ``pcl_tpu/registration/ndt.py``. The target becomes a hashed
table of per-voxel Gaussians (mean, regularised inverse covariance); the source
pose is found by Newton steps on the sum of the Gaussian scores of the
transformed points over the 1, 7 or 27 voxels around each, with Armijo
backtracking in place of More-Thuente.

What the port keeps and what it drops:

- A bucket carries its owner cell's two integer keys. Distinct occupied cells
  that share a bucket are detected and the bucket invalidated, and a lookup
  whose cell is not the bucket's owner is masked: the same results as the JAX
  package's table.
- The JAX package's ``NDTGrid.packed`` (one 16-lane row per voxel, the keys
  bit-cast into floats) is a TPU layout and is dropped: the score gathers
  ``mean``, ``icov``, ``valid``, ``ckey1`` and ``ckey2``.
- ``build_grid`` reduces per bucket with the segmented-sum kernel B2
  (``ops/segsum.py``) after one stable sort by bucket, where the JAX package
  scatter-adds unsorted ids: on the card those would be float atomics, and two
  builds of one grid would differ in the last bits. The owner keys are integer
  ``amin``/``amax`` scatters, exact in any order.
- The Hessian's 6x6 blocks are three reductions over the gathered rows, not
  the JAX package's ``[NO, 18]`` matrix-unit chain. No autograd.
- The JAX package's ``lax.while_loop`` and ``lax.cond`` are a Python loop that
  reads back the Armijo test of the full step (and, when that fails, the
  outcome of the backtracking).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from pcl_tpu_torch.core import geometry
from pcl_tpu_torch.core.casts import xla_int32
from pcl_tpu_torch.core.cloud import Cloud
from pcl_tpu_torch.core.transforms import hat, se3_exp, transform_points
from pcl_tpu_torch.ops import segsum
from pcl_tpu_torch.search.cell_list import _cell_coords, _hash  # the shared hashing scheme

_OFFSETS7 = [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
_OFFSETS27 = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
_I32_MAX, _I32_MIN = 2 ** 31 - 1, -(2 ** 31)


@dataclasses.dataclass(frozen=True)
class NDTGrid:
    resolution: torch.Tensor    # 0-d f32
    table_size: int
    mean: torch.Tensor          # [table_size + 1, 3], 0 where not valid
    icov: torch.Tensor          # [table_size + 1, 3, 3], 0 where not valid
    valid: torch.Tensor         # [table_size + 1] bool: >= min_points, a
                                # non-degenerate covariance, one owner cell
    ckey1: torch.Tensor         # [table_size + 1] int32 owner identity:
                                # (cx & 0xFFFF) << 16 | (cy & 0xFFFF)
    ckey2: torch.Tensor         # [table_size + 1] int32 owner identity: cz


def _cell_keys(cc: torch.Tensor):
    """The two int32 keys that identify a cell: 16 + 16 bits of x and y (the
    shift wraps in int32 as the JAX package's does for a negative x), and z."""
    k = ((cc[..., 0].long() & 0xFFFF) << 16) | (cc[..., 1].long() & 0xFFFF)
    return torch.where(k >= 2 ** 31, k - 2 ** 32, k).to(torch.int32), cc[..., 2]


def _bucket_segments(xyz: torch.Tensor, mask: torch.Tensor, h: torch.Tensor):
    """The segmented sum behind a grid, as kernel B2 takes it: the rows sorted
    by bucket ``h`` (stable), 13 columns wide (xyz, the nine products, the
    weight). Returns ``(vals [N, 13], seg [N], seg_id, first, order)``."""
    order, seg_id, first = segsum.sort_segments(h[:, None], mask)
    columns = torch.cat([xyz, (xyz[:, :, None] * xyz[:, None, :]).reshape(-1, 9)], dim=1)
    vals, seg = segsum.sorted_inputs(columns, mask, order, seg_id)
    return vals, seg, seg_id, first, order


def _buckets(xyz: torch.Tensor, mask: torch.Tensor, resolution: torch.Tensor, table_size: int):
    """Cell coordinates ``[N, 3]`` and bucket ``[N]`` of each point; masked
    points take the spare bucket ``table_size``."""
    cc = _cell_coords(xyz, resolution)
    return cc, torch.where(mask, _hash(cc, table_size), table_size).to(torch.int32)


def build_grid(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    resolution,
    table_size: int = 1 << 18,
    min_points: int = 6,
) -> NDTGrid:
    """Per-voxel mean and regularised inverse covariance, keyed on the voxel
    hash: one stable sort by bucket and one segmented sum of 13 columns (xyz,
    the nine products, the weight; kernel B2 on CUDA tensors), whose compact
    rows are then copied to their buckets. Deterministic on both devices."""
    dev = xyz.device
    nseg = table_size + 1
    resolution = torch.as_tensor(resolution, dtype=torch.float32, device=dev)
    cc, h = _buckets(xyz, mask, resolution, table_size)
    pk1, pk2 = _cell_keys(cc)

    def owner(keys, fill, reduce):
        out = torch.full((nseg,), fill, dtype=torch.int32, device=dev)
        return out.scatter_reduce_(0, h.long(), torch.where(mask, keys, fill), reduce,
                                   include_self=True)

    pk1_min, pk1_max = owner(pk1, _I32_MAX, "amin"), owner(pk1, _I32_MIN, "amax")
    pk2_min, pk2_max = owner(pk2, _I32_MAX, "amin"), owner(pk2, _I32_MIN, "amax")
    # distinct occupied cells in one bucket: their merged Gaussian is bogus
    no_collision = (pk1_min == pk1_max) & (pk2_min == pk2_max)

    vals, seg, seg_id, first, order = _bucket_segments(xyz, mask, h)
    compact = segsum.segment_sum_sorted(vals, seg)
    # the first row of each segment carries its compact row to its bucket
    # (distinct targets); every other row goes to a spare row that is dropped
    dest = torch.where(first, h[order], nseg).long()
    sums = torch.zeros((nseg + 1, 13), dtype=torch.float32, device=dev)
    sums.index_copy_(0, dest, compact[seg_id.long()])
    s, ss, cnt = sums[:nseg, 0:3], sums[:nseg, 3:12].reshape(nseg, 3, 3), sums[:nseg, 12]

    mean = s / torch.clamp(cnt, min=1.0)[:, None]
    # sample covariance, (n - 1) normalisation
    cov = (ss - mean[:, :, None] * s[:, None, :]) / torch.clamp(cnt - 1.0, min=1.0)[:, None, None]
    lam, V = geometry.eigh33(cov)
    lam_max = lam[..., 2]
    # eigenvalues below 0.01 lambda_max are raised to it before inversion
    inv_lam = 1.0 / torch.clamp(torch.maximum(lam, 0.01 * lam_max[..., None]), min=1e-12)
    icov = torch.einsum("vik,vk,vjk->vij", V, inv_lam, V)
    valid = (cnt >= float(min_points)) & (lam_max > 0) & no_collision
    return NDTGrid(
        resolution=resolution,
        table_size=table_size,
        mean=torch.where(valid[:, None], mean, 0.0),
        icov=torch.where(valid[:, None, None], icov, 0.0),
        valid=valid,
        ckey1=pk1_min,
        ckey2=pk2_min,
    )


def _gauss_constants(resolution, outlier_ratio: float = 0.55):
    """``(d1, d2)`` of the log-mixture approximation of the score, as 0-d
    float32 tensors on the CPU; every step is float32 arithmetic, as in the
    JAX package."""
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32).cpu()  # noqa: E731
    c1 = f32(10.0 * (1.0 - outlier_ratio))
    c2 = f32(outlier_ratio) / f32(resolution) ** 3
    d3 = -torch.log(c2)
    d1 = -torch.log(c1 + c2) - d3
    d2 = -2.0 * torch.log((-torch.log(c1 * torch.exp(f32(-0.5)) + c2) - d3) / d1)
    return d1, d2


class _Rows(NamedTuple):
    """The voxels gathered for each (point, offset): ``[N * O]`` rows."""
    mean: torch.Tensor      # [NO, 3]
    icov: torch.Tensor      # [NO, 3, 3]
    ok: torch.Tensor        # [NO] bool: a valid voxel owned by the probed cell


def make_score_ops(grid: NDTGrid, offsets: torch.Tensor, res, d1, d2, sm: torch.Tensor):
    """The primitives of the NDT loop over a built grid: ``(gather_rows,
    score_from_rows, score_grad_hess)``. ``offsets [O, 3]`` int32 are the
    cells probed around each point, ``sm`` the source validity mask. A factory
    so that a sharded loop can apply the same primitives to its shard of the
    points against a replicated grid."""
    n_off = offsets.shape[0]
    # the score uses the upper triangle of each inverse covariance, mirrored
    upper = torch.triu(grid.icov)
    icov_sym = upper + torch.triu(grid.icov, 1).transpose(-1, -2)

    def gather_rows(p: torch.Tensor) -> _Rows:
        """The one gather from the voxel table per evaluated pose. When the
        full Newton step is accepted, the rows gathered for its trial are the
        next iteration's rows."""
        nb = xla_int32(torch.floor(p / res))[:, None, :] + offsets[None, :, :]
        b = _hash(nb, grid.table_size).reshape(-1).long()
        qk1, qk2 = _cell_keys(nb.reshape(-1, 3))
        # a bucket owned by another cell than the one probed (hash aliasing)
        # must not lend its Gaussian
        ok = grid.valid[b] & (grid.ckey1[b] == qk1) & (grid.ckey2[b] == qk2)
        return _Rows(grid.mean[b], icov_sym[b], ok & sm.repeat_interleave(n_off))

    def _terms(rows: _Rows, p: torch.Tensor):
        y = p.repeat_interleave(n_off, dim=0)                   # [NO, 3]
        x = y - rows.mean
        icd = torch.einsum("nij,nj->ni", rows.icov, x)
        return y, icd, torch.sum(x * icd, dim=-1)

    def score_from_rows(rows: _Rows, p: torch.Tensor) -> torch.Tensor:
        """The negated NDT score of the transformed points ``p [N, 3]``: the
        reference maximises ``-d1 exp(-d2/2 md)``, this minimises its negation
        ``sum d1 exp(...)`` (``d1 < 0``)."""
        _, _, md = _terms(rows, p)
        return torch.sum(torch.where(rows.ok, d1 * torch.exp(-0.5 * d2 * md), 0.0))

    def score_grad_hess(p: torch.Tensor, rows: _Rows):
        """``(f, g [6], H [6, 6])`` of the negated score with respect to a
        left twist at the current pose, in one pass over the gathered rows.

        With ``y`` the transformed point, ``d = y - mu``, ``icd = icov d``,
        ``e = exp(-d2/2 d.icd)``, ``Jp = [I | -[y]x]`` and ``q = Jp^T icd``:
        ``g = sum c q`` and ``H = sum c (Jp^T icov Jp + P) - d2 c q q^T`` with
        ``c = -d1 d2 e > 0`` and ``P`` the rotation block of the point
        Hessian, ``P_ij = (icd_j y_i + icd_i y_j) / 2 - (icd.y) delta_ij``."""
        y, icd, mah = _terms(rows, p)
        e = rows.ok.to(torch.float32) * torch.exp(-0.5 * d2 * torch.where(rows.ok, mah, 0.0))
        f = torch.sum(d1 * e)
        Q = torch.cat([icd, torch.linalg.cross(y, icd)], dim=1)  # [NO, 6]
        c = -d1 * d2 * e
        g = c @ Q
        eye3 = torch.eye(3, dtype=p.dtype, device=p.device).expand(y.shape[0], 3, 3)
        Jp = torch.cat([eye3, -hat(y)], dim=2)                   # [NO, 3, 6]
        W = torch.matmul(rows.icov, Jp) * c[:, None, None]
        H = Jp.reshape(-1, 6).T @ W.reshape(-1, 6)
        A = (y * c[:, None]).T @ icd
        P = 0.5 * (A + A.T) - torch.sum(c * torch.sum(y * icd, dim=-1)) \
            * torch.eye(3, dtype=p.dtype, device=p.device)
        H = H + (Q * (-d2 * c)[:, None]).T @ Q
        H[3:, 3:] += P
        return f, g, H

    return gather_rows, score_from_rows, score_grad_hess


class NDTResult(NamedTuple):
    transform: torch.Tensor     # [4, 4]
    converged: torch.Tensor     # bool
    iterations: torch.Tensor    # int32
    score: torch.Tensor         # f32: the mean Gaussian score per valid
                                # source point, sign flipped (lower is better)


def _newton_direction(g: torch.Tensor, H: torch.Tensor, step_size: float) -> torch.Tensor:
    """The damped Newton step, ``-g`` where that is no descent direction, its
    length capped at ``step_size``."""
    lam = 1e-3 * torch.clamp(torch.trace(H) / 6.0, min=1e-6)
    Hd = H + torch.abs(lam) * torch.eye(6, dtype=H.dtype, device=H.device)
    delta = -torch.linalg.solve_ex(Hd, g)[0]
    delta = torch.where(torch.dot(delta, g) < 0.0, delta, -g)
    dn = torch.linalg.norm(delta)
    return delta * torch.clamp(step_size / torch.clamp(dn, min=1e-12), max=1.0)


def ndt(
    source: Cloud,
    target: Cloud,
    resolution: float = 1.0,
    init_transform: Optional[torch.Tensor] = None,
    *,
    max_iterations: int = 35,
    transformation_eps: float = 1e-4,
    step_size: float = 0.1,
    outlier_ratio: float = 0.55,
    neighborhood: int = 7,
    table_size: int = 1 << 18,
    min_points: int = 6,
) -> NDTResult:
    """Align ``source`` onto ``target`` by maximising the NDT Gaussian score.

    ``neighborhood`` in {1, 7, 27} voxels are checked per point;
    ``step_size`` caps the length of a Newton step. The line search tries the
    full step first and, only when that fails the Armijo test (1e-4), the
    seven halvings, taking the largest that passes."""
    dev = source.xyz.device
    sx, sm = source.xyz, source.mask
    T = torch.eye(4, dtype=torch.float32, device=dev) if init_transform is None \
        else init_transform.to(device=dev, dtype=torch.float32)
    grid = build_grid(target.xyz, target.mask, resolution,
                      table_size=table_size, min_points=min_points)
    d1, d2 = (c.to(dev) for c in _gauss_constants(resolution, outlier_ratio))
    offsets = torch.tensor({1: _OFFSETS27[:1], 7: _OFFSETS7, 27: _OFFSETS27}[neighborhood],
                           dtype=torch.int32, device=dev)
    gather_rows, score_from_rows, score_grad_hess = make_score_ops(
        grid, offsets, grid.resolution, d1, d2, sm)

    def score_at(pose):
        p = transform_points(pose, sx)
        return score_from_rows(gather_rows(p), p)

    alphas = 2.0 ** -torch.arange(1, 8, dtype=torch.float32, device=dev)
    rows = gather_rows(transform_points(T, sx))
    score = torch.full((), math.inf, dtype=torch.float32, device=dev)
    done = False
    it = 0
    while it < max_iterations and not done:
        f0, g, H = score_grad_hess(transform_points(T, sx), rows)
        delta = _newton_direction(g, H, step_size)
        gd = torch.dot(g, delta)
        # the full step: its rows are the next iteration's when it is accepted
        T1 = se3_exp(delta) @ T
        p1 = transform_points(T1, sx)
        rows1 = gather_rows(p1)
        f1 = score_from_rows(rows1, p1)
        full_ok, small = torch.stack(
            [f1 <= f0 + 1e-4 * gd, torch.linalg.norm(delta) < transformation_eps]).tolist()
        it += 1
        if full_ok:
            T, rows, score, done = T1, rows1, f1, small
            continue
        # all seven halvings; the first that passes is the largest alpha
        scores = torch.stack([score_at(se3_exp(a * delta) @ T) for a in alphas])
        armijo = scores <= f0 + 1e-4 * alphas * gd
        aidx = torch.argmax(armijo.to(torch.int32))
        improved = armijo[aidx] & (scores[aidx] < f0)
        step = torch.where(improved, alphas[aidx], 0.0) * delta
        T = se3_exp(step) @ T
        rows = gather_rows(transform_points(T, sx))
        score = torch.where(improved, scores[aidx], f0)
        done = bool((torch.linalg.norm(step) < transformation_eps) | ~improved)
    done_t = torch.tensor(done, device=dev)
    return NDTResult(
        transform=T,
        converged=done_t & torch.isfinite(score),
        iterations=torch.tensor(it, dtype=torch.int32, device=dev),
        score=-score / torch.clamp(torch.sum(sm.to(torch.float32)), min=1.0),
    )
