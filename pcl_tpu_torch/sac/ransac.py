"""Batched-hypothesis sample consensus.

Counterpart of ``pcl_tpu/sac/ransac.py``: draw B minimal samples, fit B
models at once, score all ``[B, N]`` residuals in one reduction, keep the
best, refine it on its inliers. Scores (higher is better): ``ransac`` the
inlier count; ``msac`` minus the truncated squared loss; ``lmeds`` minus the
median squared residual; ``rransac`` / ``rmsac`` RANSAC / MSAC over a random
subset of the points; ``mlesac`` a Gaussian-inlier, uniform-outlier
log-likelihood.

The JAX package draws with a ``key``; the port cannot reproduce its streams.
So :func:`ransac` is a sampler (:func:`draw_samples`, a ``torch.Generator``
seeded 0 on the data's device unless one is given) followed by the
deterministic core :func:`ransac_core`, which takes the drawn indices and
the subset: given the JAX package's draws, the core gives its result.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from pcl_tpu_torch.sac.models import RegistrationModel, SacModel

Method = ("ransac", "msac", "lmeds", "rransac", "rmsac", "mlesac")


class SacResult(NamedTuple):
    coefficients: torch.Tensor   # [C] best model (refined if refine=True)
    inliers: torch.Tensor        # [N] bool
    num_inliers: torch.Tensor    # int32
    score: torch.Tensor          # f32, method-dependent, higher is better
    valid: torch.Tensor          # bool: a usable model was found


def generator(device, gen: Optional[torch.Generator] = None) -> torch.Generator:
    """``gen``, or a new generator on ``device`` seeded 0."""
    if gen is not None:
        return gen
    g = torch.Generator(device=device)
    g.manual_seed(0)
    return g


def categorical(gen: torch.Generator, weights: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """``shape`` int64 indices drawn with replacement in proportion to
    ``weights [N]`` (uniform where every weight is 0): the stand-in for
    ``jax.random.categorical`` over ``log(weights)``. The draw runs on the
    generator's device, so a CPU generator gives the same indices for data
    on either device."""
    w = weights.to(torch.float32)
    w = w + (torch.sum(w) == 0).to(torch.float32)
    n = math.prod(shape)
    idx = torch.multinomial(w.to(gen.device), n, replacement=True, generator=gen)
    return idx.to(weights.device).reshape(shape)


def _sample_indices(gen, n_hypotheses: int, sample_size: int, mask: torch.Tensor) -> torch.Tensor:
    """``[B, m]`` indices drawn among the valid points. Duplicates inside a
    sample are kept: they fit degenerate models, which score as none."""
    return categorical(gen, mask, (n_hypotheses, sample_size)).to(torch.int32)


def _prosac_order(quality: torch.Tensor, mask: torch.Tensor):
    """Valid points best first, and how many are valid."""
    order = torch.argsort(torch.where(mask, -quality, math.inf), stable=True)
    return order, torch.sum(mask.to(torch.int32))


def _prosac_sizes(n_hypotheses: int, sample_size: int, n_valid: torch.Tensor) -> torch.Tensor:
    """``m_b``: hypothesis b draws from the ``m_b`` best points, growing
    linearly from ``sample_size`` to the valid count over the batch."""
    b = torch.arange(n_hypotheses, dtype=torch.float32, device=n_valid.device) \
        / max(n_hypotheses - 1, 1)
    m_b = (sample_size + b * (n_valid.to(torch.float32) - sample_size)).to(torch.int32)
    return torch.clamp(m_b, min=sample_size)


def _prosac_indices(gen, n_hypotheses: int, sample_size: int, quality: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """PROSAC progressive sampling: ``[B, m]`` indices, hypothesis b drawing
    uniformly among the ``m_b`` highest-quality valid points."""
    order, n_valid = _prosac_order(quality, mask)
    m_b = _prosac_sizes(n_hypotheses, sample_size, n_valid)
    u = torch.rand((n_hypotheses, sample_size), generator=gen, device=mask.device)
    rank = torch.clamp((u * m_b[:, None]).to(torch.int64), max=mask.shape[0] - 1)
    return order[rank].to(torch.int32)


def draw_samples(model: SacModel, mask: torch.Tensor, n_hypotheses: int = 1024,
                 method: str = "ransac", rransac_frac: float = 0.1,
                 quality: Optional[torch.Tensor] = None,
                 gen: Optional[torch.Generator] = None):
    """The sampler of :func:`ransac`: ``(idx [B, m] int32, sub [N] bool)``,
    ``sub`` the random subset that ``rransac``/``rmsac`` score on (each
    valid point with probability ``rransac_frac``; all False otherwise)."""
    gen = generator(mask.device, gen)
    if quality is not None:
        idx = _prosac_indices(gen, n_hypotheses, model.sample_size, quality, mask)
    else:
        idx = _sample_indices(gen, n_hypotheses, model.sample_size, mask)
    if method in ("rransac", "rmsac"):
        sub = (torch.rand(mask.shape, generator=gen, device=mask.device) < rransac_frac) & mask
    else:
        sub = torch.zeros_like(mask)
    return idx, sub


def nanmedian(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Median over ``dim`` ignoring NaN, the two middle values averaged for
    an even count (``(lo + hi) * 0.5``, as ``jnp.nanmedian``); NaN where all
    are NaN. ``torch.nanmedian`` returns the lower middle value instead."""
    s, _ = torch.sort(x, dim=dim)                      # NaN sort last
    cnt = torch.sum(~torch.isnan(x), dim=dim, keepdim=True)
    lo = torch.gather(s, dim, torch.clamp((cnt - 1) // 2, min=0))
    hi = torch.gather(s, dim, torch.clamp(cnt // 2, max=x.shape[dim] - 1))
    med = ((lo + hi) * 0.5).squeeze(dim)
    return torch.where(cnt.squeeze(dim) > 0, med, math.nan)


def _distances(model, coeffs, xyz, normals, target_xyz, scores_with_normals):
    if isinstance(model, RegistrationModel):
        return model.distances(coeffs, xyz, target_xyz=target_xyz)
    if scores_with_normals:
        return model.distances(coeffs, xyz, normals=normals)
    return model.distances(coeffs, xyz)


def ransac_core(
    model: SacModel,
    xyz: torch.Tensor,
    mask: torch.Tensor,
    threshold: float,
    idx: torch.Tensor,
    sub: Optional[torch.Tensor] = None,
    *,
    method: str = "ransac",
    refine: bool = True,
    normals: Optional[torch.Tensor] = None,
    target_xyz: Optional[torch.Tensor] = None,
) -> SacResult:
    """The deterministic part of :func:`ransac`, from drawn sample indices
    ``idx [B, m]`` and the ``rransac``/``rmsac`` subset ``sub [N]``."""
    if method not in Method:
        raise ValueError(f"unknown method {method!r}")
    paired = isinstance(model, RegistrationModel)
    if paired and target_xyz is None:
        raise ValueError("RegistrationModel requires target_xyz")
    il = idx.long()
    samples = xyz[il]
    scores_with_normals = getattr(model, "scores_with_normals", False) and normals is not None
    if paired:
        coeffs = model.fit(samples, target_samples=target_xyz[il])
    else:
        coeffs = model.fit(samples, normals[il] if normals is not None else None)
    d = _distances(model, coeffs, xyz, normals, target_xyz, scores_with_normals)

    thr = float(np.float32(threshold))
    thr2 = float(np.float32(thr) * np.float32(thr))
    valid_pt = mask[None, :]
    d = torch.where(valid_pt, d, math.inf)
    model_ok = torch.all(torch.isfinite(coeffs), dim=-1)
    if method == "ransac":
        score = torch.sum((d <= thr).to(torch.float32), dim=-1)
    elif method == "msac":
        score = -torch.sum(torch.where(valid_pt, torch.clamp(d * d, max=thr2), 0.0), dim=-1)
    elif method == "lmeds":
        score = -nanmedian(torch.where(valid_pt, d * d, math.nan))
    elif method == "rransac":
        score = torch.sum(((d <= thr) & sub[None, :]).to(torch.float32), dim=-1)
    elif method == "rmsac":
        score = -torch.sum(torch.where(sub[None, :], torch.clamp(d * d, max=thr2), 0.0),
                           dim=-1)
    else:                                               # mlesac
        sigma = thr / 2.0
        inlier_ll = torch.exp(-0.5 * (d / sigma) ** 2) / (sigma * 2.5066283)
        out_ll = 1.0 / max(thr * 20.0, 1e-6)
        ll = torch.log(0.5 * inlier_ll + 0.5 * out_ll)
        score = torch.sum(torch.where(valid_pt, ll, 0.0), dim=-1)

    # an invalid model scores -inf (its NaN LMedS score too); argmax takes
    # the first of equal scores
    score = torch.where(model_ok, score, -math.inf)
    best = torch.argmax(score)
    best_coeffs = coeffs[best]
    inliers = mask & (d[best] <= thr)
    n_inl = torch.sum(inliers.to(torch.int32))
    ok = model_ok[best] & (n_inl >= model.sample_size)

    if refine:
        wi = inliers.to(torch.float32)
        if paired:
            refined = model.refine(best_coeffs, xyz, wi, target_xyz=target_xyz)
        else:
            refined = model.refine(best_coeffs, xyz, wi)
        refined_ok = torch.all(torch.isfinite(refined))
        best_coeffs = torch.where(ok & refined_ok, refined, best_coeffs)
        # inliers again under the refined model
        d_ref = _distances(model, best_coeffs[None], xyz, normals, target_xyz,
                           scores_with_normals)[0]
        inliers = mask & (d_ref <= thr)
        n_inl = torch.sum(inliers.to(torch.int32))

    return SacResult(coefficients=best_coeffs, inliers=inliers, num_inliers=n_inl,
                     score=score[best], valid=ok)


def ransac(
    model: SacModel,
    xyz: torch.Tensor,
    mask: torch.Tensor,
    threshold: float,
    *,
    gen: Optional[torch.Generator] = None,
    n_hypotheses: int = 1024,
    method: str = "ransac",
    refine: bool = True,
    normals: Optional[torch.Tensor] = None,
    target_xyz: Optional[torch.Tensor] = None,
    rransac_frac: float = 0.1,
    quality: Optional[torch.Tensor] = None,
) -> SacResult:
    """Fit ``model`` to the masked points robustly. ``target_xyz`` pairs the
    points for ``RegistrationModel`` (``xyz[i]`` with ``target_xyz[i]``);
    ``quality`` (higher is better) switches to PROSAC sampling."""
    if method not in Method:
        raise ValueError(f"unknown method {method!r}")
    idx, sub = draw_samples(model, mask, n_hypotheses, method, rransac_frac, quality, gen)
    return ransac_core(model, xyz, mask, threshold, idx, sub, method=method, refine=refine,
                       normals=normals, target_xyz=target_xyz)
