"""Particle-filter pose tracker (PCL's ``ParticleFilterTracker`` with the
distance coherence).

Counterpart of ``pcl_tpu/tracking/particle_filter.py``. A step diffuses the
``[P, 6]`` twist particles with Gaussian noise, moves a subsample of the
reference by every particle at once and scores all ``P x S`` moved points in
one 1-NN sweep against the scene (``bruteforce.nn1``: kernel B1 on CUDA
tensors), weights the particles by ``prod 1 / (1 + d^2 / sigma^2)``, folds
the weighted mean twist into the reference pose, and resamples
systematically.

The JAX package draws the noise, the subsample and the resampling offset
from a key it carries in the state. Here ``draw_tracker_step`` draws them
from a ``torch.Generator`` and ``step_tracker_core`` takes them (ROADMAP
C17); the state carries no key.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import Cloud, _device
from pcl_tpu_torch.core.transforms import se3_exp, transform_points
from pcl_tpu_torch.sac.ransac import categorical
from pcl_tpu_torch.search import bruteforce

DEFAULT_STEP_NOISE = (0.02, 0.02, 0.02, 0.02, 0.02, 0.02)


class ParticleFilterState(NamedTuple):
    particles: torch.Tensor     # [P, 6] twists relative to ref_pose
    weights: torch.Tensor       # [P]
    ref_pose: torch.Tensor      # [4, 4] current MAP pose estimate


class StepDraws(NamedTuple):
    noise: torch.Tensor         # [P, 6] standard normal
    sub: torch.Tensor           # [n_ref] reference rows
    u0: torch.Tensor            # resampling offset in [0, 1 / P)


def init_tracker(n_particles: int, init_pose: Optional[torch.Tensor] = None,
                 device=None) -> ParticleFilterState:
    """``n_particles`` particles at the identity twist about ``init_pose``
    (default the identity), on ``device`` (default CUDA)."""
    dev = _device(device)
    pose = torch.eye(4, dtype=torch.float32, device=dev) if init_pose is None \
        else torch.as_tensor(init_pose, dtype=torch.float32, device=dev)
    return ParticleFilterState(
        particles=torch.zeros((n_particles, 6), dtype=torch.float32, device=dev),
        weights=torch.full((n_particles,), 1.0 / n_particles, dtype=torch.float32, device=dev),
        ref_pose=pose)


def draw_step(n_particles: int, reference: Cloud, generator: torch.Generator,
              n_ref: int) -> StepDraws:
    """A step's draws: standard normal noise ``[P, 6]``, ``n_ref`` reference
    rows uniform over the valid ones, and the offset ``u0`` uniform in ``[0,
    1 / P)``, all on the generator's device and moved to the reference's."""
    dev = reference.xyz.device
    gd = generator.device
    noise = torch.randn((n_particles, 6), generator=generator, device=gd)
    sub = categorical(generator, reference.mask.to(gd).to(torch.float32), (n_ref,))
    u0 = torch.rand((), generator=generator, device=gd) * float(np.float32(1.0 / n_particles))
    return StepDraws(noise.to(dev), sub.to(dev), u0.to(dev))


def draw_tracker_step(state: ParticleFilterState, reference: Cloud,
                      generator: torch.Generator, n_ref: int = 256) -> StepDraws:
    """The sampler of :func:`step_tracker`."""
    return draw_step(state.particles.shape[0], reference, generator, n_ref)


def systematic_resample(u0: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``[P]`` weights to ``[P]`` parent indices: the first cumulative weight
    (normalised) at or past each of ``u0 + i / P`` (stochastic universal
    resampling). ``i / P`` is ``i`` times the float32 reciprocal of ``P``, as
    XLA forms a division by a constant (ROADMAP C79)."""
    P = weights.shape[0]
    cum = torch.cumsum(weights, dim=0)
    cum = cum / torch.clamp(cum[-1], min=1e-30)
    pts = u0 + torch.arange(P, dtype=torch.float32, device=weights.device) \
        * float(np.float32(1.0) / np.float32(P))
    return torch.searchsorted(cum, pts).to(torch.int32)


def coherence(reference: Cloud, scene: Cloud, particles: torch.Tensor, ref_pose: torch.Tensor,
              sub: torch.Tensor, coherence_sigma: float):
    """Each particle's log distance coherence: the moved subsample's 1-NN in
    the scene (one sweep of ``P S`` queries), ``-sum log1p(min(d^2, 1e6) /
    sigma^2)``. Returns ``(log_lik [P], Ts [P, 4, 4], idx [P, S], d2)``."""
    P = particles.shape[0]
    ref_sub = reference.xyz[sub.long()]                        # [S, 3]
    Ts = se3_exp(particles) @ ref_pose                         # [P, 4, 4]
    pts = transform_points(Ts, ref_sub[None])                  # [P, S, 3]
    S = ref_sub.shape[0]
    idx, d2 = bruteforce.nn1(scene.xyz, scene.mask, pts.reshape(P * S, 3))
    d2 = d2.reshape(P, S)
    s2 = torch.tensor(coherence_sigma, dtype=torch.float32, device=d2.device) ** 2
    log_lik = -torch.sum(torch.log1p(torch.clamp(d2, max=1e6) / s2), dim=1)
    return log_lik, Ts, idx.reshape(P, S), d2


def weigh(state: ParticleFilterState, reference: Cloud, scene: Cloud, draws: StepDraws,
          step_noise=None, coherence_sigma: float = 0.05):
    """The predict and weight stages on drawn ``draws``: ``(diffused
    particles [P, 6], weights [P], weighted mean twist [6])``."""
    sn = torch.as_tensor(DEFAULT_STEP_NOISE if step_noise is None else step_noise,
                         dtype=torch.float32, device=state.particles.device)
    particles = state.particles + draws.noise * sn[None, :]
    log_lik, _, _, _ = coherence(reference, scene, particles, state.ref_pose, draws.sub,
                                 coherence_sigma)
    log_lik = torch.where(torch.isfinite(log_lik), log_lik, -torch.inf)
    w = torch.softmax(log_lik, dim=0)
    return particles, w, torch.einsum("p,pi->i", w, particles)


def step_tracker_core(state: ParticleFilterState, reference: Cloud, scene: Cloud,
                      draws: StepDraws, *, step_noise=None, coherence_sigma: float = 0.05
                      ) -> Tuple[ParticleFilterState, torch.Tensor]:
    """One predict-weight-resample cycle on drawn ``draws``: ``(new state,
    MAP pose [4, 4])``."""
    P = state.particles.shape[0]
    particles, w, mean_xi = weigh(state, reference, scene, draws, step_noise, coherence_sigma)
    map_pose = se3_exp(mean_xi) @ state.ref_pose
    parents = systematic_resample(draws.u0, w)
    new = ParticleFilterState(
        particles=particles[parents.long()] - mean_xi[None, :],
        weights=torch.full((P,), 1.0 / P, dtype=torch.float32, device=w.device),
        ref_pose=map_pose)
    return new, map_pose


def step_tracker(state: ParticleFilterState, reference: Cloud, scene: Cloud, *,
                 generator: Optional[torch.Generator] = None, step_noise=None,
                 coherence_sigma: float = 0.05, n_ref: int = 256
                 ) -> Tuple[ParticleFilterState, torch.Tensor]:
    """One cycle: the sampler (a generator seeded 0 on the state's device
    unless one is given), then the core."""
    if generator is None:
        generator = torch.Generator(device=state.particles.device)
        generator.manual_seed(0)
    draws = draw_tracker_step(state, reference, generator, n_ref)
    return step_tracker_core(state, reference, scene, draws, step_noise=step_noise,
                             coherence_sigma=coherence_sigma)
