"""KLD-adaptive particle filter with the distance, normal and colour
coherences (PCL's ``KLDAdaptiveParticleFilterTracker``; ``distance_coherence.h``,
``normal_coherence.h``, ``hsv_color_coherence.h``).

Counterpart of ``pcl_tpu/tracking/kld.py``. The population is a fixed
``[P_max]`` array with an ``active`` prefix; each step counts the occupied
bins of the twist histogram and keeps Fox's KLD bound of particles alive,
``n = (k - 1) / (2 eps) (1 - a + sqrt(a) z)^3``, ``a = 2 / (9 (k - 1))``.
Every particle is scored in one 1-NN sweep (kernel B1 on CUDA tensors).

Sampler and core as in ``particle_filter.py``: ``draw_kld_step`` and
``step_tracker_kld_core`` (ROADMAP C17).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from pcl_tpu_torch.core.casts import xla_int32
from pcl_tpu_torch.core.cloud import ATTR_NORMAL, ATTR_RGB, Cloud, _device
from pcl_tpu_torch.core.transforms import se3_exp
from pcl_tpu_torch.tracking.particle_filter import (
    DEFAULT_STEP_NOISE,
    StepDraws,
    coherence,
    draw_step,
    systematic_resample,
)

_N_HIST = 8192
_HIST_MUL = (1, 7, 49, 343, 2401, 16807)


class KLDState(NamedTuple):
    particles: torch.Tensor     # [P_max, 6]
    active: torch.Tensor        # [P_max] bool
    ref_pose: torch.Tensor      # [4, 4]


def init_kld_tracker(max_particles: int, init_particles: Optional[int] = None,
                     init_pose: Optional[torch.Tensor] = None, device=None) -> KLDState:
    """``max_particles`` slots, the first ``init_particles`` (default all)
    alive, on ``device`` (default CUDA)."""
    dev = _device(device)
    pose = torch.eye(4, dtype=torch.float32, device=dev) if init_pose is None \
        else torch.as_tensor(init_pose, dtype=torch.float32, device=dev)
    n0 = init_particles or max_particles
    return KLDState(particles=torch.zeros((max_particles, 6), dtype=torch.float32, device=dev),
                    active=torch.arange(max_particles, device=dev) < n0, ref_pose=pose)


def _kld_required(n_bins_occupied: torch.Tensor, epsilon: float, z_delta: float) -> torch.Tensor:
    """Fox's KLD bound on the sample count (float32)."""
    dev = n_bins_occupied.device
    eps = torch.tensor(epsilon, dtype=torch.float32, device=dev)
    z = torch.tensor(z_delta, dtype=torch.float32, device=dev)
    k = torch.clamp(n_bins_occupied.to(torch.float32), min=2.0)
    a = 2.0 / (9.0 * (k - 1.0))
    t = 1.0 - a + torch.sqrt(a) * z
    return (k - 1.0) / (2.0 * eps) * (t * t * t)


def draw_kld_step(state: KLDState, reference: Cloud, generator: torch.Generator,
                  n_ref: int = 192) -> StepDraws:
    """The sampler of :func:`step_tracker_kld`."""
    return draw_step(state.particles.shape[0], reference, generator, n_ref)


def occupied_bins(particles: torch.Tensor, active: torch.Tensor, bin_size: float) -> torch.Tensor:
    """The number of histogram bins the active particles occupy: each
    particle's rounded twist hashed into 8,192 slots; a slot holds the
    activity of the last particle written to it, as XLA's scatter keeps the
    last of duplicate writes (ROADMAP C76)."""
    dev = particles.device
    q = xla_int32(torch.round(particles / torch.tensor(bin_size, dtype=torch.float32,
                                                       device=dev)))
    mul = torch.tensor(_HIST_MUL, dtype=torch.int32, device=dev)
    hkey = torch.remainder(torch.sum(torch.abs(q) * mul[None, :], dim=1, dtype=torch.int32),
                           _N_HIST)
    pos = torch.arange(particles.shape[0], device=dev)
    last = torch.full((_N_HIST,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, hkey.long(), pos, "amax")
    occupied = (last >= 0) & active[torch.clamp(last, min=0)]
    return torch.sum(occupied.to(torch.int32))


def weigh_kld(state: KLDState, reference: Cloud, scene: Cloud, draws: StepDraws,
              step_noise=None, coherence_sigma: float = 0.05, normal_weight: float = 0.0,
              color_weight: float = 0.0):
    """The predict and weight stages on drawn ``draws``, the inactive
    particles at weight 0: ``(diffused particles [P, 6], weights [P],
    weighted mean twist [6])``."""
    sn = torch.as_tensor(DEFAULT_STEP_NOISE if step_noise is None else step_noise,
                         dtype=torch.float32, device=state.particles.device)
    particles = state.particles + draws.noise * sn[None, :]
    log_lik, Ts, idx, _ = coherence(reference, scene, particles, state.ref_pose, draws.sub,
                                    coherence_sigma)
    idxc = torch.clamp(idx.long(), 0, scene.capacity - 1)
    sub = draws.sub.long()
    if normal_weight > 0 and ATTR_NORMAL in reference.attrs and ATTR_NORMAL in scene.attrs:
        cur_n = torch.einsum("pij,sj->psi", Ts[:, :3, :3], reference.attrs[ATTR_NORMAL][sub])
        cosang = torch.clamp(torch.sum(cur_n * scene.attrs[ATTR_NORMAL][idxc], -1), -1.0, 1.0)
        ang = torch.arccos(torch.abs(cosang))
        log_lik = log_lik - normal_weight * torch.sum(ang ** 2, dim=1)
    if color_weight > 0 and ATTR_RGB in reference.attrs and ATTR_RGB in scene.attrs:
        cd = torch.sum((reference.attrs[ATTR_RGB][sub][None] - scene.attrs[ATTR_RGB][idxc]) ** 2,
                       -1)
        log_lik = log_lik - color_weight * torch.sum(cd, dim=1)
    w = torch.softmax(torch.where(state.active, log_lik, -torch.inf), dim=0)
    return particles, w, torch.einsum("p,pi->i", w, particles)


def step_tracker_kld_core(
    state: KLDState,
    reference: Cloud,
    scene: Cloud,
    draws: StepDraws,
    *,
    step_noise=None,
    coherence_sigma: float = 0.05,
    normal_weight: float = 0.0,
    color_weight: float = 0.0,
    bin_size: float = 0.05,
    epsilon: float = 0.02,
    z_delta: float = 1.645,
    min_particles: int = 32,
) -> Tuple[KLDState, torch.Tensor]:
    """One adaptive predict-weight-resample cycle on drawn ``draws``:
    ``(new state, MAP pose [4, 4])``."""
    P = state.particles.shape[0]
    particles, w, mean_xi = weigh_kld(state, reference, scene, draws, step_noise,
                                      coherence_sigma, normal_weight, color_weight)
    map_pose = se3_exp(mean_xi) @ state.ref_pose
    n_req = _kld_required(occupied_bins(particles, state.active, bin_size), epsilon, z_delta)
    n_new = xla_int32(torch.clamp(n_req, float(min_particles), float(P)))
    parents = systematic_resample(draws.u0, w)
    new = KLDState(particles=particles[parents.long()] - mean_xi[None, :],
                   active=torch.arange(P, device=w.device) < n_new, ref_pose=map_pose)
    return new, map_pose


def step_tracker_kld(state: KLDState, reference: Cloud, scene: Cloud, *,
                     generator: Optional[torch.Generator] = None, n_ref: int = 192,
                     **kw) -> Tuple[KLDState, torch.Tensor]:
    """One cycle: the sampler (a generator seeded 0 on the state's device
    unless one is given), then the core (keywords as the core's)."""
    if generator is None:
        generator = torch.Generator(device=state.particles.device)
        generator.manual_seed(0)
    draws = draw_kld_step(state, reference, generator, n_ref)
    return step_tracker_kld_core(state, reference, scene, draws, **kw)
