"""Object tracking (counterpart of ``pcl_tpu/tracking``): the particle
filter and the KLD-adaptive particle filter, each scoring every particle in
one 1-NN sweep (kernel B1 on CUDA tensors), and pyramidal KLT. Each
filter's step is a sampler (``draw_tracker_step``, ``draw_kld_step``) and a
core that takes the draws (``step_tracker_core``, ``step_tracker_kld_core``).
``__all__`` is the JAX package's, in its order."""

from pcl_tpu_torch.tracking.particle_filter import (
    ParticleFilterState,
    init_tracker,
    step_tracker,
)
from pcl_tpu_torch.tracking.kld import KLDState, init_kld_tracker, step_tracker_kld
from pcl_tpu_torch.tracking.klt import pyramidal_klt

__all__ = ["ParticleFilterState", "init_tracker", "step_tracker", "KLDState", "init_kld_tracker",
           "step_tracker_kld", "pyramidal_klt"]
