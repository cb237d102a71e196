"""Sample consensus: batched-hypothesis robust model fitting (counterpart of
``pcl_tpu/sac``). Every hypothesis is drawn, solved and scored in one batch;
the sampling is split from the deterministic core (``sac.ransac``)."""

from pcl_tpu_torch.sac.models import (
    Circle2DModel,
    CircleModel3D,
    ConeModel,
    CylinderModel,
    Ellipse3DModel,
    LineModel,
    NormalParallelPlaneModel,
    NormalPlaneModel,
    NormalSphereModel,
    ParallelLineModel,
    ParallelPlaneModel,
    PerpendicularPlaneModel,
    PlaneModel,
    RegistrationModel,
    SacModel,
    SphereModel,
    StickModel,
    TorusModel,
)
from pcl_tpu_torch.sac.ransac import Method, SacResult, draw_samples, ransac, ransac_core
