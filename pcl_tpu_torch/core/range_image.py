"""Range images: spherical and planar 2.5-D projections of clouds.

Counterpart of ``pcl_tpu/core/range_image.py`` (reference pcl::RangeImage
createFromPointCloud, RangeImagePlanar). The z-buffer is one
``scatter_reduce_`` with ``amin`` into ``W H + 1`` slots (the last takes the
points that fall outside), which does not depend on the order of the points.
The image is ``[H, W]`` float32 with ``-inf`` where nothing was seen.

A pixel is ``floor`` of a float32 coordinate: a point within rounding of a
pixel edge may land in the neighbouring pixel when the two packages round
its angle apart (ROADMAP C27).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from pcl_tpu_torch.core.casts import norm3, xla_int32
from pcl_tpu_torch.core.cloud import Cloud, make_cloud


@dataclasses.dataclass(frozen=True)
class RangeImage:
    ranges: torch.Tensor        # [H, W] f32; -inf where unobserved
    angular_res: torch.Tensor   # scalar f32 (spherical) or focal length (planar)
    center: torch.Tensor        # [2] f32 image center (cx, cy)
    sensor_pose: torch.Tensor   # [4, 4] sensor-to-world
    planar: bool

    @property
    def shape(self):
        return tuple(self.ranges.shape)


def _in_sensor(cloud: Cloud, sensor_pose: Optional[torch.Tensor]):
    """``(points in the sensor frame, sensor_pose)``."""
    dev = cloud.xyz.device
    if sensor_pose is None:
        sensor_pose = torch.eye(4, dtype=torch.float32, device=dev)
    sensor_pose = torch.as_tensor(sensor_pose, dtype=torch.float32, device=dev)
    w2s = torch.linalg.inv(sensor_pose)
    return cloud.xyz @ w2s[:3, :3].T + w2s[:3, 3], sensor_pose


def _zbuffer(rng, u, v, inb, width: int, height: int) -> torch.Tensor:
    flat = torch.where(inb, v.long() * width + u.long(), width * height)
    img = torch.full((width * height + 1,), math.inf, dtype=torch.float32, device=rng.device)
    img.scatter_reduce_(0, flat, torch.where(inb, rng, math.inf), "amin")
    img = img[:-1]
    return torch.where(torch.isfinite(img), img, -math.inf).reshape(height, width)


def create_from_cloud(
    cloud: Cloud,
    angular_resolution: float = 0.5 * math.pi / 180.0,
    width: int = 720,
    height: int = 360,
    sensor_pose: Optional[torch.Tensor] = None,
) -> RangeImage:
    """Spherical projection with z-buffering (reference
    createFromPointCloud): azimuth over ``width`` and elevation over
    ``height`` at ``angular_resolution`` about the image center."""
    p, sensor_pose = _in_sensor(cloud, sensor_pose)
    rng = norm3(p)
    azimuth = torch.atan2(p[:, 0], p[:, 2])
    elevation = torch.asin(torch.where(rng > 0, p[:, 1] / torch.clamp(rng, min=1e-12), 0.0))
    cx, cy = width / 2.0, height / 2.0
    u = xla_int32(torch.floor(azimuth / angular_resolution + cx))
    v = xla_int32(torch.floor(elevation / angular_resolution + cy))
    inb = cloud.mask & (u >= 0) & (u < width) & (v >= 0) & (v < height) & (rng > 0)
    dev = rng.device
    return RangeImage(
        ranges=_zbuffer(rng, u, v, inb, width, height),
        angular_res=torch.tensor(angular_resolution, dtype=torch.float32, device=dev),
        center=torch.tensor([cx, cy], dtype=torch.float32, device=dev),
        sensor_pose=sensor_pose,
        planar=False,
    )


def create_planar_from_cloud(
    cloud: Cloud,
    focal_length: float,
    width: int,
    height: int,
    sensor_pose: Optional[torch.Tensor] = None,
) -> RangeImage:
    """Pinhole projection (reference range_image_planar.h: ``u = f x / z +
    cx``)."""
    p, sensor_pose = _in_sensor(cloud, sensor_pose)
    z = p[:, 2]
    cx, cy = width / 2.0, height / 2.0
    zc = torch.clamp(z, min=1e-12)
    u = xla_int32(torch.floor(focal_length * p[:, 0] / zc + cx))
    v = xla_int32(torch.floor(focal_length * p[:, 1] / zc + cy))
    rng = norm3(p)
    inb = cloud.mask & (z > 0) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    dev = rng.device
    return RangeImage(
        ranges=_zbuffer(rng, u, v, inb, width, height),
        angular_res=torch.tensor(focal_length, dtype=torch.float32, device=dev),
        center=torch.tensor([cx, cy], dtype=torch.float32, device=dev),
        sensor_pose=sensor_pose,
        planar=True,
    )


def to_cloud(ri: RangeImage) -> Cloud:
    """Unproject every observed pixel through its centre to a world-frame
    point (reference calculate3DPoint), an organized ``W x H`` cloud."""
    H, W = ri.ranges.shape
    dev = ri.ranges.device
    v, u = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev),
                          indexing="ij")
    r = ri.ranges.reshape(-1)
    uu = u.reshape(-1).to(torch.float32)
    vv = v.reshape(-1).to(torch.float32)
    observed = torch.isfinite(r) & (r > 0)
    if ri.planar:
        f = ri.angular_res
        x_over_z = (uu + 0.5 - ri.center[0]) / f
        y_over_z = (vv + 0.5 - ri.center[1]) / f
        z = r / torch.sqrt(1.0 + x_over_z ** 2 + y_over_z ** 2)
        p = torch.stack([x_over_z * z, y_over_z * z, z], dim=-1)
    else:
        az = (uu + 0.5 - ri.center[0]) * ri.angular_res
        el = (vv + 0.5 - ri.center[1]) * ri.angular_res
        ce = torch.cos(el)
        p = torch.stack([r * ce * torch.sin(az), r * torch.sin(el), r * ce * torch.cos(az)],
                        dim=-1)
    pw = p @ ri.sensor_pose[:3, :3].T + ri.sensor_pose[:3, 3]
    return make_cloud(torch.where(observed[:, None], pw, 0.0), observed,
                      width=W, height=H, device=dev)
