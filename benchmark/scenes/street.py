"""The synthetic KITTI-like street, a car's drive along it, and the scans a
Velodyne HDL-64E on the car takes, ray cast on the device.

``street_parts`` and ``street_hits`` are copied from the repository's
``chip_smoke.py`` (``street_hits`` returns device tensors here), so that a
later change there cannot move the yardstick. The sensor is the HDL-64E's
published pattern, as the configuration gives it: 64 rings in two blocks of
32, a full turn of azimuth steps, a maximum range and a Gaussian range
noise. The drive (``drive_poses``) is a car's: forward along the street at
KITTI's speed a scan, turning mostly in yaw (lane changes), with small pitch
and roll; its poses are a few hundred 4x4 matrices drawn on the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def street_parts(alleys: bool = False):
    """The street's surfaces: ``(ground height, quads, poles, pole radius,
    pole height, cars)``; a quad is ``(origin, edge u, edge v)`` (the ground,
    the facades and the alleys' walls first, then five faces of each car), a
    pole its ``(x, z)``, a car its box ``(lo, hi)``. (``chip_smoke.street_parts``.)"""
    g = -1.7
    quads = [((-20, g, 0), (40, 0, 0), (0, 0, 200))]
    quads += [((s * 10, g, 0), (0, 12, 0), (0, 0, 200)) for s in (-1, 1)]
    if alleys:
        quads += [((s * 10, g, z0), (s * 10, 0, 0), (0, 12, 0))
                  for s in (-1, 1) for z0 in range(12, 200, 12)]
    cars = []
    for i in range(10):
        x0, z0 = (-4.9 if i % 2 else 3.1), 8.0 + 19.0 * i
        lo, (dx, dy, dz) = np.array([x0, g, z0]), (1.8, 1.5, 4.5)
        quads += [(lo + (0, dy, 0), (dx, 0, 0), (0, 0, dz)),
                  (lo, (dx, 0, 0), (0, dy, 0)), (lo + (0, 0, dz), (dx, 0, 0), (0, dy, 0)),
                  (lo, (0, dy, 0), (0, 0, dz)), (lo + (dx, 0, 0), (0, dy, 0), (0, 0, dz))]
        cars.append((lo, lo + (dx, dy, dz)))
    poles = [(s * 7.0, 5.0 + 10.0 * j) for s in (-1, 1) for j in range(20)]
    return g, quads, poles, 0.15, 5.0, cars


def street_hits(o: torch.Tensor, d: torch.Tensor, alleys: bool = False) -> torch.Tensor:
    """Distance along rays ``o + t d`` (``o [3]``, ``d [N, 3]`` unit, the
    street's frame, float64) to the nearest of the street's surfaces, inf
    where nothing is hit. The cars are their boxes, the poles cylinders
    (x, z) standing on the ground. (``chip_smoke.street_hits``, on ``d``'s
    device.)"""
    g, quads, poles, r, h, cars = street_parts(alleys)
    n_planes = len(quads) - 5 * len(cars)
    f64 = dict(dtype=torch.float64, device=d.device)
    best = torch.full((len(d),), math.inf, **f64)
    safe = torch.where(d.abs() > 1e-12, d, 1e-12)

    def take(t, ok):
        ok = ok & (t > 1e-6) & (t < best)
        best.copy_(torch.where(ok, t, best))

    for q0, u, v in quads[:n_planes]:
        axis = int(np.argmax(np.abs(np.cross(u, v))))
        q0, u, v = (torch.as_tensor(np.asarray(a, float), **f64) for a in (q0, u, v))
        t = (q0[axis] - o[axis]) / safe[:, axis]
        rel = o - q0 + t[:, None] * d
        a, b = rel @ u / (u @ u), rel @ v / (v @ v)
        take(t, (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1))
    lo = torch.as_tensor(np.array([c[0] for c in cars]), **f64)          # [C, 3]
    hi = torch.as_tensor(np.array([c[1] for c in cars]), **f64)
    inv = 1.0 / safe[:, None, :]                                        # [N, 1, 3]
    t0, t1 = (lo - o) * inv, (hi - o) * inv                             # [N, C, 3]
    t_in = torch.minimum(t0, t1).amax(-1)
    t_out = torch.maximum(t0, t1).amin(-1)
    t_in = torch.where(t_in < t_out, t_in, math.inf).amin(-1)
    take(t_in, torch.isfinite(t_in))
    c = torch.as_tensor(np.array(poles, float), **f64)                  # [P, 2]: x, z
    A = (d[:, 0] ** 2 + d[:, 2] ** 2)[:, None]
    ox, oz = o[0] - c[:, 0], o[2] - c[:, 1]
    B = d[:, :1] * ox + d[:, 2:] * oz
    disc = B * B - A * (ox ** 2 + oz ** 2 - r * r)
    t = (-B - torch.sqrt(torch.clamp(disc, min=0))) / torch.clamp(A, min=1e-12)
    y = o[1] + t * d[:, 1:2]
    t = torch.where((disc > 0) & (t > 1e-6) & (y >= g) & (y <= g + h), t, math.inf).amin(-1)
    take(t, torch.isfinite(t))
    return best


def ring_elevations(rings) -> np.ndarray:
    """The lasers' elevations in radians, from ``[[count, first_deg,
    last_deg], ...]`` (each block evenly spaced)."""
    return np.radians(np.concatenate([np.linspace(a, b, int(n)) for n, a, b in rings]))


def yaw_pitch_roll(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """The rotation ``R_y(yaw) R_x(pitch) R_z(roll)`` of a frame with z
    forward and y up: yaw turns the heading towards +x."""
    cy, sy, cp, sp, cr, sr = (math.cos(yaw), math.sin(yaw), math.cos(pitch), math.sin(pitch),
                              math.cos(roll), math.sin(roll))
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    Rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    return Ry @ Rx @ Rz


def drive_poses(rng: np.random.Generator, scans: int, start_z: float, speed_m: float,
                speed_sd_m: float, lanes_x, lane_change_every: int, steer_gain: float,
                max_heading: float, yaw_rate_sd: float, pitch_sd: float,
                roll_sd: float) -> np.ndarray:
    """``[scans, 4, 4]`` poses (scan frame to street frame) of a car driving
    forward (+z) from ``start_z``: each scan it moves ``speed_m`` metres (an
    AR(1) wobble of ``speed_sd_m``) along its heading; the heading (yaw)
    steers towards the current lane, which switches between ``lanes_x``
    every ``lane_change_every`` scans, with a yaw-rate noise of
    ``yaw_rate_sd``; pitch and roll are AR(1) body motions of standard
    deviations ``pitch_sd`` and ``roll_sd`` radians."""
    x, z, yaw, pitch, roll, dv = float(lanes_x[0]), float(start_z), 0.0, 0.0, 0.0, 0.0
    a = 0.7
    b = math.sqrt(1 - a * a)
    out = []
    for k in range(scans):
        P = np.eye(4)
        P[:3, :3] = yaw_pitch_roll(yaw, pitch, roll)
        P[:3, 3] = (x, 0.0, z)
        out.append(P)
        lane = lanes_x[(k // lane_change_every) % len(lanes_x)]
        want = float(np.clip(steer_gain * (lane - x), -max_heading, max_heading))
        yaw += 0.3 * (want - yaw) + yaw_rate_sd * rng.normal()
        dv = a * dv + b * speed_sd_m * rng.normal()
        pitch = a * pitch + b * pitch_sd * rng.normal()
        roll = a * roll + b * roll_sd * rng.normal()
        v = speed_m + dv
        x += v * math.sin(yaw)
        z += v * math.cos(yaw)
    return np.stack(out)


def hdl64_scan(pose: np.ndarray, elevations: torch.Tensor, sensor: dict,
               gen: torch.Generator, alleys: bool = False) -> torch.Tensor:
    """One sweep of the street from a sensor at ``pose`` (scan frame to
    street frame): every ring at ``sensor["azimuth_steps"]`` azimuths a turn,
    started at an azimuth drawn from ``gen``; the returns within
    ``[min_range_m, max_range_m]``, with Gaussian range noise of
    ``range_noise`` metres. ``[N, 3]`` float32 in the scan's frame (z
    forward, y up) on ``elevations``' device."""
    dev = elevations.device
    f64 = dict(dtype=torch.float64, device=dev)
    n_az = int(sensor["azimuth_steps"])
    phase = torch.rand((), generator=gen, **f64)
    az = (torch.arange(n_az, **f64) + phase) * (2 * math.pi / n_az)
    el = elevations[:, None]
    d = torch.stack([torch.cos(el) * torch.sin(az), torch.sin(el).expand(-1, n_az),
                     torch.cos(el) * torch.cos(az)], -1).reshape(-1, 3)
    R = torch.as_tensor(pose[:3, :3], **f64)
    o = torch.as_tensor(pose[:3, 3], **f64)
    t = street_hits(o, d @ R.T, alleys)
    t = t + sensor["range_noise"] * torch.randn(t.shape, generator=gen, **f64)
    keep = torch.isfinite(t) & (t >= sensor["min_range_m"]) & (t <= sensor["max_range_m"])
    return (d[keep] * t[keep, None]).to(torch.float32).contiguous()


def generator(seed: int, device) -> torch.Generator:
    """A torch generator on ``device`` seeded from the run's seed (any whole
    number: reduced to the 64 bits the generator takes)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    return gen
