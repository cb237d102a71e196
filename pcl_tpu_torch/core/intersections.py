"""Geometric intersections of lines and planes.

Counterpart of ``pcl_tpu/core/intersections.py``, copied: host numpy in
float64 with the reference's numerics and quirks (reference
common/intersections.h, common/src/distances.cpp). The plane-plane line
direction is the unnormalised cross product (the reference normalises a
temporary and discards it), and the line origin is the minimum-norm point
of the 5x5 Lagrange system.

Lines are ``[px, py, pz, dx, dy, dz]`` (a point and a direction, the SAC
line model's layout); planes ``[a, b, c, d]`` with ``ax + by + cz + d = 0``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def line_to_line_segment(line_a, line_b) -> Tuple[np.ndarray, np.ndarray]:
    """Closest segment between two 3D lines (distances.cpp
    lineToLineSegment — note the reference anchors the first line at
    point + direction)."""
    line_a = np.asarray(line_a, np.float64)
    line_b = np.asarray(line_b, np.float64)
    p1 = line_a[:3]
    u = line_a[3:6]
    p2 = p1 + u
    q1 = line_b[:3]
    v = line_b[3:6]
    w = p2 - q1
    a = u @ u
    b = u @ v
    c = v @ v
    d = u @ w
    e = v @ w
    den = a * c - b * b
    if den < 1e-5:              # almost parallel
        sc = 0.0
        tc = d / b if b > c else e / c
    else:
        sc = (b * e - c * d) / den
        tc = (a * e - b * d) / den
    return p2 + sc * u, q1 + tc * v


def line_with_line_intersection(line_a, line_b, sqr_eps: float = 1e-4
                                ) -> Tuple[bool, np.ndarray]:
    """(ok, point): the lines intersect when their closest-segment length
    squared is below ``sqr_eps``; the intersection is the segment's first
    endpoint (intersections.hpp:49). Returns a zero point on failure,
    like the reference's out-parameter."""
    p1, p2 = line_to_line_segment(line_a, line_b)
    if float(np.sum((p1 - p2) ** 2)) < sqr_eps:
        return True, p1
    return False, np.zeros(3, np.float64)


def plane_with_plane_intersection(plane_a, plane_b,
                                  angular_tolerance: float = 0.1
                                  ) -> Tuple[bool, np.ndarray]:
    """(ok, line[6]): the intersection line of two planes
    (intersections.hpp:79). Fails when the normals are within
    ``angular_tolerance`` of parallel (|cos| > 1 - sin|tol|). The line
    origin is the minimum-norm point on both planes (Lagrange 5x5
    system); the direction is the raw 4-component cross product's head
    (unnormalized, matching the reference's discarded ``normalized()``)."""
    pa = np.asarray(plane_a, np.float64)
    pb = np.asarray(plane_b, np.float64)
    na = pa[:3] / np.linalg.norm(pa[:3])
    nb = pb[:3] / np.linalg.norm(pb[:3])
    if abs(float(na @ nb)) > 1.0 - np.sin(abs(angular_tolerance)):
        return False, np.zeros(6, np.float64)
    direction = np.cross(pa[:3], pb[:3])
    M = np.array([
        [2, 0, 0, pa[0], pb[0]],
        [0, 2, 0, pa[1], pb[1]],
        [0, 0, 2, pa[2], pb[2]],
        [pa[0], pa[1], pa[2], 0, 0],
        [pb[0], pb[1], pb[2], 0, 0],
    ], np.float64)
    rhs = np.array([0, 0, 0, -pa[3], -pb[3]], np.float64)
    sol = np.linalg.solve(M, rhs)
    return True, np.concatenate([sol[:3], direction])


def three_planes_intersection(plane_a, plane_b, plane_c,
                              determinant_tolerance: float = 1e-6
                              ) -> Tuple[bool, np.ndarray]:
    """(ok, point): the common point of three planes
    (intersections.hpp:126). Fails (point untouched -> zeros here) when
    the normal matrix is near-singular."""
    pa = np.asarray(plane_a, np.float64)
    pb = np.asarray(plane_b, np.float64)
    pc = np.asarray(plane_c, np.float64)
    A = np.stack([pa[:3], pb[:3], pc[:3]])
    if abs(float(np.linalg.det(A))) < determinant_tolerance:
        return False, np.zeros(3, np.float64)
    return True, np.linalg.solve(A, -np.array([pa[3], pb[3], pc[3]]))
