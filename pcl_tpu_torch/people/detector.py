"""Ground-based people detection (PCL's ``GroundBasedPeopleDetectionApp``).

Counterpart of ``pcl_tpu/people/detector.py``: the ground plane (given, as
PCL's ``setGround``, or by RANSAC), Euclidean clusters of what lies off it,
head-based subclusters that split people standing close (host numpy,
copied), a height gate, and the HOG and SVM confidence of each candidate's
window in the RGB image (``people/classifier.py``) or the optional SVM on
its shape.

The JAX package draws RANSAC's samples with a key; here
``draw_ground_samples`` draws them and ``detect`` takes them (``samples=``),
so the tests feed the JAX draws (ROADMAP C17). ``voxel_size`` is kept but
not used, as in the JAX package: the caller downsamples first (C81).
"""

from __future__ import annotations

import importlib
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import Cloud
from pcl_tpu_torch.sac import models as sac_models
from pcl_tpu_torch.segmentation import euclidean_clusters

# the module (``pcl_tpu_torch.sac.ransac`` names the function)
sac_ransac = importlib.import_module("pcl_tpu_torch.sac.ransac")

GROUND_THRESHOLD = 0.05          # m: a point this near the plane is ground
GROUND_HYPOTHESES = 1024         # sac_segmentation's default


class PersonCandidate(NamedTuple):
    centroid: np.ndarray
    height: float
    n_points: int
    score: float


def head_based_subclusters(
    pts: np.ndarray,
    n: np.ndarray,
    d0: float,
    min_height: float = 1.3,
    max_height: float = 2.3,
    heads_min_distance: float = 0.3,
    bin_size: float = 0.06,
) -> List[np.ndarray]:
    """Split one euclidean cluster into per-person subclusters by height-map
    maxima (PCL's people/include/pcl/people/head_based_subcluster.h and
    height_map_2d.h: people standing close merge into one cluster; their
    HEADS stay distinct as local maxima of height-above-ground binned over
    the ground plane).

    ``pts`` [N,3] cluster points, ``(n, d0)`` the ground plane (n·x + d0 =
    height). Returns a list of boolean masks over ``pts``.
    """
    h = pts @ n + d0
    # 2D ground-plane coordinates: two axes orthogonal to n
    a = np.array([1.0, 0.0, 0.0])
    if abs(n[0]) > 0.9:
        a = np.array([0.0, 1.0, 0.0])
    u = np.cross(n, a)
    u /= np.linalg.norm(u)
    v = np.cross(n, u)
    g = np.stack([pts @ u, pts @ v], axis=1)
    gmin = g.min(0)
    ij = np.floor((g - gmin) / bin_size).astype(np.int64)
    dims = ij.max(0) + 1
    lin = ij[:, 0] * dims[1] + ij[:, 1]
    hmap = np.zeros(dims[0] * dims[1], np.float32)
    np.maximum.at(hmap, lin, h.astype(np.float32))
    hmap = hmap.reshape(dims[0], dims[1])
    # local maxima above min_height, separated by heads_min_distance
    rad = max(1, int(round(heads_min_distance / bin_size)))
    pad = np.pad(hmap, rad, constant_values=0)
    windows = np.stack([
        pad[rad + dy:rad + dy + dims[0], rad + dx:rad + dx + dims[1]]
        for dy in range(-rad, rad + 1) for dx in range(-rad, rad + 1)
    ])
    is_max = (hmap >= windows.max(0)) & (hmap >= min_height) \
        & (hmap <= max_height + 0.5)
    heads = np.argwhere(is_max)
    if len(heads) <= 1:
        return [np.ones(len(pts), bool)]
    # suppress maxima closer than heads_min_distance (keep the taller)
    order = np.argsort(-hmap[heads[:, 0], heads[:, 1]])
    kept = []
    for hidx in order:
        c = heads[hidx]
        if all(np.linalg.norm((c - k) * bin_size) >= heads_min_distance
               for k in kept):
            kept.append(c)
    heads = np.asarray(kept)
    if len(heads) <= 1:
        return [np.ones(len(pts), bool)]
    # assign points to the nearest head in ground-plane coordinates
    head_g = heads * bin_size + gmin + 0.5 * bin_size
    d2 = ((g[:, None, :] - head_g[None, :, :]) ** 2).sum(-1)
    assign = np.argmin(d2, axis=1)
    return [assign == k for k in range(len(heads))]


class GroundBasedPeopleDetector:
    """PCL's setX/compute style: set the parameters, then ``detect`` a
    cloud."""

    def __init__(
        self,
        voxel_size: float = 0.06,
        min_height: float = 1.3,
        max_height: float = 2.3,
        min_points: int = 30,
        cluster_tolerance: float = 0.2,
        svm_model=None,
        ground_coeffs: Optional[np.ndarray] = None,
        intrinsics: Optional[np.ndarray] = None,
        classifier=None,
        min_confidence: float = -1.5,
        subcluster: bool = True,
    ):
        self.voxel_size = voxel_size
        self.min_height = min_height
        self.max_height = max_height
        self.min_points = min_points
        self.cluster_tolerance = cluster_tolerance
        self.svm_model = svm_model
        self.ground_coeffs = ground_coeffs     # setGround
        self.last_ground = None                # getGround: the plane the last detect used
        self.intrinsics = intrinsics           # setIntrinsics (3x3 K)
        self.classifier = classifier           # PersonClassifier
        self.min_confidence = min_confidence
        self.subcluster = subcluster

    @staticmethod
    def draw_ground_samples(cloud: Cloud, gen: Optional[torch.Generator] = None):
        """The sampler of the RANSAC ground: ``(idx [1024, 3], sub [N])`` as
        ``sac.ransac.draw_samples`` draws them for a plane."""
        return sac_ransac.draw_samples(sac_models.PlaneModel(), cloud.mask, GROUND_HYPOTHESES,
                                       gen=gen)

    def ground(self, cloud: Cloud, gen: Optional[torch.Generator] = None, samples=None):
        """``(cloud off the ground, unit plane coefficients [4] float64)``:
        the set ground's points within 5 cm, or RANSAC's inliers on
        ``samples`` (drawn from ``gen`` when None). The plane is turned so
        that the points off it sit at positive height (the median's sign),
        whether the camera is above the floor or the plane passes near the
        origin."""
        if self.ground_coeffs is not None:
            coeffs = np.asarray(self.ground_coeffs, np.float64)
            coeffs = coeffs / max(np.linalg.norm(coeffs[:3]), 1e-12)
            d_all = cloud.xyz.cpu().numpy() @ coeffs[:3] + coeffs[3]
            inliers = torch.as_tensor(np.abs(d_all) < GROUND_THRESHOLD,
                                      device=cloud.mask.device) & cloud.mask
            above = cloud.with_mask(cloud.mask & ~inliers)
        else:
            idx, sub = samples if samples is not None else self.draw_ground_samples(cloud, gen)
            res = sac_ransac.ransac_core(sac_models.PlaneModel(), cloud.xyz, cloud.mask,
                                         GROUND_THRESHOLD, idx.to(cloud.mask.device),
                                         sub.to(cloud.mask.device))
            above = cloud.with_mask(~res.inliers)
            coeffs = res.coefficients.cpu().numpy().astype(np.float64)
            coeffs = coeffs / max(np.linalg.norm(coeffs[:3]), 1e-12)
        off = cloud.xyz.cpu().numpy()[above.mask.cpu().numpy()]
        if len(off) and np.median(off @ coeffs[:3] + coeffs[3]) < 0:
            coeffs = -coeffs
        return above, coeffs

    def detect(self, cloud: Cloud, gen: Optional[torch.Generator] = None,
               rgb_image: Optional[np.ndarray] = None, samples=None) -> List[PersonCandidate]:
        """The people in ``cloud``, one :class:`PersonCandidate` each."""
        above, coeffs = self.ground(cloud, gen, samples)
        self.last_ground = coeffs
        n = coeffs[:3]
        xyz = cloud.xyz.cpu().numpy()
        labels, _ = euclidean_clusters(above, self.cluster_tolerance,
                                       min_cluster_size=self.min_points)
        lab = labels.cpu().numpy()
        out: List[PersonCandidate] = []
        for l in sorted(set(lab[lab >= 0].tolist())):
            pts = xyz[lab == l]
            subs = head_based_subclusters(pts, n, coeffs[3], self.min_height, self.max_height) \
                if self.subcluster else [np.ones(len(pts), bool)]
            for sub in subs:
                spts = pts[sub]
                if len(spts) < self.min_points:
                    continue
                d = spts @ n + coeffs[3]
                height = float(d.max())
                if not (self.min_height <= height <= self.max_height):
                    continue
                score = 1.0
                if self.classifier is not None and rgb_image is not None \
                        and self.intrinsics is not None:
                    score = self._hog_confidence(spts, d, rgb_image, n)
                    if score < self.min_confidence:
                        continue
                elif self.svm_model is not None:
                    from pcl_tpu_torch.ml import svm_classify
                    feat = torch.as_tensor(self._cluster_features(spts)[None, :],
                                           device=self.svm_model.w.device)
                    score = float(svm_classify(self.svm_model, feat)[0])
                    if score < 0:
                        continue
                out.append(PersonCandidate(centroid=spts.mean(axis=0), height=height,
                                           n_points=int(sub.sum()), score=score))
        return out

    def _hog_confidence(self, pts: np.ndarray, heights: np.ndarray,
                        rgb_image: np.ndarray, n: np.ndarray) -> float:
        """Project the cluster's top, bottom and centre through the
        intrinsics and evaluate the HOG and SVM window (PCL's PersonCluster
        getTTop/getTBottom: the centroid moved along the ground normal,
        ground_based_people_detection_app.hpp:403-409). ``n`` is the unit
        ground normal as ``detect`` oriented it."""
        K = np.asarray(self.intrinsics, np.float64)
        n = np.asarray(n, np.float64)
        center = pts.mean(0)
        h_c = float(heights.mean())
        ttop = center + (float(heights.max()) - h_c) * n
        tbottom = center - h_c * n
        p_top = K @ ttop
        p_top /= p_top[2]
        p_bot = K @ tbottom
        p_bot /= p_bot[2]
        p_c = K @ center
        p_c /= p_c[2]
        pixel_height = p_bot[1] - p_top[1]
        return self.classifier.evaluate(
            rgb_image, float(p_c[0]), float(p_c[1]), float(pixel_height))

    @staticmethod
    def _cluster_features(pts: np.ndarray) -> np.ndarray:
        """Simple geometric feature vector for the optional SVM stage."""
        mu = pts.mean(0)
        d = pts - mu
        cov = d.T @ d / max(len(pts), 1)
        lam = np.sort(np.linalg.eigvalsh(cov))[::-1]
        ext = pts.max(0) - pts.min(0)
        return np.concatenate([lam, ext, [len(pts)]]).astype(np.float32)
