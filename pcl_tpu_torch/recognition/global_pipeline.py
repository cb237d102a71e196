"""The global recognition pipeline (PCL's apps/3d_rec_framework:
global_nn_classifier.h, global_nn_recognizer_cvfh.h, the training tool
global_classification.cpp).

Counterpart of ``pcl_tpu/recognition/global_pipeline.py``: a database of
per-view global descriptors (VFH or ESF) of rendered views of each model;
scene clusters are recognised by the descriptor's nearest views (chi^2),
centroid pre-alignment and ICP, the best fitness kept. Views are rendered
with numpy from the same seeds as in the reference; VFH is deterministic and
ESF draws its triples from a ``torch.Generator`` (its core takes given
triples, ROADMAP C50). The candidates are ranked with numpy's own
``argsort`` on the host, so ties go as in the reference. The database's file
layout is the reference's.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import Cloud, from_numpy


def _descriptor(cloud: Cloud, kind: str, gen: Optional[torch.Generator] = None,
                tri: Optional[torch.Tensor] = None) -> np.ndarray:
    """VFH (normals at k = 16) or ESF (from ``gen``'s draws, or the triples
    ``tri``) of a cloud, as a host array."""
    from pcl_tpu_torch import features
    from pcl_tpu_torch.features import global_desc
    if kind == "vfh":
        c = features.estimate_normals(cloud, k=16)
        return features.estimate_vfh(c).cpu().numpy()
    if kind == "esf":
        if tri is not None:
            return global_desc.estimate_esf_core(cloud, tri).cpu().numpy()
        return features.estimate_esf(cloud, gen).cpu().numpy()
    raise ValueError(f"unknown global descriptor {kind!r} (vfh/esf)")


def render_views(xyz: np.ndarray, n_views: int = 8, max_points: int = 4096,
                 seed: int = 0) -> List[dict]:
    """Partial views of a model from a ring of viewpoints: per azimuth the
    half of the model facing the camera, subsampled to ``max_points`` with
    numpy's ``default_rng(seed)``, in the view's frame. Returns ``[{"xyz",
    "pose"}]``, ``pose`` mapping the view to the model's frame."""
    rng = np.random.default_rng(seed)
    ctr = xyz.mean(0)
    out = []
    for v in range(n_views):
        az = 2 * np.pi * v / n_views
        dirv = np.array([np.cos(az), np.sin(az), 0.3], np.float64)
        dirv /= np.linalg.norm(dirv)
        rad = xyz - ctr
        vis = rad @ dirv > -0.1 * np.linalg.norm(rad, axis=1)
        pts = xyz[vis]
        if len(pts) > max_points:
            pts = pts[rng.choice(len(pts), max_points, replace=False)]
        z = -dirv
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= max(np.linalg.norm(x), 1e-9)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        eye = ctr + 2.5 * dirv * max(np.linalg.norm(rad, axis=1).max(), 1e-6)
        local = (pts - eye) @ R.T
        pose = np.eye(4)
        pose[:3, :3] = R.T
        pose[:3, 3] = eye
        out.append({"xyz": local.astype(np.float32), "pose": pose})
    return out


@dataclass
class GlobalModelDatabase:
    """The trained per-view descriptors, view clouds and poses."""
    descriptor: str                                   # 'vfh' | 'esf'
    labels: List[str] = field(default_factory=list)   # per view
    descs: Optional[np.ndarray] = None                # [V, D]
    views: List[np.ndarray] = field(default_factory=list)
    poses: List[np.ndarray] = field(default_factory=list)

    def save(self, root: str) -> None:
        os.makedirs(root, exist_ok=True)
        np.save(os.path.join(root, "descs.npy"), self.descs)
        for i, (v, p) in enumerate(zip(self.views, self.poses)):
            np.save(os.path.join(root, f"view_{i:04d}.npy"), v)
            np.save(os.path.join(root, f"pose_{i:04d}.npy"), p)
        with open(os.path.join(root, "meta.json"), "w") as f:
            json.dump({"descriptor": self.descriptor, "labels": self.labels}, f)

    @classmethod
    def load(cls, root: str) -> "GlobalModelDatabase":
        with open(os.path.join(root, "meta.json")) as f:
            meta = json.load(f)
        db = cls(descriptor=meta["descriptor"], labels=meta["labels"])
        db.descs = np.load(os.path.join(root, "descs.npy"))
        db.views = [np.load(os.path.join(root, f"view_{i:04d}.npy"))
                    for i in range(len(db.labels))]
        db.poses = [np.load(os.path.join(root, f"pose_{i:04d}.npy"))
                    for i in range(len(db.labels))]
        return db


def train_global_database(models: Dict[str, np.ndarray], descriptor: str = "vfh",
                          n_views: int = 8, seed: int = 0, device=None,
                          gen: Optional[torch.Generator] = None) -> GlobalModelDatabase:
    """Render views of every model and take their global descriptors on
    ``device`` (default CUDA)."""
    db = GlobalModelDatabase(descriptor=descriptor)
    descs = []
    for name, xyz in models.items():
        for view in render_views(np.asarray(xyz, np.float32), n_views=n_views, seed=seed):
            c = from_numpy(view["xyz"], device=device)
            descs.append(_descriptor(c, descriptor, gen).reshape(-1))
            db.labels.append(name)
            db.views.append(view["xyz"])
            db.poses.append(view["pose"])
    db.descs = np.stack(descs)
    return db


@dataclass(frozen=True)
class GlobalRecognition:
    label: str
    view_index: int
    distance: float          # the descriptor's chi^2 distance
    transform: np.ndarray    # [4, 4] the matched view onto the cluster, after ICP
    fitness: float           # ICP's mean squared correspondence distance


def _chi2(a: np.ndarray, B: np.ndarray) -> np.ndarray:
    num = (a[None, :] - B) ** 2
    den = a[None, :] + B + 1e-12
    return 0.5 * (num / den).sum(axis=1)


def recognize_clusters(db: GlobalModelDatabase, clusters: List[np.ndarray],
                       n_candidates: int = 3, refine_iterations: int = 30,
                       max_corr_frac: float = 0.5, device=None,
                       gen: Optional[torch.Generator] = None
                       ) -> List[Optional[GlobalRecognition]]:
    """Label and pose every scene cluster: the descriptor's nearest
    ``n_candidates`` views, each pre-aligned by the centroids and refined
    by ICP on ``device`` (default CUDA), the best fitness kept."""
    from pcl_tpu_torch.registration.icp import icp

    out: List[Optional[GlobalRecognition]] = []
    for pts in clusters:
        pts = np.asarray(pts, np.float32)
        if len(pts) < 10:
            out.append(None)
            continue
        target = from_numpy(pts, device=device)
        d = _descriptor(target, db.descriptor, gen).reshape(-1)
        dist = _chi2(d, db.descs)
        cand = np.argsort(dist)[:n_candidates]
        best: Optional[GlobalRecognition] = None
        diam = float(np.linalg.norm(pts.max(0) - pts.min(0)))
        for vi in cand:
            view = db.views[int(vi)]
            pre = np.eye(4, dtype=np.float32)
            pre[:3, 3] = pts.mean(0) - view.mean(0)
            res = icp(from_numpy(view, device=device), target,
                      init_transform=torch.as_tensor(pre, device=target.xyz.device),
                      max_corr_dist=max_corr_frac * diam, max_iterations=refine_iterations)
            fit = float(res.fitness)
            if best is None or fit < best.fitness:
                best = GlobalRecognition(label=db.labels[int(vi)], view_index=int(vi),
                                         distance=float(dist[vi]),
                                         transform=res.transform.cpu().numpy(), fitness=fit)
        out.append(best)
    return out


def segment_scene_clusters(scene: Cloud, plane_threshold: float = 0.02,
                           cluster_tolerance: float = 0.05, min_cluster_size: int = 50,
                           max_clusters: int = 8, gen: Optional[torch.Generator] = None,
                           samples: Optional[torch.Tensor] = None) -> List[np.ndarray]:
    """The pipeline's scene preprocessing: the dominant plane removed
    (RANSAC's 1,024 hypotheses from ``samples [1024, 3]``, or drawn from
    ``gen``), Euclidean clusters of the rest, the largest ``max_clusters``
    as host arrays."""
    from pcl_tpu_torch import sac
    from pcl_tpu_torch.sac.ransac import ransac_core
    from pcl_tpu_torch.segmentation import euclidean_clusters, sac_segmentation

    if samples is None:
        res = sac_segmentation(scene, sac.PlaneModel(), plane_threshold, gen=gen)
    else:
        res = ransac_core(sac.PlaneModel(), scene.xyz, scene.mask, plane_threshold,
                          samples.to(scene.xyz.device))
    above = scene.with_mask(scene.mask & ~res.inliers)
    labels, _ = euclidean_clusters(above, cluster_tolerance, min_cluster_size=min_cluster_size)
    lab = labels.cpu().numpy()
    xyz = scene.xyz.cpu().numpy()
    sizes = [(v, int((lab == v).sum())) for v in sorted(set(lab[lab >= 0].tolist()))]
    sizes.sort(key=lambda kv: -kv[1])
    return [xyz[lab == v] for v, _n in sizes[:max_clusters]]
