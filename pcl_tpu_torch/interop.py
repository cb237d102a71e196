"""State carried across from the JAX package.

Turns arrays that the JAX package produced, already converted to numpy by
the caller (``np.asarray(jax_array)``), into the port's objects, so that a
cloud, a cell table, a hash grid, an NDT grid, a TSDF volume, a KinFu
tracker's state, a linear octree, an occupancy grid, a range image, an
implicit shape model, a global-descriptor database, a random forest, a
LINEMOD template, an SVM, a permutohedral lattice, a person classifier or a
tracker's state built there can be used here. This module reads only
numpy arrays and plain values; it imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import Cloud, _device
from pcl_tpu_torch.core.range_image import RangeImage
from pcl_tpu_torch.fusion.kinfu import KinfuState
from pcl_tpu_torch.fusion.tsdf import TSDFVolume
from pcl_tpu_torch.ml.permutohedral import Lattice
from pcl_tpu_torch.ml.svm import SVMModel
from pcl_tpu_torch.ml.trees import DecisionTree, RandomForest
from pcl_tpu_torch.octree.containers import OccupancyGrid
from pcl_tpu_torch.octree.linear import LinearOctree
from pcl_tpu_torch.people.classifier import PersonClassifier
from pcl_tpu_torch.recognition.global_pipeline import GlobalModelDatabase
from pcl_tpu_torch.recognition.ism import ISMModel
from pcl_tpu_torch.recognition.linemod import LinemodTemplate
from pcl_tpu_torch.registration.ndt import NDTGrid
from pcl_tpu_torch.search.cell_list import CellTable
from pcl_tpu_torch.search.hashgrid import HashGrid
from pcl_tpu_torch.tracking.kld import KLDState
from pcl_tpu_torch.tracking.particle_filter import ParticleFilterState


def cloud_from_arrays(
    xyz: np.ndarray,
    mask: np.ndarray,
    attrs: Optional[Dict[str, np.ndarray]] = None,
    width: int = 0,
    height: int = 1,
    device=None,
) -> Cloud:
    """A Cloud with exactly these rows (padding and all), on ``device``
    (default CUDA)."""
    dev = _device(device)
    return Cloud(
        xyz=torch.tensor(np.asarray(xyz, np.float32), device=dev),
        mask=torch.tensor(np.asarray(mask, bool), device=dev),
        attrs={k: torch.tensor(np.asarray(v), device=dev)
               for k, v in (attrs or {}).items()},
        width=int(width),
        height=int(height),
    )


def cell_table_from_arrays(
    cell_size,
    table_size: int,
    cap: int,
    data: np.ndarray,
    count: np.ndarray,
    dims: Optional[Sequence[int]] = None,
    origin: Optional[np.ndarray] = None,
    device=None,
) -> CellTable:
    """A CellTable holding a table built elsewhere, queried as it is."""
    dev = _device(device)
    data = np.asarray(data, np.float32)
    if data.shape != (table_size + 1, cap * 4):
        raise ValueError(f"cell table data {data.shape} does not match "
                         f"table_size={table_size}, cap={cap}")
    return CellTable(
        cell_size=torch.tensor(np.float32(cell_size), device=dev),
        table_size=int(table_size),
        cap=int(cap),
        data=torch.tensor(data, device=dev),
        count=torch.tensor(np.asarray(count, np.int32), device=dev),
        dims=None if dims is None else tuple(int(d) for d in dims),
        origin=None if origin is None else torch.tensor(
            np.asarray(origin, np.float32), device=dev),
    )


def ndt_grid_from_arrays(
    resolution,
    table_size: int,
    mean: np.ndarray,
    icov: np.ndarray,
    valid: np.ndarray,
    ckey1: np.ndarray,
    ckey2: np.ndarray,
    device=None,
) -> NDTGrid:
    """An NDTGrid holding voxel Gaussians built elsewhere, scored as they
    are. The JAX package's ``packed`` rows repeat these arrays in a TPU
    layout and are not needed."""
    dev = _device(device)
    mean = np.asarray(mean, np.float32)
    if mean.shape != (table_size + 1, 3):
        raise ValueError(f"NDT grid mean {mean.shape} does not match "
                         f"table_size={table_size}")
    return NDTGrid(
        resolution=torch.tensor(np.float32(resolution), device=dev),
        table_size=int(table_size),
        mean=torch.tensor(mean, device=dev),
        icov=torch.tensor(np.asarray(icov, np.float32), device=dev),
        valid=torch.tensor(np.asarray(valid, bool), device=dev),
        ckey1=torch.tensor(np.asarray(ckey1, np.int32), device=dev),
        ckey2=torch.tensor(np.asarray(ckey2, np.int32), device=dev),
    )


def hashgrid_from_arrays(
    cell_size,
    table_size: int,
    sorted_xyz: np.ndarray,
    sorted_idx: np.ndarray,
    sorted_mask: np.ndarray,
    bucket_start: np.ndarray,
    device=None,
) -> HashGrid:
    """A HashGrid holding a CSR index built elsewhere, queried as it is."""
    dev = _device(device)
    bucket_start = np.asarray(bucket_start, np.int32)
    if bucket_start.shape != (table_size + 2,):
        raise ValueError(f"hash grid bucket_start {bucket_start.shape} does not match "
                         f"table_size={table_size}")
    return HashGrid(
        cell_size=torch.tensor(np.float32(cell_size), device=dev),
        table_size=int(table_size),
        sorted_xyz=torch.tensor(np.asarray(sorted_xyz, np.float32), device=dev),
        sorted_idx=torch.tensor(np.asarray(sorted_idx, np.int32), device=dev),
        sorted_mask=torch.tensor(np.asarray(sorted_mask, bool), device=dev),
        bucket_start=torch.tensor(bucket_start, device=dev),
    )


def tsdf_volume_from_arrays(
    tsdf: np.ndarray,
    weight: np.ndarray,
    origin: np.ndarray,
    voxel_size,
    trunc,
    device=None,
) -> TSDFVolume:
    """A TSDFVolume holding a volume fused elsewhere."""
    dev = _device(device)
    tsdf = np.asarray(tsdf, np.float32)
    if tsdf.ndim != 3 or len(set(tsdf.shape)) != 1 or np.shape(weight) != tsdf.shape:
        raise ValueError(f"TSDF volume {tsdf.shape} / weight {np.shape(weight)} are not "
                         "one [R, R, R] shape")
    return TSDFVolume(
        tsdf=torch.tensor(tsdf, device=dev),
        weight=torch.tensor(np.asarray(weight, np.float32), device=dev),
        origin=torch.tensor(np.asarray(origin, np.float32), device=dev),
        voxel_size=torch.tensor(np.float32(voxel_size), device=dev),
        trunc=torch.tensor(np.float32(trunc), device=dev),
    )


def kinfu_state_from_arrays(
    volume: TSDFVolume,
    pose: np.ndarray,
    prev_verts: np.ndarray,
    prev_normals: np.ndarray,
    prev_hit: np.ndarray,
    frame,
    lost,
    device=None,
) -> KinfuState:
    """A KinfuState that goes on tracking from a state reached elsewhere;
    ``volume`` comes from ``tsdf_volume_from_arrays``."""
    dev = _device(device)
    return KinfuState(
        volume=volume,
        pose=torch.tensor(np.asarray(pose, np.float32), device=dev),
        prev_verts=torch.tensor(np.asarray(prev_verts, np.float32), device=dev),
        prev_normals=torch.tensor(np.asarray(prev_normals, np.float32), device=dev),
        prev_hit=torch.tensor(np.asarray(prev_hit, bool), device=dev),
        frame=torch.tensor(int(frame), dtype=torch.int32, device=dev),
        lost=torch.tensor(bool(lost), device=dev),
    )


def linear_octree_from_arrays(
    origin: np.ndarray,
    resolution,
    depth: int,
    keys: np.ndarray,
    order: np.ndarray,
    mask: np.ndarray,
    device=None,
) -> LinearOctree:
    """A LinearOctree holding sorted keys built elsewhere, queried as it is."""
    dev = _device(device)
    keys = np.asarray(keys, np.int32)
    if np.shape(order) != keys.shape or np.shape(mask) != keys.shape:
        raise ValueError(f"octree keys {keys.shape}, order {np.shape(order)} and mask "
                         f"{np.shape(mask)} are not one [N] shape")
    return LinearOctree(
        origin=torch.tensor(np.asarray(origin, np.float32), device=dev),
        resolution=torch.tensor(np.float32(resolution), device=dev),
        depth=int(depth),
        keys=torch.tensor(keys, device=dev),
        order=torch.tensor(np.asarray(order, np.int32), device=dev),
        mask=torch.tensor(np.asarray(mask, bool), device=dev),
    )


def occupancy_grid_from_arrays(
    keys: np.ndarray,
    n_occupied,
    origin: np.ndarray,
    resolution,
    depth: int,
    device=None,
) -> OccupancyGrid:
    """An OccupancyGrid holding a sorted key set built elsewhere."""
    dev = _device(device)
    return OccupancyGrid(
        keys=torch.tensor(np.asarray(keys, np.int32), device=dev),
        n_occupied=torch.tensor(int(n_occupied), dtype=torch.int32, device=dev),
        origin=torch.tensor(np.asarray(origin, np.float32), device=dev),
        resolution=torch.tensor(np.float32(resolution), device=dev),
        depth=int(depth),
    )


def range_image_from_arrays(
    ranges: np.ndarray,
    angular_res,
    center: np.ndarray,
    sensor_pose: np.ndarray,
    planar: bool,
    device=None,
) -> RangeImage:
    """A RangeImage holding ranges projected elsewhere."""
    dev = _device(device)
    ranges = np.asarray(ranges, np.float32)
    if ranges.ndim != 2:
        raise ValueError(f"range image {ranges.shape} is not [H, W]")
    return RangeImage(
        ranges=torch.tensor(ranges, device=dev),
        angular_res=torch.tensor(np.float32(angular_res), device=dev),
        center=torch.tensor(np.asarray(center, np.float32), device=dev),
        sensor_pose=torch.tensor(np.asarray(sensor_pose, np.float32), device=dev),
        planar=bool(planar),
    )


def ism_model_from_arrays(statistical_weights, learned_weights, classes, sigmas,
                          directions_to_center, clusters_centers, clusters) -> ISMModel:
    """An implicit shape model trained elsewhere (host arrays, as the port
    keeps them)."""
    sw = np.asarray(statistical_weights, np.float32)
    centers = np.asarray(clusters_centers, np.float32)
    lw = np.asarray(learned_weights, np.float32)
    return ISMModel(sw, lw, np.asarray(classes, np.int32), np.asarray(sigmas, np.float32),
                    np.asarray(directions_to_center, np.float32), centers,
                    [[int(m) for m in c] for c in clusters], int(sw.shape[0]), int(len(lw)),
                    int(centers.shape[0]), int(centers.shape[1]))


def global_database_from_arrays(descriptor: str, labels: Sequence[str], descs: np.ndarray,
                                views: Sequence[np.ndarray],
                                poses: Sequence[np.ndarray]) -> GlobalModelDatabase:
    """A global-descriptor database trained elsewhere."""
    return GlobalModelDatabase(descriptor=str(descriptor), labels=[str(v) for v in labels],
                               descs=np.asarray(descs), views=[np.asarray(v) for v in views],
                               poses=[np.asarray(p) for p in poses])


def forest_from_arrays(trees: Sequence[tuple]) -> RandomForest:
    """A random forest trained elsewhere, from each tree's ``(feature,
    threshold, leaf_probs, depth)``."""
    return RandomForest([DecisionTree(np.asarray(f), np.asarray(t), np.asarray(p), int(d))
                         for f, t, p, d in trees])


def linemod_template_from_arrays(offsets, bins, modality, height: int,
                                 width: int) -> LinemodTemplate:
    """A LINEMOD template extracted elsewhere."""
    return LinemodTemplate(np.asarray(offsets, np.int32), np.asarray(bins, np.int32),
                           np.asarray(modality, np.int32), int(height), int(width))


def svm_model_from_arrays(kernel: str, w, b, support, gamma, mean, scale,
                          device=None) -> SVMModel:
    """An SVM trained elsewhere, on ``device`` (default CUDA). ``kernel`` is
    "linear" or "rbf" (the JAX package's dual trainer stores 0: pass the
    kernel it was trained with)."""
    dev = _device(device)

    def t(v):
        return torch.tensor(np.asarray(v, np.float32), device=dev)

    return SVMModel(kernel=str(kernel), w=t(w), b=t(b), support=t(support), gamma=t(gamma),
                    mean=t(mean), scale=t(scale))


def lattice_from_arrays(offsets, barycentric, blur_n1, blur_n2, m: int, d: int) -> Lattice:
    """A permutohedral lattice built elsewhere (host arrays, as the port
    keeps them)."""
    return Lattice(np.asarray(offsets, np.int32), np.asarray(barycentric, np.float32),
                   np.asarray(blur_n1, np.int32), np.asarray(blur_n2, np.int32), int(m), int(d))


def person_classifier_from_arrays(window_height: int, window_width: int, b: float,
                                  weights) -> PersonClassifier:
    """A HOG and linear-SVM person classifier trained elsewhere."""
    return PersonClassifier({"window_height": int(window_height),
                             "window_width": int(window_width), "b": float(b),
                             "weights": np.asarray(weights, np.float32)})


def tracker_state_from_arrays(particles, weights, ref_pose, device=None) -> ParticleFilterState:
    """A particle filter's state (its key stays behind: the port's steps
    take their draws, ROADMAP C17)."""
    dev = _device(device)
    return ParticleFilterState(
        particles=torch.tensor(np.asarray(particles, np.float32), device=dev),
        weights=torch.tensor(np.asarray(weights, np.float32), device=dev),
        ref_pose=torch.tensor(np.asarray(ref_pose, np.float32), device=dev))


def kld_state_from_arrays(particles, active, ref_pose, device=None) -> KLDState:
    """A KLD-adaptive particle filter's state (without its key)."""
    dev = _device(device)
    return KLDState(particles=torch.tensor(np.asarray(particles, np.float32), device=dev),
                    active=torch.tensor(np.asarray(active, bool), device=dev),
                    ref_pose=torch.tensor(np.asarray(ref_pose, np.float32), device=dev))
