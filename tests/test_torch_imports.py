"""The port stands alone: no module of pcl_tpu_torch, and not chip_smoke.py,
imports JAX or the JAX package, and every module imports on a machine without
a card, nvcc or triton; the constructors that pick a device ask for CUDA
unless told otherwise; chip_smoke.py refuses to run without a card."""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import ast
import importlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pcl_tpu_torch import fusion as tfusion
from pcl_tpu_torch import interop
from pcl_tpu_torch import parallel as tparallel
from pcl_tpu_torch.parallel import runtime as tparallel_runtime
from pcl_tpu_torch.core import cloud as tcloud
from pcl_tpu_torch.registration import graph as tgraph
from pcl_tpu_torch.registration import graph_optimizer as tgo
from pcl_tpu_torch import segmentation as tseg
from pcl_tpu_torch.octree.double_buffer import DoubleBufferedOctree
from pcl_tpu_torch.recognition import global_pipeline as tgp
from pcl_tpu_torch.recognition import ism as tism
from pcl_tpu_torch.recognition import linemod as tlm
from pcl_tpu_torch import keypoints as tkeypoints
from pcl_tpu_torch import ml as tml
from pcl_tpu_torch import tracking as ttracking
from pcl_tpu_torch.ml import permutohedral as tperm

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "pcl_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            yield from (a.value for a in node.args if isinstance(a, ast.Constant))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "pcl_tpu")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_pcl_tpu_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize(
    "name", [".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
             for p in PORT_FILES[:-1]])
def test_module_imports_without_a_card(name):
    """Kernels are built and triton imported inside the call that launches
    them, never when a module is imported."""
    assert importlib.import_module(name).__name__ == name


def test_new_modules_are_covered():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for must in ("io/pcd.py", "io/lzf.py", "io/ascii.py", "io/__init__.py", "ops/batch33.py",
                 "features/shot.py", "registration/gicp.py", "registration/ndt.py",
                 "utils/timing.py", "tools/odometry.py", "tools/voxel_grid.py",
                 "tools/normal_estimation.py", "tools/icp.py", "tools/ndt3d.py",
                 "search/hashgrid.py", "features/fpfh.py", "sac/__init__.py", "sac/models.py",
                 "sac/ransac.py", "segmentation/__init__.py",
                 "segmentation/sac_segmentation.py", "registration/rejection.py",
                 "registration/ia.py", "registration/validation.py", "io/ply.py",
                 "tools/fpfh_estimation.py", "tools/sac_segmentation.py",
                 "tools/sac_segmentation_plane.py", "registration/graph.py",
                 "registration/graph_optimizer.py", "features/integral_normals.py",
                 "filters/convolution.py", "fusion/__init__.py", "fusion/tsdf.py",
                 "fusion/kinfu.py", "fusion/world_model.py", "tools/lum.py", "tools/elch.py",
                 "registration/variants.py", "registration/incremental.py",
                 "registration/ndt2d.py", "registration/pyramid.py", "registration/fpcs.py",
                 "registration/ppf.py", "keypoints/__init__.py", "keypoints/iss.py",
                 "tools/compute_hausdorff.py", "tools/ndt2d.py", "tools/icp2d.py",
                 "tools/iterative_closest_point.py", "tools/compute_cloud_error.py",
                 "parallel/__init__.py", "parallel/mesh.py", "parallel/runtime.py",
                 "parallel/icp_sharded.py", "parallel/gicp_sharded.py",
                 "parallel/ndt_sharded.py", "parallel/graph_sharded.py",
                 "parallel/tsdf_sharded.py", "filters/passthrough.py", "filters/sampling.py",
                 "filters/outliers.py", "filters/crop_hull.py", "filters/morphological.py",
                 "filters/extras.py", "features/lrf.py", "features/shape_context.py",
                 "features/rops.py", "features/local_misc.py", "features/rsd.py",
                 "features/persistence.py", "keypoints/harris.py", "keypoints/susan.py",
                 "keypoints/sift.py", "segmentation/clustering.py",
                 "segmentation/region_growing.py", "features/global_desc.py",
                 "features/cvfh.py", "features/gasd.py", "features/intensity.py",
                 "features/color_features.py", "tools/vfh_estimation.py",
                 "tools/spin_estimation.py", "tools/boundary_estimation.py",
                 "surface/__init__.py", "surface/reconstruction.py", "surface/hulls.py",
                 "surface/mls.py", "surface/mls_upsampling.py", "surface/triangulation.py",
                 "surface/poisson.py", "surface/rbf.py", "surface/processing.py",
                 "surface/mesh_smoothing.py", "surface/bspline.py", "keypoints/smoothed.py",
                 "segmentation/organized.py", "segmentation/supervoxel.py",
                 "segmentation/advanced.py", "segmentation/graphcut.py", "ml/__init__.py",
                 "ml/kmeans.py", "tools/mls_smoothing.py", "tools/gp3_surface.py",
                 "tools/marching_cubes_reconstruction.py", "tools/poisson_reconstruction.py",
                 "tools/compute_hull.py", "tools/crop_to_hull.py", "core/casts.py",
                 "core/spring.py", "core/intersections.py", "core/range_image.py",
                 "octree/linear.py", "octree/ray.py", "octree/containers.py",
                 "octree/double_buffer.py", "octree/iterators.py", "features/narf.py",
                 "utils/logging.py", "utils/console.py", "utils/generate.py",
                 "tools/timed_trigger_test.py", "tools/voxel_grid_occlusion_estimation.py",
                 "tools/obj_rec_ransac_orr_octree_zprojection.py", "tools/generate.py",
                 "image/__init__.py", "image/ops.py", "ml/trees.py", "recognition/__init__.py",
                 "recognition/grouping.py", "recognition/verification.py", "recognition/orr.py",
                 "recognition/linemod.py", "recognition/linemod_io.py", "recognition/ism.py",
                 "recognition/face_detection.py", "recognition/global_pipeline.py",
                 "tools/linemod_detection.py", "tools/train_linemod_template.py",
                 "tools/match_linemod_template.py", "tools/obj_rec_ransac_accepted_hypotheses.py",
                 "tools/obj_rec_ransac_hash_table.py", "tools/obj_rec_ransac_model_opps.py",
                 "tools/obj_rec_ransac_result.py", "tools/obj_rec_ransac_scene_opps.py",
                 "ml/svm.py", "ml/svm_prob.py", "ml/svm_io.py", "ml/permutohedral.py",
                 "ml/densecrf.py", "people/__init__.py", "people/hog.py",
                 "people/classifier.py", "people/detector.py", "keypoints/corners2d.py",
                 "tracking/__init__.py", "tracking/particle_filter.py", "tracking/kld.py",
                 "tracking/klt.py", "tools/crf_segmentation.py", "io/grabber.py",
                 "io/velodyne.py", "io/tim.py", "io/buffers.py", "io/range_coder.py",
                 "io/compression.py", "io/organized_compression.py", "outofcore/__init__.py",
                 "outofcore/store.py", "outofcore/hierarchy.py", "visualization/__init__.py",
                 "visualization/export.py", "visualization/plotter.py",
                 "visualization/visualizer.py", "visualization/live.py",
                 "tools/hdl_grabber_example.py", "tools/hdl_viewer_simple.py",
                 "tools/vlp_viewer.py", "tools/pcap_to_pcd.py", "tools/image_grabber_saver.py",
                 "tools/image_grabber_viewer.py", "tools/image_viewer.py",
                 "tools/pcd_grabber_viewer.py", "tools/pcd_viewer.py", "tools/octree_viewer.py",
                 "tools/obj_rec_ransac_orr_octree.py", "tools/registration_visualizer.py",
                 "tools/concatenate_points_pcd.py", "tools/transform_point_cloud.py",
                 "tools/pclzf2pcd.py", "tools/plyheader.py", "tools/pcd_convert_NaN_nan.py",
                 "tools/ply2raw.py", "tools/convert_pcd_ascii_binary.py", "tools/converter.py",
                 "tools/pcd_change_viewpoint.py", "tools/transform_from_viewpoint.py",
                 "tools/pcd_introduce_nan.py", "tools/demean_cloud.py",
                 "tools/add_gaussian_noise.py", "tools/passthrough_filter.py",
                 "tools/uniform_sampling.py", "tools/radius_filter.py",
                 "tools/outlier_removal.py", "tools/grid_min.py", "tools/local_max.py",
                 "tools/morph.py", "tools/progressive_morphological_filter.py",
                 "tools/fast_bilateral_filter.py", "tools/bilateral_upsampling.py",
                 "tools/plane_projection.py", "tools/cluster_extraction.py",
                 "tools/extract_feature.py", "tools/train_unary_classifier.py",
                 "tools/unary_classifier_segment.py", "native/__init__.py", "version.py"):
        assert f"pcl_tpu_torch/{must}" in names


# the JAX package's Pallas drivers and the port's modules of their kernels
KERNEL_COUNTERPARTS = {"ops/pallas_nn.py": "ops/nn1.py", "ops/pallas_segsum.py": "ops/segsum.py"}


def test_every_jax_module_has_its_counterpart():
    """Every ``*.py`` of the JAX package, its tools included, has a file of
    the same path in the port, but the two Pallas drivers, whose
    counterparts are the kernels' own modules; so all 97 CLIs are ported."""
    jax_files = {str(p.relative_to(ROOT / "pcl_tpu")) for p in (ROOT / "pcl_tpu").rglob("*.py")}
    port_files = {str(p.relative_to(ROOT / "pcl_tpu_torch"))
                  for p in (ROOT / "pcl_tpu_torch").rglob("*.py")}
    missing = sorted(f for f in jax_files - port_files if f not in KERNEL_COUNTERPARTS)
    assert not missing, missing
    for jax_file, port_file in KERNEL_COUNTERPARTS.items():
        assert jax_file in jax_files and jax_file not in port_files and port_file in port_files
    tools = {f for f in jax_files if f.startswith("tools/") and f != "tools/__init__.py"}
    assert len(tools) == 97 and tools <= port_files


def test_registration_exports_the_jax_names():
    """``pcl_tpu_torch.registration`` exports what ``pcl_tpu.registration``
    exports, under the same names and in the same order."""
    jax_all = importlib.import_module("pcl_tpu.registration").__all__
    port = importlib.import_module("pcl_tpu_torch.registration")
    assert port.__all__ == jax_all
    assert all(hasattr(port, name) for name in jax_all)


@pytest.mark.parametrize("package", ["parallel", "filters"])
def test_package_exports_the_jax_names(package):
    """``pcl_tpu_torch.parallel`` and ``.filters`` export what the JAX
    package's do, in the same order; importing them creates no process
    group."""
    import torch.distributed as dist

    jax_all = importlib.import_module(f"pcl_tpu.{package}").__all__
    port = importlib.import_module(f"pcl_tpu_torch.{package}")
    assert port.__all__ == jax_all
    assert all(callable(getattr(port, name)) for name in jax_all)
    assert not dist.is_initialized()


def _jax_exports(package: str):
    """The names ``pcl_tpu.<package>/__init__.py`` imports, in order, and
    the module each comes from."""
    path = ROOT / "pcl_tpu" / package / "__init__.py"
    out = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            out += [(a.asname or a.name, node.module) for a in node.names]
    return out


# the JAX modules left for later, whose names the port's packages do not
# export yet: none since slice 14 (ROADMAP items 22a and 22b)
LEFT_FOR_LATER = {
    "features": (),
    "keypoints": (),
    "image": (),
    "ml": (),
}


@pytest.mark.parametrize("package", ["features", "keypoints", "image", "ml"])
def test_features_and_keypoints_export_the_jax_names(package):
    """``__all__`` is the JAX package's names, in order, less those of the
    modules left for later, which are listed here (none are left)."""
    names = _jax_exports(package)
    missing = [n for n, mod in names if mod in LEFT_FOR_LATER[package]]
    assert missing == []
    port = importlib.import_module(f"pcl_tpu_torch.{package}")
    assert port.__all__ == [n for n, mod in names if mod not in LEFT_FOR_LATER[package]]
    assert all(hasattr(port, n) for n in port.__all__)


@pytest.mark.parametrize("package", ["stereo", "simulation", "geometry"])
def test_image_side_exports_the_jax_names(package):
    """``stereo`` and ``simulation`` define no ``__all__`` in either package
    and import the same public names in the same order; ``geometry.__all__``
    is the JAX package's, in order."""
    jax_mod = importlib.import_module(f"pcl_tpu.{package}")
    port = importlib.import_module(f"pcl_tpu_torch.{package}")
    assert _port_imports(package) == [n for n, _ in _jax_exports(package)]
    public = lambda m: sorted(n for n in vars(m) if not n.startswith("_")  # noqa: E731
                              and not isinstance(getattr(m, n), type(m)))
    assert public(port) == public(jax_mod)
    if package == "geometry":
        assert port.__all__ == jax_mod.__all__
        assert all(hasattr(port, n) for n in port.__all__)
    else:
        assert not hasattr(port, "__all__") and not hasattr(jax_mod, "__all__")


def test_geometry_attribute_shadowing_is_the_jax_packages():
    """Both packages bind ``geometry`` to ``core.geometry`` (and list it in
    ``__all__``) until their ``geometry`` subpackage is imported, which
    rebinds the attribute to the subpackage (ROADMAP C87). A fresh
    interpreter, so that no other test's imports decide the order."""
    code = """
import importlib, json
out = {}
for pkg in ("pcl_tpu", "pcl_tpu_torch"):
    top = importlib.import_module(pkg)
    before = top.geometry.__name__
    from_before = getattr(__import__(pkg, fromlist=["geometry"]), "geometry").__name__
    sub = importlib.import_module(pkg + ".geometry")
    out[pkg] = [before, from_before, top.geometry.__name__, sub.__name__,
                "geometry" in top.__all__, hasattr(top.geometry, "build_halfedge_mesh")]
print(json.dumps(out))
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    import json
    got = json.loads(res.stdout.strip().splitlines()[-1])
    for pkg in ("pcl_tpu", "pcl_tpu_torch"):
        assert got[pkg] == [f"{pkg}.core.geometry", f"{pkg}.core.geometry", f"{pkg}.geometry",
                            f"{pkg}.geometry", True, True]


def _exports_all(package):
    port = importlib.import_module(f"pcl_tpu_torch.{package}")
    assert port.__all__ == [n for n, _ in _jax_exports(package)]
    assert all(callable(getattr(port, n)) for n in port.__all__)


@pytest.mark.parametrize("package", ["", ".core", ".utils"])
def test_package_level_names_are_the_jax_packages(package):
    """``pcl_tpu_torch``, ``.core`` and ``.utils`` export the JAX package's
    names, in its order, each bound to something (ROADMAP F4)."""
    jax_all = importlib.import_module(f"pcl_tpu{package}").__all__
    port = importlib.import_module(f"pcl_tpu_torch{package}")
    assert port.__all__ == jax_all
    assert all(hasattr(port, name) for name in jax_all)


def _port_imports(package: str):
    path = ROOT / "pcl_tpu_torch" / package / "__init__.py"
    return [a.asname or a.name for node in ast.parse(path.read_text()).body
            if isinstance(node, ast.ImportFrom) for a in node.names]


def test_octree_imports_the_jax_names_in_order():
    """``pcl_tpu_torch.octree`` imports every name ``pcl_tpu/octree/__init__.py``
    imports, in that order."""
    assert _port_imports("octree") == [n for n, _ in _jax_exports("octree")]
    port = importlib.import_module("pcl_tpu_torch.octree")
    assert all(hasattr(port, n) for n, _ in _jax_exports("octree"))


def test_segmentation_exports_the_ported_names():
    """Every module of ``segmentation/`` is ported: ``__all__`` is every name
    the JAX package's ``__init__`` imports, in its order."""
    _exports_all("segmentation")


def test_surface_exports_the_jax_names():
    _exports_all("surface")


@pytest.mark.parametrize("package", ["people", "tracking"])
def test_people_and_tracking_export_the_jax_names(package):
    """Every module of ``people/`` and ``tracking/`` is ported: ``__all__``
    is every name the JAX package's ``__init__`` imports, in its order; the
    trackers' samplers and cores are there too (C17)."""
    port = importlib.import_module(f"pcl_tpu_torch.{package}")
    assert port.__all__ == [n for n, _ in _jax_exports(package)]
    assert all(hasattr(port, n) for n in port.__all__)
    if package == "tracking":
        from pcl_tpu_torch.tracking import kld, particle_filter
        assert all(callable(f) for f in (particle_filter.draw_tracker_step,
                                         particle_filter.step_tracker_core,
                                         kld.draw_kld_step, kld.step_tracker_kld_core))


def test_recognition_exports_the_jax_names():
    """Every module of ``recognition/`` is ported: ``__all__`` is every name
    ``pcl_tpu/recognition/__init__.py`` imports, in its order; the modules'
    other public functions are there too."""
    _exports_all("recognition")
    from pcl_tpu_torch.recognition import face_detection, orr, verification
    assert callable(verification.global_hypothesis_verification)
    assert callable(verification.papazov_hypothesis_verification)
    assert all(callable(f) for f in (face_detection.FaceDetector,
                                     face_detection.train_face_detector,
                                     face_detection.detect_faces, orr._orr_hypotheses,
                                     orr._orr_support))


@pytest.mark.parametrize("package", ["outofcore", "visualization"])
def test_outofcore_and_visualization_export_the_jax_names(package):
    """``outofcore`` and ``visualization`` import every name the JAX
    package's ``__init__`` imports, in that order, and list them in
    ``__all__`` (the JAX package defines no ``__all__`` there)."""
    _exports_all(package)
    assert _port_imports(package) == [n for n, _ in _jax_exports(package)]
    jax_mod = importlib.import_module(f"pcl_tpu.{package}")
    assert not hasattr(jax_mod, "__all__")
    port = importlib.import_module(f"pcl_tpu_torch.{package}")
    for name in port.__all__:
        assert getattr(port, name).__name__ == getattr(jax_mod, name).__name__


def test_ml_exports_kmeans_as_a_sampler_and_a_core():
    """``ml`` exports ``kmeans`` first; its draw, and the RBF primal SVM's,
    is a sampler beside a core that takes the drawn indices (C17)."""
    ml = importlib.import_module("pcl_tpu_torch.ml")
    km = importlib.import_module("pcl_tpu_torch.ml.kmeans")
    svm = importlib.import_module("pcl_tpu_torch.ml.svm")
    assert ml.__all__[0] == "kmeans" and ml.kmeans is km.kmeans
    assert callable(km.kmeans_init_indices) and callable(km.kmeans_core)
    assert callable(svm.svm_basis_indices) and callable(svm.svm_train_core)


def test_scan_sees_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom pcl_tpu.core import cloud\n"
                 "import pcl_tpu_torch\nimport importlib\nimportlib.import_module('pcl_tpu.x')\n")
    assert [m for m in _imported_modules(f) if _forbidden(m)] == \
        ["jax.numpy", "pcl_tpu.core", "pcl_tpu.x"]


@pytest.mark.parametrize("make", [
    lambda: tcloud.make_cloud(np.zeros((4, 3), np.float32)),
    lambda: tcloud.from_numpy(np.zeros((4, 3), np.float32)),
    lambda: interop.cloud_from_arrays(np.zeros((4, 3), np.float32), np.ones(4, bool)),
    lambda: interop.hashgrid_from_arrays(0.5, 2, np.zeros((1, 3)), np.zeros(1), np.ones(1),
                                         np.zeros(4)),
    lambda: interop.tsdf_volume_from_arrays(np.ones((2, 2, 2)), np.zeros((2, 2, 2)),
                                            np.zeros(3), 0.1, 0.3),
    lambda: tfusion.make_volume(4, 1.0),
    lambda: tgraph.build_edges_from_correspondences([(0, 1, np.zeros((3, 3)), np.zeros((3, 3)))],
                                                    4),
    lambda: tgo.PoseGraph().optimize("elch", loop_transform=np.eye(4)),
    lambda: tparallel.make_mesh(),
    lambda: tparallel_runtime.initialize_multihost(init_method="file:///nonexistent",
                                                   num_processes=2, process_id=0),
    lambda: tseg.organized_connected_components(np.zeros((4, 4, 3)), np.ones((4, 4), bool)),
    lambda: tseg.organized_multi_plane_segmentation(np.zeros((4, 4, 3)), np.zeros((4, 4, 3)),
                                                    np.ones((4, 4), bool)),
    lambda: tseg.UnaryClassifier().train([np.zeros((4, 2))], clusters_per_class=1),
    lambda: interop.linear_octree_from_arrays(np.zeros(3), 0.1, 4, np.zeros(2), np.zeros(2),
                                              np.ones(2)),
    lambda: interop.range_image_from_arrays(np.zeros((2, 2)), 0.1, np.ones(2), np.eye(4), False),
    lambda: DoubleBufferedOctree(resolution=0.1).set_cloud(np.zeros((4, 3)), np.ones(4, bool)),
    lambda: tlm.build_modality_maps(np.zeros((4, 4, 3)), np.zeros((4, 4, 3)),
                                    np.ones((4, 4), bool)),
    lambda: tlm.detect_templates([np.zeros((4, 4, 8), bool)], []),
    lambda: tism.cluster_init_indices(4, 2),
    lambda: tgp.train_global_database({"a": np.ones((20, 3), np.float32)}),
    lambda: interop.svm_model_from_arrays("linear", np.ones(2), 0.0, np.zeros((0, 2)), 0.0,
                                          np.zeros(2), np.ones(2)),
    lambda: tml.DenseCRF(4, 2),
    lambda: tperm.PermutohedralFilter(np.zeros((4, 2), np.float32)),
    lambda: ttracking.init_tracker(8),
    lambda: ttracking.init_kld_tracker(8),
    lambda: ttracking.pyramidal_klt(np.zeros((8, 8)), np.zeros((8, 8)), np.zeros((1, 2))),
    lambda: tkeypoints.agast_keypoints(np.zeros((8, 8))),
], ids=["make_cloud", "from_numpy", "cloud_from_arrays", "hashgrid_from_arrays",
        "tsdf_volume_from_arrays", "make_volume", "build_edges_from_correspondences",
        "PoseGraph.optimize", "make_mesh", "initialize_multihost",
        "organized_connected_components", "organized_multi_plane_segmentation",
        "UnaryClassifier.train", "linear_octree_from_arrays", "range_image_from_arrays",
        "DoubleBufferedOctree.set_cloud", "build_modality_maps", "detect_templates",
        "cluster_init_indices", "train_global_database", "svm_model_from_arrays", "DenseCRF",
        "PermutohedralFilter", "init_tracker", "init_kld_tracker", "pyramidal_klt",
        "agast_keypoints"])
def test_default_device_is_cuda(monkeypatch, make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def test_stream_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """The grabbers, the compressed-cloud decoder and the out-of-core trees'
    queries place their clouds on CUDA unless told otherwise."""
    from pcl_tpu_torch.io import compression, grabber, tim, velodyne
    from pcl_tpu_torch.outofcore import HierarchicalOutofcoreOctree, OutofcoreOctree

    xyz = np.random.default_rng(0).uniform(0, 1, (50, 3)).astype(np.float32)
    blob = compression.compress_cloud(tcloud.from_numpy(xyz, device="cpu"), 0.1)
    pcap = str(tmp_path / "c.pcap")
    velodyne.write_pcap(pcap, [velodyne.encode_packet(np.arange(12.0), np.full((12, 32), 5.0),
                                                      np.zeros((12, 32)))])
    np.save(str(tmp_path / "d.npy"), np.ones((4, 5), np.float32))
    log = tmp_path / "tim.log"
    log.write_text("sRA LMDscandata " + "0 " * 23 + "2 A B")
    from pcl_tpu_torch.io import pcd
    pcd.save(str(tmp_path / "c.pcd"), tcloud.from_numpy(xyz, device="cpu"))
    store = OutofcoreOctree.create(str(tmp_path / "s"), 0.5, device="cpu")
    store.add_cloud(tcloud.from_numpy(xyz, device="cpu"))
    tree = HierarchicalOutofcoreOctree.create(str(tmp_path / "h"), (0, 0, 0), (1, 1, 1),
                                              device="cpu")
    tree.add_points(xyz)
    makers = [lambda: compression.decompress_cloud(blob),
              lambda: next(velodyne.PcapVelodyneGrabber(pcap).frames()),
              lambda: next(grabber.ImageGrabber(str(tmp_path), 40.0).frames()),
              lambda: next(grabber.PCDGrabber(str(tmp_path / "c.pcd")).frames()),
              lambda: next(tim.TimGrabber(str(log)).frames()),
              lambda: OutofcoreOctree(store.root).query_box((0, 0, 0), (1, 1, 1)),
              lambda: HierarchicalOutofcoreOctree(tree.root).query_bb_includes((0, 0, 0),
                                                                               (1, 1, 1))]
    on_cpu = [compression.decompress_cloud(blob, device="cpu"),
              next(velodyne.PcapVelodyneGrabber(pcap, device="cpu").frames()),
              next(tim.TimGrabber(str(log), device="cpu").frames()),
              store.query_box((0, 0, 0), (1, 1, 1)), tree.query_bb_includes((0, 0, 0), (1, 1, 1))]
    assert all(c.xyz.device.type == "cpu" and int(c.count) > 0 for c in on_cpu)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in makers:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_load_tsdf_defaults_to_cuda(monkeypatch, tmp_path):
    path = str(tmp_path / "v.npz")
    tfusion.save_tsdf(path, tfusion.make_volume(4, 1.0, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfusion.load_tsdf(path)
    assert tfusion.load_tsdf(path, device="cpu").tsdf.shape == (4, 4, 4)


def test_cuda_is_what_none_asks_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tcloud._device(None) == torch.device("cuda")
    assert tcloud._device("cpu") == torch.device("cpu")
    c = tcloud.make_cloud(np.ones((3, 3)), device="cpu")
    assert c.xyz.device.type == "cpu" and c.xyz.dtype == torch.float32


def _run_smoke(cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_refuses_without_card():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
