#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pcl_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pcl_tpu_torch/csrc`` and then:

1. holds each kernel against its plain PyTorch version on the card, at
   ragged shapes, with masked targets, with no valid target, with exact ties
   (also across sub-tiles, tiles and target slices, and at the origin) and at
   the main path's shape (120k x 120k); 2048 x 120k, the shape of a
   downsampled source against a dense map, is checked and timed as well;
2. path A, the kernel path: point-to-point ICP with an infinite gate (the
   brute backend: one 120k x 120k 1-NN sweep per iteration) on a 120k-point
   pair moved by a known motion, then ``fitness_score``; checks the launch
   count, the recovered motion, and the same ICP with the plain 1-NN;
3. path B, the cell backend: ICP with a 1 m gate on a prebuilt dense grid
   (cap 8, 53^3 cells), 20 iterations with every epsilon 0;
4. kernel B2 (segmented sums) against its plain version: ragged N, one
   segment of all rows, every row its own segment, no valid row, N = 0,
   W = 1, 7 and 131, tails of N and 2^28, runs of ~500 rows, runs of one
   row less, as many and one more than a thread adds alone, gaps between the
   ids, the voxel grid's own input from
   scan 0, the NDT grid's own input from scan 0 (120,000 x 13, runs of
   hundreds of rows; timed as well), and a cloud whose bounding box holds
   more than 2^30 cells
   (the three-key sort), whose voxel_downsample on the card must launch the
   kernel once and match the CPU run; two launches must be bitwise equal;
   kernel, plain and torch.segment_reduce times beside the bound and beside
   an empty kernel launched the same way;
5. path C, the odometry front end at KITTI scan size: six 120k-point scans
   of a synthetic street, each through voxel_downsample (B2), estimate_normals
   (k = 16, host probe, cell list) and point-to-plane odometry_sequence;
   checks B2's launch count, convergence, truncation, the trajectory error,
   scan 0 against the port's CPU run, and the same chain with the plain
   segment sum;
6. path D, the odometry command-line flow with the other two aligners: the
   six scans written as binary_compressed PCD files and read back bit for
   bit, ``tools.voxel_grid`` on each file (B2), GICP ``odometry_sequence``
   over the downsampled files with the cell-list arguments ``tools.odometry``
   gives it (hash cell lists, cells and caps from the host probe), NDT of each
   downsampled scan against the raw scan before it from an odometry prior
   (``build_grid`` launches B2 once per grid), NDT from the identity on four
   scans of a street with alleys (a scene where NDT sees every axis),
   ``tools.odometry`` itself, which must repeat the GICP poses, GICP with an
   infinite gate on 8,192 points of the noisy pair moved further (the brute
   branch: B1 once per iteration, several iterations), GICP and NDT on the
   card against the port's CPU run on a 20,000-point pair, and a device
   breakdown of one GICP and one NDT pair;
7. path E, feature-based global registration: two scans of the street 10 m
   apart and turned 20 deg, written as binary PLY files and read back bit for
   bit; per scan the ground plane by RANSAC (held against y = -1.7 m) and
   removed, voxel_downsample at 0.3 m (B2), estimate_normals and FPFH; three
   global aligners on the voxels of high curvature, prerejective RANSAC and
   SAC-IA (each scoring all hypotheses in one B1 sweep) and a rejector chain
   (feature 1-NN, one-to-one, sample consensus, closed form), each refined by
   point-to-point ICP and held against the known motion; validate_euclidean
   of the refined pose and of the identity; hash-grid FPFH against brute
   FPFH; B1 timed at the sweep's shape; (a) again with the plain 1-NN; the
   prerejective core on the card against the CPU run on the same samples;
8. path F, pose-graph alignment: 16 street scans along a closed route (out
   and back in the other lane), each through voxel_downsample (B2) and moved
   into the world by odometry poses that drift; LUM in tools.lum's flow
   (edges between consecutive scans and scans whose centroids are close,
   B1 1-NN correspondences, a dense solve) over rounds of a shrinking gate,
   held against the golden poses; the first round's graph with CG; ELCH
   after ICP of the loop's end onto its start; tools.lum itself on PCD files,
   which must repeat the first round; dense and CG LUM on a graph of KITTI
   sequence 00's length (4,541 poses), timed, with peak memory; a small
   graph on the card against the CPU run;
9. path G, KinFu mapping at PCL KinFu's defaults: 40 VGA depth frames of a
   synthetic room seen by a handheld camera, tracked and fused into a 512^3
   volume over 3 m (no frame lost, the trajectory error, surface points
   against the room, the last raycast's coverage), one frame's time by stage
   and its device breakdown, peak memory, save_tsdf/load_tsdf and a world
   model slab bit for bit, three small frames on the card against the CPU,
   and integral-image normals of the last frame (both modes: card against
   CPU at 60 x 80, the error against the true normals at 480 x 640, time);
10. path H, the rest of registration on path E's pair and path C's scans:
   (a) FPCS, (b) K-FPCS on ISS keypoints, (c) batched 4PCS, (d) 4PCS with the
   full pair table on the ISS keypoints, (e) PPF voting, each scored by one
   B1 sweep (4PCS's congruent sets matched by B1 too) and refined by
   point-to-plane ICP; (f) nonlinear ICP from the best global result; (g)
   joint ICP of path C's pair split into two scanners; (h) incremental
   registration over path C's scans, bitwise as odometry_sequence's pairs,
   and meta registration; (i) 2-D NDT of a planar laser on the street with
   alleys, tools.ndt2d and tools.icp2d; (j) tools.compute_hausdorff on the
   raw scans (two 120k x 120k B1 sweeps), equal with B1's plain version; (k)
   the pyramid match of the scans' FPFH; B1 against its plain version at
   (a)'s shape, timed; the aligners on the card against the CPU on
   2,048-voxel subclouds with the same draws;
11. path I, the sharded functions (parallel/) at full width: (a) one rank
   under NCCL in this process runs sharded ICP on path A's pair (brute, B1)
   and on path C's pair (point-to-plane, cell list), sharded GICP on path D's
   downsampled pair (B1), sharded NDT on path D's pair from its prior (B2
   once, the grid), sharded LUM on path F's KITTI-size graph and sharded
   TSDF integrate, raycast and shift over path G's 512^3 volume and first
   frames, each against its path's limit and the single-device function;
   (b) I_RANKS ranks sharing the card under gloo (processes of this script)
   run the same calls and are held to (a): poses within I_POSE_TOL, TSDF
   slabs and the evicted slab bitwise, raycast hits equal; ms per iteration
   or frame, collectives, bytes and launches per rank printed;
12. path J, the filter front end on path C's six scans: crop box, statistical
   and radius outlier removal, progressive morphological ground removal,
   then voxel_downsample (B2), normals and odometry; scan 0's masks against
   the CPU run and its ground against the street's; approximate_voxel_grid,
   farthest-point sampling and grid_minimum timed;
13. path K, descriptors, keypoints and clusters on path E's pair with an
   intensity and an RGB made from each point's place in the street: (a)
   Harris 3-D, SUSAN and ISS keypoints of the voxels and SIFT on the raw
   scan's intensity (B2 once an octave, B1 once to snap); (b) SHOT at every
   voxel, and at the keypoints SHOT with the voxels as surface, SHOT colour,
   USC, 3DSC, RoPS, spin images, BOARD and FLARE frames, RSD, principal
   curvatures, intensity gradient, RIFT and intensity spin images, PFHRGB
   and CPPF; on the voxels boundary points, difference of normals, moment
   invariants and FPFH persistence at three scales, each timed with its peak
   memory; (c) SHOT and FPFH matches of the keypoints (the share within two
   voxels of the true counterpart) and prerejective RANSAC on the SHOT
   matches, refined by point-to-plane ICP; (d) Euclidean clusters of the
   voxels and per cluster VFH, CVFH, OUR-CVFH, CRH, ESF, GASD, GASD colour
   and GRSD, and crh_align of one car seen in both scans; (e) SHOT, USC and
   RoPS of scan 1 moved by a seeded rigid motion against the unmoved; (f)
   every function of the slice on the card against the CPU on 2,048-voxel
   subclouds; (g) B1 and B2 against their plain versions on every call
   (a)-(d) made: SIFT's snaps, the prerejective sweep at its full shape
   (the plain version on its first K_PLAIN_ROWS queries), each cluster's
   ESF midpoints, the voxel grids and SIFT's octaves;
14. path L, surface reconstruction and the rest of segmentation on path G's
   room, frame 0 at VGA with an RGB per surface: (a) organized multi-plane
   segmentation at PCL's demo settings on k-NN normals, organized connected
   components and the organized fast mesh; (b) PCL's polygonal-prism
   tabletop flow on the floor (convex and concave hulls, the prism,
   Euclidean clusters: one per object); (c) on the 1 cm voxels (B2) MLS,
   smoothed-surface keypoints, greedy projection triangulation, Hoppe at 128^3
   (B1), Poisson at depth 8, RBF on the box, mesh smoothing, B-splines on the
   back wall, the MLS upsampling modes, grid projection (B1), surfel
   smoothing, bilateral upsampling and texture mapping; (d) supervoxels,
   LCCP, CPC, min-cut, GrabCut, seeded hue, the random walker and the unary
   classifier on FPFH; (e) the planes, clusters, meshes and segmentations
   against the room, and the functions on the card against the CPU on 2,048
   voxels and an 80 x 60 frame; (f) every B1 and B2 call of the path against
   its plain version at its own shape;
15. path M, PCL's octree, range-image and NARF tutorials on path C's six
   scans, each moved into scan 0's frame (one shared tree origin, 0.2 m
   leaves, depth 10): (a) build, (b) change detection between consecutive
   scans and a double-buffered octree over the six, (c) voxel, box and
   occupancy queries, (d) leaf centroids (B2) and every level, (e)
   adjacency and the occupancy grid, (f) rays from the sensor to a
   subsample, (g) approximate 1-NN of the next scan against B1's exact
   1-NN, (h) the iterators, each held to numpy on the same keys; (i)
   spherical range images of each scan in its own frame (720 x 360 at
   0.5 deg) held to a float64 z-buffer, ``to_cloud``, and a planar image of
   path G's VGA frame; (j) NARF borders, keypoints and descriptors; the
   chain on the card against the CPU on 8,192 points of two scans; B1 and
   B2 held to their plain versions at the path's shapes;
16. path N, PCL's recognition tutorials on path L's room (frame 0 at VGA, its
   1 cm voxels by B2; the box, sphere and cylinder as models, each the pixels
   of its part in a render from path G's start turned 25 deg about it): (a)
   SHOT correspondences, geometric consistency and Hough 3-D grouping, each
   refined by SAC, for the box and the cylinder; (b) greedy, global and
   Papazov verification of the box's instances (refined by trimmed ICP),
   ObjRecRANSAC's result and three wrong poses; (c) ObjRecRANSAC of the box
   and its pair-feature hash table; (d) LINEMOD from frame 0's box region,
   detected in path G's frame 20, the box mask's distance map and erosion;
   (e) the global pipeline (VFH and ESF databases of 8 views of each object's
   whole surface, plane removal and clusters, recognition with ICP); (f) ISM
   on the three models with FPFH, votes for the box; (g) a depth-patch forest
   trained on frame 0, run on frame 20; the checks at 1.5 x the JAX package's
   CPU rehearsal; the chain on the card against the CPU at 80 x 60 and on
   2,048 voxels about the box; every B1 and B2 call held to its plain version;
17. path O, PCL's people-detection, dense-CRF and tracking tutorials on a
   30-frame VGA RGB-D sequence of a 6 x 7 m room with brick walls, posters,
   path G's three objects as clutter and two people walking, seen by a fixed
   Kinect 1.2 m above the floor: (a) a linear and an RBF SVM on HOG windows of
   both figures and the empty room, Platt scaling, five-fold cross-validation
   and the libsvm file's round trip; (b) the ground-based people detector on
   every frame's 0.06 m voxels (B2), ground by RANSAC on frame 0, with the HOG
   confidence, and HOG features of each detection; (c) the dense CRF on frame
   0's 2 cm voxels (B2) from labels of which 20% are wrong, both filters, and
   tools.crf_segmentation; (d) the KLD-adaptive and the plain particle filter
   on person 1 over every frame's 2 cm voxels (B2; B1 once a step in each);
   (e) pyramidal KLT of frame 0's 500 strongest AGAST corners over the
   sequence against the rendered flow, BRISK and Trajkovic on frame 0; the
   checks at 1.5 x the JAX package's CPU rehearsal; the chain on the card
   against the CPU at 80 x 60; every B1 and B2 call held to its plain version
   (B1 on the first 32,768 rows of each call);
18. path P, PCL's stereo, organized-edge, image-extractor, range-likelihood
   and mesh-conversion tools on path O's room at frame 0 (VGA): (a) a
   rectified grey pair rendered from a left camera 0.05 m and 1 deg off the
   Kinect and a right camera 0.12 m beside it, block matching and the
   adaptive scanline matcher at 64 disparities against the true disparity,
   the stereo cloud and its elevation map; (b) the stereo cloud's and the
   Kinect cloud's 2 cm voxels (B2 twice) and point-to-point ICP on the brute
   backend (B1 once an iteration) against the rig's offset; (c) organized
   edges of all five types on the Kinect frame (gradient integral normals,
   the render's classes as labels) against the clean depth's silhouettes,
   every image extractor and the bearing-angle image through PNG and TIFF,
   tools.pcd2png, png2pcd and tiff2pcd; (d) z-buffer renders of the frame's
   cloud at 125 candidate poses scored by the range likelihood; (e)
   half-edge meshes of the box, an icosphere, the capped cylinder and the
   frame's organized mesh, the objects through PLY, OBJ, PCD, VTK and IFS by
   the CLIs, mesh_sampling, mesh2pcd and virtual_scanner, the scans' 1 cm
   voxels (B2) and their 1-NN to the true surfaces (B1); the checks at 1.5 x
   the JAX package's CPU rehearsal; the chain on the card against the CPU at
   80 x 60; every B1 and B2 call held to its plain version;
19. path Q, PCL's grabbers, compression, out-of-core octree and viewers on a
   drive through path C's street: (a) an HDL-32E at 10 Hz (72,000 rays a
   revolution) and a VLP-16, cast in float64 on the card against the
   street's analytic surfaces, 40 and 10 sweeps 1 m apart with 0.02 m range
   noise, written into pcap files by ``encode_packet``; (b) both replayed by
   ``PcapVelodyneGrabber`` through ``CloudIterator`` and ``frames()``,
   ``tools.pcap_to_pcd`` and ``tools.hdl_grabber_example``; (c) path C's
   front end on the HDL-32E sweeps (B2 once a sweep) against the golden
   poses; (d) the sweeps moved by their poses into the flat and the
   hierarchical out-of-core octree, box, frustum and tree queries against
   numpy masks, the LOD sizes, the map's 0.2 m voxels (B2) and their 1-NN
   to the street's dense samples (B1); (e) octree compression of every
   sweep against the card's voxel centres, the range coder, organized
   compression, median and average buffers over 30 VGA depth frames,
   ``ImageGrabber``, ``TimGrabber`` on path H (i)'s planar scans as TiM571
   telegrams and the image tools; (f) the HTML, ASCII, SVG and PGM views, a
   ``Visualizer`` with a scripted pick, a ``LiveViewer`` on 127.0.0.1 and
   the viewer tools (B2 twice, B1 once an ICP iteration); (g) the chain at
   3 VLP-16 sweeps on the card against the CPU; every B1 and B2 call held to
   its plain version;
20. path R, the last 25 CLIs in the order a PCL user chains them, each
   through its ``main`` with ``--device cuda``: on path C's scan 0 turned z-up
   (120,000 points) ``tools.voxel_grid`` (B2), ``uniform_sampling``, the
   passthrough, statistical, radius and radius-count filters, ``grid_min``,
   ``local_max``, ``morph`` and the progressive morphological filter (the
   ground against the street's, path J's check), Euclidean clusters of the
   rest and the ground's plane projection, ``extract_feature`` for all six
   features, the unary classifier trained on ground and objects and run on
   scan 1's voxels (B2); the file and per-point tools on the whole scan (PCD
   encodings, PLY, a triangle soup, NaN tools, viewpoints, demeaning, noise);
   ``fast_bilateral_filter`` and ``bilateral_upsampling`` on path G's VGA
   frame; the file tools' bytes against the port's CPU run, the whole chain
   on the card against the CPU on 15,000 points (each CPU step on the card's
   inputs, the same host draws); every B1 and B2 call held to its plain
   version; the native host runtime (``csrc/pcl_native.cpp``, built by the
   host's compiler) against B1 at 120,000 x 120,000 and against the port's
   searches; F8's float-to-int casts on the card.

The pair of paths A and B is uniform in a 100 m cube with 0.05 m Gaussian
noise (seed 0), the source moved by 0.25 deg about z and (0.10, -0.05,
0.08) m; path C's street and scans come from seed 0, the street with alleys
from seed 7, path E's two scans of path C's street from seed 5, path F's route
from seed 8, path G's room and camera from seed 9, path L's frame noise and
colours from seed 10, path N's model renders from seed 11 and its objects'
surfaces from seed 12, path O's sequence from seed 13 and its training windows from
seed 14, path P's stereo pair and surface samples from seed 15, path Q's drive, noise
and depth frames from seed 16, path R's draws for the card against the CPU and its
tools' ``-seed`` from seed 17. Any failed check
raises, so the exit code is non-zero. It prints the card's name and power
limit, one JSON line describing every kernel, and last
``{"ok": true, "device": {...}}``. Without a CUDA device it prints no result
and exits non-zero.
"""

import base64
import contextlib
import hashlib
import io as pyio
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from pcl_tpu_torch.utils import trace

N_POINTS = 120_000
NOISE = 0.05
MOTION_DEG = 0.25
MOTION_T = (0.10, -0.05, 0.08)
# H100 SXM peaks (NVIDIA data sheet, 700 W): float32 outside the tensor
# cores and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# path C: the odometry front end on a synthetic KITTI-scale street
SCENE_POINTS = 2_400_000
N_SCANS = 6
SCAN_CAPACITY = 120_000
LEAF = 0.2
NORMAL_K = 16
SEQUENCE_KW = dict(fov_tan=1.2, z_range=(1.0, 60.0), max_points=SCAN_CAPACITY,
                   step_translation=0.5, step_rotation=0.02, noise=0.02)
# cell_cap 256, not 128: a 2 m cell at a facade-ground corner or a car holds
# up to ~250 of the 0.2 m voxels (CPU rehearsal of these six scans)
ICP_KW = dict(variant="point_to_plane", max_corr_dist=1.0, max_iterations=40,
              cell_cap=256)
# path D: GICP and NDT behind the odometry command line
GICP_KW = dict(max_corr_dist=1.0, max_iterations=40)
GICP_K = 20
# NDT on this street (CPU rehearsal of the six scans at full size). Started from
# the identity it recovers the motion across the street and upwards but leaves
# the 0.45 m along the street untouched: ground and facades do not change along
# that axis, and the poles' and cars' Gaussians are some 0.07 m wide, so a
# point 0.45 m away feels none of them. It is therefore run as its users run
# it, from an odometry prior: the true step, off by 0.05 m across the street
# and 0.002 rad about a random axis (seeded), exact along the street. With 2 m
# voxels every pair then converged within 23 iterations to within 3 mm across
# the street; with 1 m voxels pair 4 stopped after 2 iterations at the prior's
# pose (its first step found no better score), and from a 0.10 m prior pair 3
# was still creeping after 35 iterations (the damping is relative to the trace
# of the Hessian, which the rotational entries dominate).
NDT_KW = dict(resolution=2.0, max_iterations=35)
NDT_PRIOR_ERROR = (0.05, 0.002)          # m across the street, rad
# 1.5 x the 0.012384 m measured on the H100 (0.012395 m in the CPU rehearsal);
# the limit first planned was 0.15 m, NDT's voxel-attraction bias at a quarter
# of this resolution in the JAX package's own test
NDT_ATE_LIMIT = 0.0186
# NDT without a prior: scans of the street with alleys (seed 7), whose side
# walls face along the street. From the identity, 2 m voxels, the CPU rehearsal
# of these scans left at most 0.0046 m of a 0.5 m step in 27 to 31 iterations
# (0.0047 m and 26 to 31 on the H100; 60 are allowed, not path D's 35: a
# quarter-size rehearsal took 36).
ALLEY_SCANS = 4
ALLEY_SEED = 7
NDT_BLIND_KW = dict(NDT_KW, max_iterations=60)
NDT_BLIND_STEP_LIMIT = 0.015      # m left of a step
# 1.5 x the 0.004910 m measured on the H100 (0.004848 m in the CPU rehearsal);
# first set to 0.15 m as NDT_ATE_LIMIT was
NDT_BLIND_ATE_LIMIT = 0.0074
BRUTE_GICP_POINTS = 8192
# the brute GICP pair is moved further, so that the first matches are partly
# wrong and several outer iterations run (4 in the CPU rehearsal): 8 deg about
# y and this translation, on top of the pair's own motion
BRUTE_GICP_DEG = 8.0
BRUTE_GICP_T = (3.0, -2.0, 2.5)
CARD_VS_CPU_POINTS = 20_000
# path E: global registration of two scans of the street 10 m apart and
# turned 20 deg (FCGF's KITTI protocol: pairs at least 10 m apart, 0.3 m
# voxels); the aligners' thresholds follow Open3D's global-registration
# recipe: FPFH over a 5-voxel radius, RANSAC inliers within 1.5 voxels
E_SEED = 5
E_POSE = (10.0, 20.0)              # m forward along z, deg about y (up)
E_LEAF = 0.3
E_GROUND_THRESHOLD = 0.1
E_FPFH_RADIUS = 5 * E_LEAF
E_INLIER = 1.5 * E_LEAF
# keypoints: voxels of curvature above this; on a street of facades most
# voxels are planar and share one FPFH (CPU rehearsal at full size: 1% of all
# voxels' best feature match is right, 13% of these keypoints')
E_KEYPOINT_CURVATURE = 0.08
# hypotheses raised from the JAX defaults (2048, 512, 512) for ~10% right
# picks: 3-point samples are right ~1e-3 of the time (PERF.md, path E)
E_PRE_KW = dict(n_hypotheses=32768, inlier_threshold=E_INLIER)
# SAC-IA's error truncated at the inlier distance and samples at least 1 m
# apart (PCL's setMaxCorrespondenceDistance and setMinSampleDistance): with
# the JAX default, a quarter of the bounding diagonal, the street's mirror
# image (turned 180 deg and 57 m on) scored better than the motion
E_IA_KW = dict(n_hypotheses=65536, error_threshold=E_INLIER, min_sample_distance=1.0)
E_CHAIN_KW = dict(n_hypotheses=8192)
# (a) again with the plain 1-NN, at the JAX default count of hypotheses
E_PLAIN_HYPOTHESES = 2048
E_ICP_KW = dict(max_corr_dist=1.0, max_iterations=60)
E_VALIDATE_KW = dict(max_range=1.0, threshold=0.05)
# limits, set from the first chip runs (PERF.md, path E): the ground plane's
# normal and offset, ~5x and ~3x the 2.2e-5 rad and 1.1e-3 m measured (first
# 1e-2 rad and 2e-2 m)
E_PLANE_LIMITS = (1e-4, 3e-3)      # rad, m
E_BASIN = (1.0, 0.1)               # m, rad: a start ICP's 1 m gate pulls in
# what ICP from a global result leaves of the motion: m across the street and
# up, m along it, rad. Point-to-point: 2x the 7.6 mm and 2.6e-4 rad and 1.7x
# the 0.18 m along the street measured on the H100 (the facades hold it back
# there, ROADMAP C22); point-to-plane: 3x the 3.4 mm, 9.6 mm, 2.4e-4 rad
E_REFINED = (0.015, 0.3, 5e-4)
E_REFINED_P2L = (0.01, 0.03, 5e-4)
E_HASH_K = 16
E_HASH_MIN_SHARE = 0.05
# phase 1's case at path E's shape: 2048 hypotheses x 1024 subset points
# against ~40k voxels
E_QUERIES = 2048 * 1024
E_TARGETS = 40_000
E_PLAIN_ROWS = 1 << 18
# phase 4's cloud past 2^30 bounding-box cells: 4000 clusters of 8 points
FAR_LEAF = 0.1
FAR_CAPACITY = 40_000

# path H: the featureless global aligners, PPF and the ICP variants on path
# E's pair; ISS keypoints over a 5-voxel salient radius (FPFH's), non-max
# suppression over half of it (the JAX package's default)
H_SALIENT = 5 * E_LEAF
# (g): two scanners on one vehicle, path C's gate
H_JOINT_KW = dict(max_corr_dist=1.0, max_iterations=40)
# joint ICP is point-to-point and creeps along the street (ROADMAP C22, C37):
# 1.5x the 0.348 m the JAX package left in the CPU rehearsal
# (tests/rehearse_path_h.py); its rotation lay below that measure's 4.5e-4
# rad resolution (the port at a tenth of the scan: 4.3e-4 rad after 8
# iterations), so 1.5x that resolution, rounded up
H_JOINT_LIMIT = (0.522, 1e-3)       # m, rad
H_ATE_LIMIT = 0.03                  # (h): path C's
# (i): a planar laser 0.3-1.3 m above the ground of the street with alleys,
# four scans 1.5 m and 2 deg apart
H_PLANAR_SEED = 7
H_PLANAR_SCANS = 4
H_PLANAR_STEP = (1.5, 2.0)          # m along the street, deg about the vertical
H_PLANAR_BAND = (0.3, 1.3)          # m above the ground
H_NDT2D_KW = dict(grid_extent=1.0, levels=3)
# 1.5x the most the CPU rehearsal left of a step (the JAX package and the
# port alike: 0.8374-1.0915 m along the street, up to 6.22e-5 rad): 2-D NDT
# does not see along this street at this cut (ROADMAP C36)
H_NDT2D_LIMIT = (1.64, 9.3e-5)      # m, rad
# card against CPU: subclouds of this many voxels, host 4PCS on this many
# keypoints of each scan
H_CPU_POINTS = 2048
H_CPU_KEYPOINTS = 300

# path K: descriptors, keypoints and clusters on path E's pair. Descriptors
# and keypoint detectors take FPFH's and ISS's 5-voxel support; on a plane
# the Harris response is 0 up to rounding, so Harris keypoints need a
# threshold above it (corners over 1.5 m score 0.03)
K_RADIUS = 5 * E_LEAF
K_HARRIS_THRESHOLD = 1e-3
K_SHOT_K = 128                      # the JAX default of estimate_shot_interpolated
K_SIFT = dict(min_scale=E_LEAF, n_octaves=3, scales_per_octave=3)
K_MATCH = 2 * E_LEAF                # a match within two voxels of its counterpart
K_PERSISTENCE = (1.2, 1.5, 1.8)     # m: FPFH's support at three scales
K_CPU_POINTS = 2048
K_CPU_RAW = 5000                    # (f): SIFT on this many raw points
# (f): FPFH persistence's masks may differ on this share of the rows (C19);
# its distances are compared on the rows float64 finds firm, at least this
# share of the rows
K_PERSIST_MASK_SHARE = 0.02
K_PERSIST_FIRM_SHARE = 0.5
# (g): B1's plain version on this many of the prerejective sweep's queries
# (its time grows as Q M; a 1-NN row depends on its own query only)
K_PLAIN_ROWS = 1 << 21
# (d): Euclidean clusters of the voxels (ground removed): neighbouring 0.3 m
# voxels lie within 0.42 m of each other, the gaps between cars, poles and
# facades are 2 m and more
K_CLUSTER_TOLERANCE = 0.5
K_CLUSTER_MIN = 20
# (e): scan 1's voxels moved by this many m and deg (a seeded axis). Rows
# whose decisions float64 finds firm may still differ beyond the tolerance:
# `eigh33`'s closed form errs by up to ~2e-4 of the largest eigenvalue (C9),
# which turns a frame with eigenvalues 5% apart by up to ~5e-3 rad and moves
# lattice neighbours across cuts further than the 1e-4 margin. The limit is
# 1.5x SHOT's share of 28 in 1,515 firm rows that the H100 and the CPU read
# with the first form of these checks (PERF.md, path K). With the tests'
# checks (tests/float64_cuts.py) both read 36 of 1,533 SHOT rows beyond 1e-3,
# 24 of 12,272 USC rows, 52 of 11,433 RoPS rows: tests/rehearse_path_k.py's
# `port` step prints them on the CPU
K_MOVE = (5.0, 30.0)
K_INVARIANCE_TOL = 1e-3
K_INVARIANCE_SHARE = 0.03

# path F: pose-graph alignment on a closed route through path C's street: scans
# out along it, then back in the other lane facing the same way, and odometry
# that drifts by F_DRIFT a step. LUM runs in tools.lum's flow with the tool's
# arguments F_LUM (its defaults but for the gate). The tool solves once, from
# correspondences at the drifted poses; path F goes on with one round per gate
# of F_GATES, correspondences found anew at the corrected poses within a
# shrinking gate, as ICP anneals. One solve removes only the error its first
# nearest neighbours see, and rounds at a fixed 1 m gate slide along the
# street, where ground and facades hold nothing (ROADMAP C22, C30; the CPU
# rehearsal at a quarter of the scan size: ATE 0.089 m drifted, 0.058, 0.063,
# 0.075, 0.085 m by round; with the shrinking gate 0.058, 0.049, 0.041, 0.032 m).
# Point-to-point correspondences between scans of other viewpoints pull the
# poses across and along the street as much as they correct (C30): what LUM
# removes on this route is the vertical and the rotational drift
F_SEED = 8
F_OUT = 8                          # scans out, then as many back
F_STEP = 1.5                       # m between scans
F_BACK = (0.6, 1.0)                # m across the street, deg about y, on the way back
F_DRIFT = (0.03, 0.003)            # m and rad of odometry error a step
F_LEAF = 0.2
F_LUM = dict(loop_dist=5.0, max_corr=2048, iter=5)
F_GATES = (1.0, 0.5, 0.3, 0.2, 0.1)   # m, the correspondence gate of each round
# 1.5 x the 0.0488 m measured on the H100 (0.449 of the drifted 0.1087 m; the
# CPU rehearsal at full size 0.0491 m); first planned as half the drifted ATE.
# LUM removes the vertical drift (0.100 -> 0.0024 m measured): 1.5 x that
F_ATE_LIMIT = 0.0732
F_UP_LIMIT = 0.0036
F_ELCH_ICP = dict(max_corr_dist=1.0, max_iterations=50)
# a graph of KITTI sequence 00's length (4,541 scans): dense and CG LUM
F_KITTI_V = 4541
F_KITTI_LOOPS = 200
F_KITTI_C = 256
F_KITTI_NOISE = 0.01
F_KITTI_DRIFT = (0.01, 0.0005)     # m and rad a step: ~1% of the distance, as KITTI odometry
F_KITTI_ITERS = 5
F_DENSE_LIMIT_S = 10.0
# from the golden poses LUM must stay where it is, within what the 0.01 m
# noise of the correspondences lets a 4,541-long chain wander: 1.5 x the
# 0.0078 m measured on the H100 (first planned as 0.1 m)
F_KITTI_TRUTH_ATE = 0.0117
# path G: KinFu at PCL KinFu's defaults (kinfu_large_scale: a 512^3 volume over
# a 3 m cube, VGA depth at fx = fy = 525, {10, 5, 4} ICP iterations) on a
# room corner rendered through that pinhole, 40 frames of handheld motion
G_SEED = 9
G_RES = 512
G_SIZE = 3.0
G_ORIGIN = (-1.5, -1.5, 0.0)
G_INTR = (525.0, 525.0, 319.5, 239.5)
G_SHAPE = (480, 640)
G_FRAMES = 40
G_STEP = (0.01, 0.5)               # m and deg a frame
G_TILT = 20.0                      # deg the camera looks down at the start
G_START = (0.1, -0.3, 0.1)
G_NOISE = 0.0015                   # m of range noise at 1 m, growing as depth^2
G_INVALID = 0.005                  # share of pixels dropped
G_FAR = 4.0
G_ATE_LIMIT = 0.0036               # 1.5 x the 0.00241 m measured on the H100 (planned: 0.02 m)
G_MAX_POINTS = 1 << 22
# path I: the sharded functions (parallel/) on one card: one rank under NCCL in
# this process, then I_RANKS ranks sharing the card under gloo, each a process
# of this script (``--path-i-rank``), joined within I_JOIN_S seconds
I_RANKS = 2
I_JOIN_S = 60                      # the ranks took 19-24 s (NVIDIA H100 80GB HBM3, 700 W)
I_FRAMES = 4                       # path G's first frames, fused at their true poses
I_GICP_ITERS = 20                  # sharded_gicp's default: no convergence test
I_POSE_TOL = 1e-4                  # m and rad: two ranks against one, float32 sums
# path J: the filter front end on path C's scans, PCL's tutorial settings
J_BOX = 20.0                       # half side of the crop box about the sensor (m)
J_SOR = dict(mean_k=50, stddev_mult=1.0)
J_ROR = dict(radius=0.8, min_neighbors=2)
J_PMF = dict(cell_size=1.0, max_window_size=20, slope=1.0, initial_distance=0.5,
             max_distance=3.0)
J_FPS = 4096
# the street's up axis is y; the morphological filters take z as up
J_UP = np.array([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def launch_count(kernel: str) -> int:
    """Launches of ``kernel`` (``"nn1"``: B1, ``"segsum"``: B2) since the
    recorder was last reset, as the port's recorder counts them."""
    return trace.counts().get(f"ops.{kernel}.launches", 0)


def make_pair(n: int, seed: int = 0):
    """bench.py's pair: target uniform in [-50, 50]^3, source = target plus
    N(0, 0.05^2) noise; the source is then moved by the known motion M.
    Returns (moved source, target, M)."""
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(-50, 50, size=(n, 3)).astype(np.float32)
    src = tgt + rng.normal(scale=NOISE, size=(n, 3)).astype(np.float32)
    a = math.radians(MOTION_DEG)
    M = np.eye(4)
    M[:3, :3] = [[math.cos(a), -math.sin(a), 0], [math.sin(a), math.cos(a), 0], [0, 0, 1]]
    M[:3, 3] = MOTION_T
    moved = (src @ M[:3, :3].T + M[:3, 3]).astype(np.float32)
    return moved, tgt, M


def residual_motion(T: torch.Tensor, M: np.ndarray):
    """Translation (m) and rotation (deg) left in T @ M; zero if ICP
    recovered the inverse of the motion exactly."""
    E = T.double().cpu().numpy() @ M
    R = E[:3, :3]
    # atan2 of the skew and symmetric parts stays accurate at tiny angles
    skew = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    ang = math.degrees(math.atan2(np.linalg.norm(skew), 0.5 * (np.trace(R) - 1)))
    return float(np.linalg.norm(E[:3, 3])), ang


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def nn1_bound_ms(nq: int, m: int):
    """Least time for one masked 3-D 1-NN sweep on this card. Operations:
    per (query, target) pair 3 FMAs and one minimum, 4 float32
    lane-instructions (the index of the minimum need not be tracked per
    pair), at the float32 instruction rate (peak FLOP/s / 2, an FMA counting 2).
    Bytes: queries and targets read once (12 B each, 1 B mask), index and
    distance written once. The larger bounds."""
    ops_s = 4.0 * nq * m / (PEAK_FP32_FLOPS / 2)
    bytes_s = (12.0 * nq + 13.0 * m + 8.0 * nq) / PEAK_BYTES
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")


def nn1_against_plain(nn1_mod, name, t, m, q, slices=None, plain_rows=None, tag="phase 1"):
    """B1 against its plain version on ``(t, m, q)`` (arrays or tensors) on
    the card; fails on a differing +inf, an index that is not a near-tie, or
    a distance beyond float32 rounding. Returns the largest distance error
    and the inputs as card tensors."""
    t, m, q = (torch.as_tensor(np.ascontiguousarray(a) if isinstance(a, np.ndarray) else a)
               .cuda().contiguous() for a in (t, m, q))
    ik, dk = nn1_mod.nn1(t, m, q, slices=slices)
    if plain_rows is not None:
        # the plain version on the first rows only (its time grows as Q M)
        q, ik, dk = q[:plain_rows], ik[:plain_rows], dk[:plain_rows]
    ip, dp = nn1_mod.nn1_plain(t, m, q)
    torch.cuda.synchronize()
    check(torch.equal(torch.isfinite(dk), torch.isfinite(dp)), f"{name}: +inf differs")
    fin = torch.isfinite(dk)
    err = float((dk[fin] - dp[fin]).abs().max()) if bool(fin.any()) else 0.0
    miss = ik != ip
    n_miss = int(miss.sum())
    # the plain version repeats the kernel's float32 arithmetic, so the
    # two agree bit for bit but for double-rounding in its float64
    # emulation of the FMA: a differing winner must be a near-tie
    if n_miss:
        qq, tk, tp = q[miss], t[ik[miss].long()], t[ip[miss].long()]
        scale = (qq * qq).sum(1) + (tk * tk).sum(1) + (tp * tp).sum(1)
        check(bool(((dk[miss] - dp[miss]).abs() <= 1e-6 * scale).all()),
              f"{name}: kernel and plain disagree beyond a near-tie")
    check(n_miss <= 1e-5 * len(q), f"{name}: {n_miss} differing indices")
    # tolerance: 1e-6 of the squared distance scale (float32 rounding)
    check(err <= 1e-6 * max(1.0, float(dp[fin].abs().max()) if bool(fin.any()) else 1.0),
          f"{name}: d2 differs by {err}")
    print(f"{tag}: nn1 {name}: Q={len(q)} M={len(t)} differing indices {n_miss} "
          f"max |d2 kernel - plain| {err:.3e}", flush=True)
    return err, (t, m, q)


def phase1_nn1(nn1_mod, moved, tgt):
    """Kernel against plain on the card; returns the kernel's record."""
    rng = np.random.default_rng(1)
    dev = "cuda"

    def case(name, t, m, q, slices=None, plain_rows=None):
        return nn1_against_plain(nn1_mod, name, t, m, q, slices=slices, plain_rows=plain_rows)

    def pts(n, lo=-5.0, hi=5.0):
        return rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)

    errs = []
    errs.append(case("ragged+masked", pts(3001), rng.uniform(size=3001) > 0.1, pts(1000))[0])
    errs.append(case("no valid target", pts(500), np.zeros(500, bool), pts(77))[0])
    one = np.zeros(700, bool)
    one[513] = True
    errs.append(case("one valid target", pts(700), one, pts(300))[0])
    base = pts(2100)
    t_dup = np.concatenate([base, base[::-1], base])         # exact ties across tiles
    q_dup = np.concatenate([base[rng.integers(0, 2100, 400)], pts(113)])
    m_dup = np.ones(len(t_dup), bool)
    m_dup[:50] = False
    errs.append(case("duplicates (ties)", t_dup, m_dup, q_dup)[0])
    errs.append(case("empty target", np.zeros((0, 3), np.float32), np.zeros(0, bool), pts(5))[0])
    # exact ties whose two copies sit either side of a sub-tile (32, 64, 128
    # targets), a 2048-target tile and a slice boundary (3 slices of 2048, 7
    # of 896), and far apart; the queries sit on the tied points
    t_tie = pts(6000)
    edges = [32, 64, 128, 896, 1792, 2048, 2688, 4096, 5376]
    for b in edges:
        t_tie[b] = t_tie[b - 1]
    t_tie[5000] = t_tie[5]
    q_tie = np.concatenate([t_tie[edges], t_tie[[5]], pts(90)])
    for slices in (None, 1, 3, 7):
        errs.append(case(f"ties across sub-tiles, tiles and slices (slices={slices})",
                         t_tie, np.ones(6000, bool), q_tie, slices=slices)[0])
    # fewer targets than one sub-tile; Q and M multiples of nothing, the
    # winner the last target of a ragged sub-tile
    errs.append(case("M = 17", pts(17), np.ones(17, bool), pts(3))[0])
    t_rag, q_rag = pts(2082), pts(1025)
    q_rag[:200] = t_rag[-1] + np.float32(1e-3)
    for slices in (None, 1, 5):
        errs.append(case(f"ragged Q = 1025, M = 2082, winner last (slices={slices})",
                         t_rag, np.ones(2082, bool), q_rag, slices=slices)[0])
    # a query on a target at the origin, twice in the target: scores +0.0
    # and -0.0 tie, and the lowest index wins
    t_zero = pts(300)
    t_zero[[3, 70, 257]] = 0.0
    t_zero[70] = -0.0
    q_zero = np.concatenate([np.zeros((2, 3), np.float32), pts(30)])
    q_zero[1] = -0.0
    errs.append(case("query and targets at the origin", t_zero, np.ones(300, bool), q_zero)[0])
    err, (t, m, q) = case("main path 120k x 120k", tgt, np.ones(len(tgt), bool), moved)
    errs.append(err)
    q2k = q[:2048].contiguous()
    errs.append(case("2048 x 120k", tgt, np.ones(len(tgt), bool), moved[:2048])[0])

    for bad, why in ((lambda: nn1_mod.nn1(t[:, :2].contiguous(), m, q[:, :2].contiguous()), "D != 3"),
                     (lambda: nn1_mod.nn1(t.double(), m, q.double()), "float64"),
                     (lambda: nn1_mod.nn1(t.t().contiguous().t(), m, q), "non-contiguous")):
        try:
            bad()
        except (ValueError, TypeError):
            continue
        raise AssertionError(f"nn1 wrapper accepted {why}")

    # path E's shape: the prerejective scoring sweep, 2048 x 1024 moved
    # subset points against ~40k voxel centroids, fifty queries to a target;
    # exact ties (a block of repeated targets, queries on targets) and 5% of
    # the targets masked
    tE = pts(E_TARGETS, -30.0, 30.0)
    tE[E_TARGETS // 2:E_TARGETS // 2 + 500] = tE[:500]
    mE = rng.uniform(size=E_TARGETS) > 0.05
    qE = pts(E_QUERIES, -30.0, 30.0)
    qE[::20] = tE[rng.integers(0, E_TARGETS, len(qE[::20]))]
    errs.append(case(f"path E's shape {E_QUERIES} x {E_TARGETS} (plain on the first "
                     f"{E_PLAIN_ROWS} queries)", tE, mE, qE, plain_rows=E_PLAIN_ROWS)[0])
    tE, mE, qE = (torch.from_numpy(a).to(dev) for a in (tE, mE, qE))
    msE = cuda_ms(lambda: nn1_mod.nn1(tE, mE, qE), reps=5)
    plainE = cuda_ms(lambda: nn1_mod.nn1_plain(tE, mE, qE[:E_PLAIN_ROWS]), reps=1)
    boundE, byE = nn1_bound_ms(E_QUERIES, E_TARGETS)

    ms = cuda_ms(lambda: nn1_mod.nn1(t, m, q), reps=20)
    plain_ms = cuda_ms(lambda: nn1_mod.nn1_plain(t, m, q), reps=2)
    bound_s, bound_by = nn1_bound_ms(len(q), len(t))
    slots = nn1_mod.device_slots(torch.cuda.current_device())
    print(f"phase 1: nn1 kernel {ms:.3f} ms per 120k x 120k sweep, plain {plain_ms:.1f} ms, "
          f"bound {bound_s * 1e3:.3f} ms ({bound_by}); the card holds {slots} blocks, "
          f"(slices, slice length) {nn1_mod.nn1_plan(len(q), len(t), slots)} "
          f"[{card_line()}]", flush=True)
    ms2k = cuda_ms(lambda: nn1_mod.nn1(t, m, q2k), reps=50)
    bound2k, by2k = nn1_bound_ms(len(q2k), len(t))
    print(f"phase 1: nn1 kernel {ms2k * 1e3:.1f} us per 2048 x 120k sweep, bound "
          f"{bound2k * 1e6:.1f} us ({by2k}), (slices, slice length) "
          f"{nn1_mod.nn1_plan(len(q2k), len(t), slots)} [{card_line()}]", flush=True)
    print(f"phase 1: nn1 kernel {msE:.3f} ms per {E_QUERIES} x {E_TARGETS} sweep (path E's "
          f"shape), plain {plainE:.1f} ms for its first {E_PLAIN_ROWS} queries, bound "
          f"{boundE * 1e3:.3f} ms ({byE}), (slices, slice length) "
          f"{nn1_mod.nn1_plan(E_QUERIES, E_TARGETS, slots)} [{card_line()}]", flush=True)
    return {"name": "nn1", "route": "cuda", "source": "pcl_tpu_torch/csrc/nn1.cu",
            "replaces": "pcl_tpu/ops/pallas_nn.py:32", "launches": None,
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_s * 1e3, "bound_by": bound_by, "library_ms": None,
            # the same numbers at path E's shape (plain on a slice of the queries)
            "path_e_shape": {"q": E_QUERIES, "m": E_TARGETS, "ms": msE,
                             "plain_ms": plainE, "plain_rows": E_PLAIN_ROWS,
                             "bound_ms": boundE * 1e3, "bound_by": byE}}


def timed(fn):
    """``(fn(), seconds)``, the card synchronised either side (where there is
    one: path Q's chain runs ``front_end`` on the CPU too)."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def device_breakdown(tag: str, fn) -> None:
    """One run of ``fn`` under torch.profiler: device time against the host
    clock (the idle share) and the operators that take the most device
    time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, secs = timed(fn)
    # device-side events only (kernels, copies): an operator's own row
    # repeats the time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us == 0:
        print(f"{tag}: profile: device time not measured", flush=True)
        return
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    names = "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                      for e in top)
    print(f"{tag}: profile: {sum(e.count for e in events)} device events, busy "
          f"{busy_us / 1e3:.3f} ms of {secs * 1e3:.3f} ms host (idle share "
          f"{1 - busy_us / 1e6 / secs:.3f}); top: {names}", flush=True)


def phase2_path_a(nn1_mod, src, tgt, M, record):
    from pcl_tpu_torch.core.cloud import make_cloud
    from pcl_tpu_torch.registration.icp import fitness_score, icp
    from pcl_tpu_torch.search import bruteforce

    source, target = make_cloud(src), make_cloud(tgt)
    kw = dict(max_corr_dist=math.inf, max_iterations=30)
    icp(source, target, max_iterations=2)          # warm-up (libraries)

    trace.reset()
    res, secs = timed(lambda: icp(source, target, **kw))
    fit = fitness_score(source, target, res.transform)
    torch.cuda.synchronize()
    launches = launch_count("nn1")
    record["launches_by_path"] = {"A": launches}

    it = int(res.iterations)
    code = int(res.convergence_state)
    dt, dang = residual_motion(res.transform, M)
    ms_iter = secs * 1e3 / it
    print(f"phase 2: path A (brute, kernel) {it} iterations, code {code}, fitness "
          f"{float(res.fitness):.6f}, fitness_score {float(fit):.6f}, nn1 launches "
          f"{launches}; residual motion {dt:.2e} m {dang:.2e} deg; "
          f"{ms_iter:.3f} ms per ICP iteration [{card_line()}]", flush=True)
    device_breakdown("phase 2", lambda: icp(source, target, **kw))
    check(launches >= it + 1, f"nn1 kernel launched {launches} times for {it} iterations")
    check(bool(res.converged), f"path A did not converge (code {code})")
    check(dt <= 1e-3 and dang <= 0.01, f"path A missed the motion: {dt} m, {dang} deg")
    check(bool(torch.isfinite(res.transform).all()), "path A transform not finite")
    check(0.8 * 3 * NOISE ** 2 < float(fit) < 1.2 * 3 * NOISE ** 2,
          f"path A fitness {float(fit)} far from 3 sigma^2")

    # the same ICP with the plain 1-NN on the card
    kernel_nn1 = bruteforce.nn1
    bruteforce.nn1 = nn1_mod.nn1_plain
    try:
        plain, psecs = timed(lambda: icp(source, target, **kw))
    finally:
        bruteforce.nn1 = kernel_nn1
    pit = int(plain.iterations)
    tdiff = float((plain.transform - res.transform).abs().max())
    print(f"phase 2: path A with plain nn1: {pit} iterations, code "
          f"{int(plain.convergence_state)}, max |T - T_kernel| {tdiff:.2e}, "
          f"{psecs * 1e3 / pit:.1f} ms per ICP iteration", flush=True)
    check(int(plain.convergence_state) == code, "plain-nn1 ICP ended with another code")
    check(abs(pit - it) <= 1, f"plain-nn1 ICP took {pit} iterations against {it}")
    check(tdiff <= 1e-5, f"plain-nn1 ICP transform differs by {tdiff}")

    # a small noise-free pair against the port's own CPU run (with noise the
    # absolute-MSE test waits for a fixed point that rounding decides)
    small_tgt = tgt[:2048]
    small_src = (small_tgt @ M[:3, :3].T + M[:3, 3]).astype(np.float32)
    on_gpu = icp(make_cloud(small_src), make_cloud(small_tgt), **kw)
    on_cpu = icp(make_cloud(small_src, device="cpu"),
                         make_cloud(small_tgt, device="cpu"), **kw)
    sdiff = float((on_gpu.transform.cpu() - on_cpu.transform).abs().max())
    print(f"phase 2: 2048-point ICP, card {int(on_gpu.iterations)} iterations code "
          f"{int(on_gpu.convergence_state)}, CPU {int(on_cpu.iterations)} code "
          f"{int(on_cpu.convergence_state)}, max |T_card - T_cpu| {sdiff:.2e}", flush=True)
    check(int(on_gpu.convergence_state) == int(on_cpu.convergence_state)
          and abs(int(on_gpu.iterations) - int(on_cpu.iterations)) <= 1
          and sdiff <= 1e-5, "ICP on the card disagrees with the CPU run")
    return ms_iter


def phase3_path_b(src, tgt, M):
    from pcl_tpu_torch.core.cloud import make_cloud
    from pcl_tpu_torch.registration.icp import build_index, icp

    source, target = make_cloud(src), make_cloud(tgt)
    grid = (53, 53, 53)
    table, bsecs = timed(lambda: build_index(target, 1.0, cell_cap=8, grid_dims=grid))
    kw = dict(max_corr_dist=1.0, max_iterations=20, transformation_eps=0.0,
              abs_mse_eps=0.0, rel_mse_eps=0.0, cell_cap=8, grid_dims=grid, index=table)
    icp(source, target, **dict(kw, max_iterations=2))     # warm-up
    res, secs = timed(lambda: icp(source, target, **kw))
    it = int(res.iterations)
    dt, dang = residual_motion(res.transform, M)
    ms_iter = secs * 1e3 / it
    print(f"phase 3: path B (dense cell grid 53^3, cap 8) index build {bsecs * 1e3:.1f} ms; "
          f"{it} iterations, truncated {bool(res.truncated)}, fitness {float(res.fitness):.6f}, "
          f"correspondences {int(res.num_correspondences)}; residual motion {dt:.2e} m "
          f"{dang:.2e} deg; {ms_iter:.3f} ms per ICP iteration [{card_line()}]", flush=True)
    device_breakdown("phase 3", lambda: icp(source, target, **kw))
    check(not bool(res.truncated), "path B truncated: raise cell_cap")
    check(it == 20, f"path B ran {it} iterations")
    check(0.8 * 3 * NOISE ** 2 < float(res.fitness) < 1.2 * 3 * NOISE ** 2,
          f"path B fitness {float(res.fitness)} far from 3 sigma^2")
    check(dt <= 1e-3 and dang <= 0.01, f"path B missed the motion: {dt} m, {dang} deg")
    return ms_iter


def street_parts(alleys: bool = False):
    """``make_street``'s surfaces: ``(ground height, quads, poles, pole
    radius, pole height, cars)``; a quad is ``(origin, edge u, edge v)`` with
    u and v along two axes (the ground, the facades and the alleys' walls
    first, then five faces of each car), a pole its ``(x, z)``, a car its
    box ``(lo, hi)``."""
    g = -1.7
    # planar patches: (origin, edge u, edge v)
    quads = [((-20, g, 0), (40, 0, 0), (0, 0, 200))]
    quads += [((s * 10, g, 0), (0, 12, 0), (0, 0, 200)) for s in (-1, 1)]
    if alleys:
        quads += [((s * 10, g, z0), (s * 10, 0, 0), (0, 12, 0))
                  for s in (-1, 1) for z0 in range(12, 200, 12)]
    cars = []
    for i in range(10):
        x0, z0 = (-4.9 if i % 2 else 3.1), 8.0 + 19.0 * i
        lo, (dx, dy, dz) = np.array([x0, g, z0]), (1.8, 1.5, 4.5)
        quads += [(lo + (0, dy, 0), (dx, 0, 0), (0, 0, dz)),          # roof
                  (lo, (dx, 0, 0), (0, dy, 0)), (lo + (0, 0, dz), (dx, 0, 0), (0, dy, 0)),
                  (lo, (0, dy, 0), (0, 0, dz)), (lo + (dx, 0, 0), (0, dy, 0), (0, 0, dz))]
        cars.append((lo, lo + (dx, dy, dz)))
    poles = [(s * 7.0, 5.0 + 10.0 * j) for s in (-1, 1) for j in range(20)]
    return g, quads, poles, 0.15, 5.0, cars


def street_hits(o: np.ndarray, d: np.ndarray, alleys: bool = False, dev="cpu"):
    """Nearest hit of rays ``o + t d`` (``o [3]``, ``d [N, 3]``, the street's
    frame) with ``make_street``'s surfaces, in float64 on ``dev``: ``(t,
    part)`` as host arrays, ``t`` inf where nothing is hit, ``part`` 0 the
    ground, 1 a facade or an alley's wall, 2 a car, 3 a pole, -1 nothing. The
    cars are their boxes (a ray from outside enters through one of the five
    faces ``make_street`` samples: the floor lies on the ground)."""
    g, quads, poles, r, h, cars = street_parts(alleys)
    n_planes = len(quads) - 5 * len(cars)
    f64 = dict(dtype=torch.float64, device=dev)
    o, d = torch.as_tensor(o, **f64), torch.as_tensor(d, **f64)
    best = torch.full((len(d),), math.inf, **f64)
    part = torch.full((len(d),), -1, dtype=torch.int64, device=dev)
    safe = torch.where(d.abs() > 1e-12, d, 1e-12)

    def take(t, ok, code):
        ok = ok & (t > 1e-6) & (t < best)
        best.copy_(torch.where(ok, t, best))
        part.masked_fill_(ok, code)

    for i, (q0, u, v) in enumerate(quads[:n_planes]):
        axis = int(np.argmax(np.abs(np.cross(u, v))))
        q0, u, v = (torch.as_tensor(np.asarray(a, float), **f64) for a in (q0, u, v))
        t = (q0[axis] - o[axis]) / safe[:, axis]
        rel = o - q0 + t[:, None] * d
        a, b = rel @ u / (u @ u), rel @ v / (v @ v)
        take(t, (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1), 0 if i == 0 else 1)
    lo = torch.as_tensor(np.array([c[0] for c in cars]), **f64)          # [C, 3]
    hi = torch.as_tensor(np.array([c[1] for c in cars]), **f64)
    inv = 1.0 / safe[:, None, :]                                        # [N, 1, 3]
    t0, t1 = (lo - o) * inv, (hi - o) * inv                             # [N, C, 3]
    t_in = torch.minimum(t0, t1).amax(-1)
    t_out = torch.maximum(t0, t1).amin(-1)
    t_in = torch.where(t_in < t_out, t_in, math.inf).amin(-1)
    take(t_in, torch.isfinite(t_in), 2)
    c = torch.as_tensor(np.array(poles, float), **f64)                  # [P, 2]: x, z
    A = (d[:, 0] ** 2 + d[:, 2] ** 2)[:, None]
    ox, oz = o[0] - c[:, 0], o[2] - c[:, 1]
    B = d[:, :1] * ox + d[:, 2:] * oz
    disc = B * B - A * (ox ** 2 + oz ** 2 - r * r)
    t = (-B - torch.sqrt(torch.clamp(disc, min=0))) / torch.clamp(A, min=1e-12)
    y = o[1] + t * d[:, 1:2]
    t = torch.where((disc > 0) & (t > 1e-6) & (y >= g) & (y <= g + h), t, math.inf).amin(-1)
    take(t, torch.isfinite(t), 3)
    return best.cpu().numpy(), part.cpu().numpy()


def make_street(seed: int = 0, n: int = SCENE_POINTS, alleys: bool = False) -> np.ndarray:
    """A KITTI-like street in the scanner's frame (z forward, y up, the
    sensor at the origin), points spread uniformly by area: a ground plane
    1.7 m below the sensor (40 m wide, z 0..200 m), two building facades
    10 m either side (12 m tall), 40 poles (r 0.15 m, 5 m tall) every 10 m
    along both kerbs, and 10 car-sized boxes (4.5 x 1.8 x 1.5 m). With
    ``alleys`` the buildings stand apart: every 12 m a side wall runs 10 m back
    from either facade (12 m tall), a surface that faces along the street."""
    rng = np.random.default_rng(seed)
    g, quads, poles, r_pole, h_pole, _ = street_parts(alleys)
    quad_area = [np.linalg.norm(np.cross(u, v)) for _, u, v in quads]
    area = np.array(quad_area + [2 * np.pi * r_pole * h_pole] * len(poles))
    which = rng.choice(len(area), size=n, p=area / area.sum())
    a, b = rng.random(n), rng.random(n)
    out = np.empty((n, 3))
    nq = len(quads)
    o = np.array([q[0] for q in quads], float)
    u = np.array([q[1] for q in quads], float)
    v = np.array([q[2] for q in quads], float)
    isq = which < nq
    k = which[isq]
    out[isq] = o[k] + a[isq, None] * u[k] + b[isq, None] * v[k]
    k = which[~isq] - nq
    centre = np.array(poles)[k]
    th = 2 * np.pi * a[~isq]
    out[~isq] = np.stack([centre[:, 0] + r_pole * np.cos(th), g + h_pole * b[~isq],
                          centre[:, 1] + r_pole * np.sin(th)], 1)
    return out


def segsum_bound_ms(n: int, w: int, n_seg: int):
    """Least time for one segment sum of ``vals [n, w]`` on this card: the
    values and the ids read once (4 B each), the ``n_seg`` live output rows
    written once, against the n*w float32 additions at the float32 rate.
    The larger bounds (bytes, by far)."""
    bytes_s = (4.0 * n * w + 4.0 * n + 4.0 * n_seg * w) / PEAK_BYTES
    ops_s = float(n) * w / PEAK_FP32_FLOPS
    return (ops_s, "operations") if ops_s > bytes_s else (bytes_s, "bytes")


def far_clusters(seed: int = 3, n_clusters: int = 4000, per: int = 8) -> np.ndarray:
    """Clusters of ``per`` points in 0.15 m boxes scattered over a 4 km cube:
    at ``FAR_LEAF`` the bounding box holds ~6e13 cells, past the dense id's
    2^30, so voxel_downsample sorts the three cell keys; a cluster fills one
    to eight voxels."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-2000.0, 2000.0, size=(n_clusters, 1, 3))
    pts = centres + rng.uniform(0.0, 0.15, size=(n_clusters, per, 3))
    return pts.reshape(-1, 3).astype(np.float32)


def main_path_segments(segsum, cloud, leaf):
    """Kernel B2's inputs as ``voxel_downsample`` gives them for a cloud
    without attributes: the xyz columns and the weight column, cell-sorted
    (N x 4), their segment ids, and the number of voxels."""
    from pcl_tpu_torch.filters import voxel_grid

    order, seg_id, first = voxel_grid._sorted_cell_segments(cloud.xyz, cloud.mask, leaf)
    vals, seg = segsum.sorted_inputs(cloud.xyz, cloud.mask, order, seg_id)
    return vals, seg, int(first.sum())


def main_path_ndt_segments(cloud, resolution):
    """Kernel B2's inputs as ``ndt.build_grid`` gives them: the 13 columns
    (xyz, the nine products, the weight) sorted by hash bucket, their segment
    ids, and the number of occupied buckets."""
    from pcl_tpu_torch.registration.ndt import _bucket_segments, _buckets, build_grid

    table_size = build_grid.__defaults__[0]
    res = torch.as_tensor(resolution, dtype=torch.float32, device=cloud.xyz.device)
    _, h = _buckets(cloud.xyz, cloud.mask, res, table_size)
    vals, seg, _, first, _ = _bucket_segments(cloud.xyz, cloud.mask, h)
    return vals, seg, int(first.sum())


def far_voxels_on_card(segsum):
    """voxel_downsample past 2^30 bounding-box cells on the card: one B2
    launch, and the same voxels as the CPU run (both add each voxel's points
    in the same order, so they should agree exactly; the tolerance, 1e-6 of
    the coordinate scale, would only absorb another float32 addition
    order). Returns the cloud on the card."""
    from pcl_tpu_torch import filters
    from pcl_tpu_torch.core.cloud import from_numpy
    from pcl_tpu_torch.filters import voxel_grid

    far = far_clusters()
    attrs = {"intensity": np.random.default_rng(4).random(len(far)).astype(np.float32)}
    cloud = from_numpy(far, attrs=attrs, capacity=FAR_CAPACITY)
    _, _, span = segsum.cell_grid(cloud.xyz, cloud.mask, FAR_LEAF)
    n_cells = float(voxel_grid._n_cells(span))
    check(n_cells >= 2 ** 30, f"far clusters span only {n_cells} cells")
    before = launch_count("segsum")
    on_card = filters.voxel_downsample(cloud, FAR_LEAF)
    torch.cuda.synchronize()
    launches = launch_count("segsum") - before
    on_cpu = filters.voxel_downsample(
        from_numpy(far, attrs=attrs, capacity=FAR_CAPACITY, device="cpu"), FAR_LEAF)
    check(launches == 1, f"voxel_downsample past 2^30 cells launched B2 {launches} times")
    check(torch.equal(on_card.mask.cpu(), on_cpu.mask),
          "past 2^30 cells: live voxels differ from the CPU run")
    xerr = float((on_card.xyz.cpu() - on_cpu.xyz).abs().max())
    ierr = float((on_card.attrs["intensity"].cpu() - on_cpu.attrs["intensity"]).abs().max())
    check(xerr <= 1e-6 * 2000.0 and ierr <= 1e-6,
          f"past 2^30 cells: card and CPU differ by {xerr} m, intensity {ierr}")
    print(f"phase 4: voxel_downsample past 2^30 cells ({n_cells:.3e} cells, "
          f"{len(far)} points): {int(on_card.mask.sum())} voxels, B2 launches {launches}, "
          f"card vs CPU max |centroid diff| {xerr:.3e} m, |intensity diff| {ierr:.3e}",
          flush=True)
    return cloud


def phase4_segsum(segsum, scan0: np.ndarray):
    """Kernel B2 against its plain version on the card; returns its record."""
    from pcl_tpu_torch.core.cloud import from_numpy

    rng = np.random.default_rng(2)
    dev = "cuda"

    def segments(n, w, p_new, valid_frac, tail):
        steps = (rng.random(n) < p_new).astype(np.int32)
        steps[:1] = 0
        seg = np.cumsum(steps).astype(np.int32)
        nvalid = int(n * valid_frac)
        seg[nvalid:] = tail
        vals = rng.normal(size=(n, w)).astype(np.float32)
        vals[nvalid:] = 0.0
        return torch.from_numpy(vals).to(dev), torch.from_numpy(seg).to(dev)

    def case(name, vals, seg):
        k1 = segsum.segment_sum_sorted(vals, seg)
        k2 = segsum.segment_sum_sorted(vals, seg)
        plain = segsum.segment_sum_sorted_plain(vals, seg)
        members = segsum.segment_sum_sorted_plain(torch.ones_like(vals[:, :1]), seg)[:, 0]
        torch.cuda.synchronize()
        check(torch.equal(k1, k2), f"B2 {name}: two launches differ")
        # both add a segment's rows in ascending order from 0; 1e-6 sum|v|
        # would absorb another rounding order
        mag = segsum.segment_sum_sorted_plain(vals.abs(), seg).sum(1, keepdim=True)
        check(bool(((k1 - plain).abs() <= 1e-6 * mag).all()), f"B2 {name}: kernel != plain")
        live = members > 0
        check(bool((k1[~live] == 0).all()), f"B2 {name}: a row without members is not 0")
        # a run that one thread adds alone is added in the plain version's order
        short = members <= segsum.SEQUENTIAL_ROWS
        check(torch.equal(k1[short], plain[short]),
              f"B2 {name}: a run of up to {segsum.SEQUENTIAL_ROWS} rows differs from plain")
        err = float((k1 - plain).abs().max()) if k1.numel() else 0.0
        print(f"phase 4: segsum {name}: N={vals.shape[0]} W={vals.shape[1]} segments "
              f"{int(live.sum())} ({int((live & ~short).sum())} longer than "
              f"{segsum.SEQUENTIAL_ROWS} rows), two launches bitwise equal, max "
              f"|kernel - plain| {err:.3e}", flush=True)
        return err

    n_main = SCAN_CAPACITY
    errs = [
        case("ragged N", *segments(100_003, 4, 0.3, 0.9, 100_003)),
        case("one segment of all rows", *segments(n_main, 4, 0.0, 1.0, n_main)),
        case("every row its own segment", *segments(n_main, 4, 1.0, 1.0, n_main)),
        case("no valid row", *segments(5000, 4, 0.3, 0.0, 5000)),
        case("N = 0", *segments(0, 4, 0.3, 1.0, 0)),
        case("W = 1, tail 2**28", *segments(7777, 1, 0.5, 0.8, 2 ** 28)),
        case("W = 7, tail 2**28", *segments(7777, 7, 0.5, 0.8, 2 ** 28)),
        case("W = 131", *segments(7777, 131, 0.5, 0.8, 7777)),
        case("runs of ~500 rows", *segments(n_main, 4, 0.002, 1.0, n_main)),
        case("runs of ~500 rows, W = 7", *segments(50_000, 7, 0.002, 0.95, 50_000)),
    ]
    # runs of one row less, as many, and one more than a thread adds alone
    L = segsum.SEQUENTIAL_ROWS
    lengths = np.tile([L - 1, L, L + 1], 200)
    seg = np.repeat(np.arange(len(lengths)), lengths).astype(np.int32)
    vals = rng.normal(size=(len(seg), 4)).astype(np.float32)
    errs.append(case(f"runs of {L - 1}, {L}, {L + 1} rows",
                     torch.from_numpy(vals).to(dev), torch.from_numpy(seg).to(dev)))
    # ids that skip (callers make none): the rows of the gaps are 0
    steps = ((rng.random(10_000) < 0.2) * rng.integers(1, 4, 10_000)).astype(np.int32)
    steps[0] = 2
    seg = np.cumsum(steps).astype(np.int32)
    seg[9000:] = 2 ** 28
    vals = rng.normal(size=(10_000, 4)).astype(np.float32)
    errs.append(case("gaps between ids", torch.from_numpy(vals).to(dev),
                     torch.from_numpy(seg).to(dev)))
    one_vals, one_seg = segments(n_main, 4, 0.0, 1.0, n_main)
    one_ms = cuda_ms(lambda: segsum.segment_sum_sorted(one_vals, one_seg), reps=3)

    far_cloud = far_voxels_on_card(segsum)
    errs.append(case("past 2^30 cells (three-key sort)",
                     *main_path_segments(segsum, far_cloud, FAR_LEAF)[:2]))
    vals, seg, n_vox = main_path_segments(
        segsum, from_numpy(scan0, capacity=SCAN_CAPACITY), LEAF)
    errs.append(case("main path (scan 0, leaf 0.2)", vals, seg))
    # path D gives the kernel another shape: the NDT grid of the raw scan, 13
    # columns, runs of hundreds of rows (added by a block, four columns at a
    # time only where W % 4 == 0)
    g_vals, g_seg, g_cells = main_path_ndt_segments(
        from_numpy(scan0, capacity=SCAN_CAPACITY), NDT_KW["resolution"])
    check(g_vals.shape == (SCAN_CAPACITY, 13), f"NDT grid columns {tuple(g_vals.shape)}")
    g_err = case(f"main path D (NDT grid of scan 0, resolution {NDT_KW['resolution']})",
                 g_vals, g_seg)
    errs.append(g_err)
    for bad, why in ((lambda: segsum.segment_sum_sorted(vals.double(), seg), "float64"),
                     (lambda: segsum.segment_sum_sorted(vals, seg.long()), "int64 ids"),
                     (lambda: segsum.segment_sum_sorted(vals.t().contiguous().t(), seg),
                      "non-contiguous")):
        try:
            bad()
        except (ValueError, TypeError):
            continue
        raise AssertionError(f"segsum wrapper accepted {why}")

    # torch.segment_reduce computes the same sums from segment lengths (the
    # invalid tail as one more segment); timed as the yardstick only
    lengths = torch.bincount(torch.clamp(seg, max=n_vox), minlength=n_vox + 1)
    lib_out = torch.segment_reduce(vals, "sum", lengths=lengths)
    check(bool((lib_out[:n_vox] - segsum.segment_sum_sorted_plain(vals, seg)[:n_vox])
               .abs().max() <= 1e-3), "segment_reduce does not compute the same sums")
    ms = cuda_ms(lambda: segsum.segment_sum_sorted(vals, seg), reps=200)
    plain_ms = cuda_ms(lambda: segsum.segment_sum_sorted_plain(vals, seg), reps=20)
    library_ms = cuda_ms(lambda: torch.segment_reduce(vals, "sum", lengths=lengths), reps=20)
    bound_s, bound_by = segsum_bound_ms(vals.shape[0], vals.shape[1], n_vox)
    from torch.profiler import ProfilerActivity, profile

    for what, (pv, ps) in ((f"N={vals.shape[0]} W={vals.shape[1]}", (vals, seg)),
                           (f"N={g_vals.shape[0]} W={g_vals.shape[1]} (the NDT grid)",
                            (g_vals, g_seg))):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                segsum.segment_sum_sorted(pv, ps)
            torch.cuda.synchronize()
        device_us = {}
        for e in prof.key_averages():
            name = re.search(r"segsum\w*_kernel", e.key)
            if e.device_type == torch.autograd.DeviceType.CUDA and name:
                device_us[name.group(0)] = e.self_device_time_total / e.count
        print(f"phase 4: segsum device time per launch at {what} (profiler): "
              + (", ".join(f"{k} {v:.2f} us" for k, v in device_us.items())
                 or "not measured"), flush=True)
    noop = segsum.launch_floor()
    floor_ms = cuda_ms(noop, reps=500)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(500):
        noop()
    floor_host = (time.perf_counter() - t0) / 500
    torch.cuda.synchronize()
    print(f"phase 4: launch floor: an empty kernel through the same ctypes path "
          f"{floor_ms * 1e3:.1f} us per call (CUDA events), {floor_host * 1e6:.1f} us of host "
          f"time per call [{card_line()}]", flush=True)
    g_lengths = torch.bincount(torch.clamp(g_seg, max=g_cells), minlength=g_cells + 1)
    g_ms = cuda_ms(lambda: segsum.segment_sum_sorted(g_vals, g_seg), reps=200)
    g_plain_ms = cuda_ms(lambda: segsum.segment_sum_sorted_plain(g_vals, g_seg), reps=20)
    g_library_ms = cuda_ms(lambda: torch.segment_reduce(g_vals, "sum", lengths=g_lengths),
                           reps=20)
    g_bound_s, g_bound_by = segsum_bound_ms(g_vals.shape[0], g_vals.shape[1], g_cells)
    print(f"phase 4: segsum kernel {g_ms * 1e3:.1f} us per call at N={g_vals.shape[0]} "
          f"W={g_vals.shape[1]} ({g_cells} occupied buckets: the NDT grid), plain "
          f"{g_plain_ms * 1e3:.1f} us, torch.segment_reduce {g_library_ms * 1e3:.1f} us, bound "
          f"{g_bound_s * 1e6:.2f} us ({g_bound_by}) [{card_line()}]", flush=True)
    print(f"phase 4: segsum kernel {ms * 1e3:.1f} us per call at N={vals.shape[0]} "
          f"W={vals.shape[1]} ({n_vox} voxels), plain {plain_ms * 1e3:.1f} us, "
          f"torch.segment_reduce {library_ms * 1e3:.1f} us, bound {bound_s * 1e6:.2f} us "
          f"({bound_by}); one segment of {n_main} rows {one_ms:.3f} ms [{card_line()}]",
          flush=True)
    return {"name": "segsum", "route": "cuda", "source": "pcl_tpu_torch/csrc/segsum.cu",
            "replaces": "pcl_tpu/ops/pallas_segsum.py:38", "launches": None,
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_s * 1e3, "bound_by": bound_by, "library_ms": library_ms,
            # the same numbers at path D's shape (N x 13, the NDT grid)
            "ndt_grid": {"n": g_vals.shape[0], "w": g_vals.shape[1], "segments": g_cells,
                         "max_abs_err": g_err, "ms": g_ms, "plain_ms": g_plain_ms,
                         "bound_ms": g_bound_s * 1e3, "bound_by": g_bound_by,
                         "library_ms": g_library_ms}}


def front_end(raw, log=None):
    """voxel_downsample (kernel B2) and estimate_normals for each scan, then
    point-to-plane odometry_sequence. Returns (clouds, poses, [(ICP result,
    seconds)]); with ``log``, prints each stage's time."""
    from pcl_tpu_torch import features, filters, search
    from pcl_tpu_torch.registration.icp import icp
    from pcl_tpu_torch.registration import trajectory

    clouds = []
    for i, cloud in enumerate(raw):
        ds, t_ds = timed(lambda: filters.voxel_downsample(cloud, LEAF))
        probe, t_probe = timed(lambda: search.auto_cell_params(ds, NORMAL_K))
        # estimate_normals runs the same host probe again inside
        nc, t_n = timed(lambda: features.estimate_normals(ds, k=NORMAL_K))
        clouds.append(nc)
        if log:
            print(f"{log}: scan {i}: {int(ds.mask.sum())} voxels; downsample "
                  f"{t_ds * 1e3:.3f} ms, normals {t_n * 1e3:.3f} ms (of it the host probe "
                  f"{t_probe * 1e3:.3f} ms: cell {probe[0]:.4f} m, cap {probe[1]})", flush=True)
    results = []

    def register(s, t):
        res, secs = timed(lambda: icp(s, t, **ICP_KW))
        results.append((res, secs))
        return res

    poses = trajectory.odometry_sequence(clouds, register=register)
    return clouds, poses, results


def phase5_path_c(segsum, nn1_mod, scans, golden, record_b1, record_b2):
    """Path C: the odometry front end at KITTI scan size."""
    from pcl_tpu_torch import features, filters, search
    from pcl_tpu_torch.core import geometry
    from pcl_tpu_torch.core.cloud import Cloud, from_numpy
    from pcl_tpu_torch.registration.icp import icp
    from pcl_tpu_torch.registration import trajectory

    raw = [from_numpy(s, capacity=SCAN_CAPACITY) for s in scans]
    warm = [features.estimate_normals(filters.voxel_downsample(c, LEAF), k=NORMAL_K)
            for c in raw[:2]]
    icp(warm[1], warm[0], **dict(ICP_KW, max_iterations=2))      # warm-up

    trace.reset()
    (clouds, poses, results), secs = timed(lambda: front_end(raw, log="phase 5"))
    launches = launch_count("segsum")
    record_b1["launches_by_path"]["C"] = launch_count("nn1")
    record_b2["launches_by_path"] = {"C": launches}
    print(f"phase 5: path C {N_SCANS} scans in {secs * 1e3:.1f} ms; segsum launches "
          f"{launches}, nn1 launches {launch_count('nn1')}", flush=True)
    check(launches == N_SCANS, f"segsum launched {launches} times for {N_SCANS} scans")
    for k, (res, t) in enumerate(results):
        it = int(res.iterations)
        print(f"phase 5: pair {k + 1}->{k}: ICP {t * 1e3:.3f} ms, {it} iterations "
              f"({t * 1e3 / max(it, 1):.3f} ms per iteration), code "
              f"{int(res.convergence_state)}, truncated {bool(res.truncated)}, "
              f"correspondences {int(res.num_correspondences)}, fitness "
              f"{float(res.fitness):.6f} [{card_line()}]", flush=True)
        check(bool(res.converged), f"path C pair {k + 1} did not converge")
        check(not bool(res.truncated), f"path C pair {k + 1} truncated: raise cell_cap")
    ate = trajectory.trajectory_ate(poses, golden, align=False)
    rpe = trajectory.trajectory_rpe(poses, golden)
    print(f"phase 5: ATE (unaligned) rmse {ate.rmse:.6f} m, max {ate.max:.6f} m; RPE "
          f"{rpe.trans_rmse:.6f} m, {rpe.rot_rmse:.3e} rad per step", flush=True)
    check(ate.rmse <= 0.03, f"path C ATE {ate.rmse} m over 0.03 m")
    device_breakdown("phase 5 (one ICP pair)",
                     lambda: icp(clouds[1], clouds[0], **ICP_KW))

    # scan 0 of the main path against the port's CPU run: the downsample
    # (B2 on the card, its plain version on the CPU) of the same raw scan ...
    ds = clouds[0]
    ds_cpu = filters.voxel_downsample(from_numpy(scans[0], capacity=SCAN_CAPACITY,
                                                 device="cpu"), LEAF)
    check(torch.equal(ds.mask.cpu(), ds_cpu.mask), "scan 0: live voxels differ from the CPU run")
    extent = float(np.abs(scans[0]).max())
    derr = float((ds.xyz.cpu() - ds_cpu.xyz).abs().max())
    check(derr <= 1e-5 * extent, f"scan 0: centroids differ from the CPU run by {derr} m")
    # ... and the normals of the card's cloud, on the CPU for 8192 voxels
    surf_cpu = Cloud(xyz=ds.xyz.cpu(), mask=ds.mask.cpu())
    cell, cap = search.auto_cell_params(surf_cpu, NORMAL_K)
    live = torch.nonzero(surf_cpu.mask)[:, 0]
    sub = live[:: max(1, len(live) // 8192)][:8192]
    query = surf_cpu.take(sub)
    on_cpu = features.estimate_normals(query, k=NORMAL_K, surface=surf_cpu, backend="cell",
                                       cell_size=cell, cell_cap=cap)
    n_card = ds.attrs["normal"].cpu()[sub]
    c_card = ds.attrs["curvature"].cpu()[sub]
    idx, d2n, valid = search.knn(surf_cpu, query.xyz, NORMAL_K + 1, backend="cell",
                                 cell_size=cell, cell_cap=cap)
    # A voxel whose 16th and 17th neighbours are equally far to float32
    # rounding has no one neighbourhood: which of the two a device takes
    # depends on how it rounds a squared distance (1e-5 of it at 60 m range),
    # and the host's CPU type decides that for the CPU run. Such voxels
    # (about one in a thousand) are counted and left out of the comparison.
    firm = (d2n[:, NORMAL_K] - d2n[:, NORMAL_K - 1]) > 1e-4 * d2n[:, NORMAL_K]
    idx, valid = idx[:, :NORMAL_K], valid[:, :NORMAL_K]
    nbr = surf_cpu.xyz[torch.clamp(idx.long(), 0, surf_cpu.capacity - 1)]
    _, cov, _ = geometry.mean_and_covariance(nbr, valid)
    lam = np.linalg.eigvalsh(cov.double().numpy())
    # eigenvectors are compared where lambda1 - lambda0 > 1e-3 lambda2, with
    # their sign (after the viewpoint flip); curvature to 1e-5 where all
    # eigenvalues are 1e-2 of lambda2 apart, 5e-4 elsewhere (the closed
    # form's arccos loses accuracy as two eigenvalues meet: the poles' thin
    # neighbourhoods)
    well = torch.from_numpy(lam[:, 1] - lam[:, 0] > 1e-3 * lam[:, 2]) & firm
    apart = torch.from_numpy(np.min(np.diff(lam, axis=1), axis=1) > 1e-2 * lam[:, 2])
    dots = (n_card * on_cpu.attrs["normal"]).sum(1)
    cerr = (c_card - on_cpu.attrs["curvature"]).abs()
    print(f"phase 5: scan 0 card vs CPU: {int(ds.mask.sum())} voxels equal, max |centroid "
          f"diff| {derr:.3e} m; normals of {len(sub)} voxels ({int((~firm).sum())} left out: "
          f"16th and 17th neighbour tie): min n.n' {float(dots[well].min()):.8f} "
          f"on {int(well.sum())} well-conditioned, max |curvature diff| "
          f"{float(cerr[apart & firm].max()):.3e} ({int((apart & firm).sum())} separated), "
          f"{float(cerr[firm].max()):.3e} (all)", flush=True)
    check(int((~firm).sum()) <= len(sub) // 100, "scan 0: too many neighbour ties left out")
    check(bool((dots[well] >= 1 - 1e-5).all()), "scan 0: normals differ from the CPU run")
    check(bool((cerr <= torch.where(apart, 1e-5, 5e-4))[firm].all()),
          "scan 0: curvature differs from the CPU run")

    # the whole chain with the plain segment sum on the card
    kernel_segsum = segsum.segment_sum_sorted
    segsum.segment_sum_sorted = segsum.segment_sum_sorted_plain
    try:
        _, plain_poses, plain_results = front_end(raw)
    finally:
        segsum.segment_sum_sorted = kernel_segsum
    pdiff = float(np.abs(plain_poses[:, :3, 3] - poses[:, :3, 3]).max())
    print(f"phase 5: chain with the plain segment sum: iterations "
          f"{[int(r.iterations) for r, _ in plain_results]} against "
          f"{[int(r.iterations) for r, _ in results]}, max |t - t_kernel| {pdiff:.3e} m",
          flush=True)
    check(pdiff <= 1e-4, f"plain-segsum chain poses differ by {pdiff} m")
    n_pairs = max(len(results), 1)
    return sum(t for _, t in results) * 1e3 / n_pairs, ate.rmse


def subsample(cloud, n):
    """Every k-th valid point of a cloud, at most ``n``, as a host array."""
    xyz = cloud.xyz[cloud.mask].cpu().numpy()
    return xyz[:: max(1, -(-len(xyz) // n))][:n]


def pose_gap(a: torch.Tensor, b: torch.Tensor):
    """Translation (m) and rotation (rad) between two 4x4 transforms."""
    a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
    R = a[:3, :3] @ b[:3, :3].T
    skew = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return (float(np.linalg.norm(a[:3, 3] - b[:3, 3])),
            math.atan2(np.linalg.norm(skew), 0.5 * (np.trace(R) - 1)))


def phase6_path_d(segsum, nn1_mod, scans, golden, alley, src, tgt, M, record_b1, record_b2):
    """Path D: the odometry command line's own flow, with GICP and NDT.
    ``alley`` is ``(scans, golden)`` of the street with alleys; ``src``,
    ``tgt``, ``M`` the noisy pair of paths A and B."""
    import pcl_tpu_torch.registration as registration
    from pcl_tpu_torch import filters, io
    from pcl_tpu_torch.core.cloud import from_numpy, make_cloud
    from pcl_tpu_torch.registration import trajectory
    from pcl_tpu_torch.registration.gicp import gicp, regularized_covariances
    from pcl_tpu_torch.registration.ndt import build_grid, ndt
    from pcl_tpu_torch.tools import odometry as odometry_tool
    from pcl_tpu_torch.tools import voxel_grid as voxel_grid_tool

    with tempfile.TemporaryDirectory() as tmp:
        # 1. the scans as binary_compressed PCD files, the poses in KITTI format
        raw_files = [os.path.join(tmp, f"scan{i}.pcd") for i in range(len(scans))]
        _, secs = timed(lambda: [io.save(f, from_numpy(s, capacity=SCAN_CAPACITY),
                                         data="binary_compressed")
                                 for f, s in zip(raw_files, scans)])
        golden_file = os.path.join(tmp, "golden.txt")
        odometry_tool._save_poses(golden_file, golden)
        raw, lsecs = timed(lambda: [io.load(f) for f in raw_files])
        size = sum(os.path.getsize(f) for f in raw_files)
        print(f"phase 6: {len(scans)} scans written as binary_compressed PCD in "
              f"{secs * 1e3:.1f} ms ({size / 1e6:.2f} MB for "
              f"{sum(s.nbytes for s in scans) / 1e6:.2f} MB of points), read back in "
              f"{lsecs * 1e3:.1f} ms", flush=True)
        for cloud, s in zip(raw, scans):
            check(bool(cloud.mask.all())
                  and torch.equal(cloud.xyz.cpu(), torch.from_numpy(s)),
                  "a scan read back from its PCD file differs from what was written")
        # poses are written with 9 significant digits
        check(np.abs(odometry_tool._load_poses(golden_file) - golden).max() <= 1e-7,
              "golden poses do not read back")

        # warm-up of both aligners (libraries, allocator), outside the counts
        warm = [make_cloud(subsample(c, 20_000)) for c in raw[:2]]
        gicp(warm[1], warm[0], **dict(GICP_KW, max_iterations=2))
        ndt(warm[1], warm[0], **dict(NDT_KW, max_iterations=2))

        trace.reset()

        # 2. tools.voxel_grid on each file: one B2 launch each
        ds_files = [os.path.join(tmp, f"ds{i}.pcd") for i in range(len(scans))]
        with contextlib.redirect_stdout(pyio.StringIO()) as out:
            _, secs = timed(lambda: [voxel_grid_tool.main([f, o, "-leaf", str(LEAF)])
                                     for f, o in zip(raw_files, ds_files)])
        print("phase 6: " + out.getvalue().strip().replace("\n", "; "), flush=True)
        b2_tool = launch_count("segsum")
        print(f"phase 6: tools.voxel_grid on {len(scans)} files in {secs * 1e3:.1f} ms "
              f"(load, downsample, save), segsum launches {b2_tool}", flush=True)
        check(b2_tool == len(scans), f"tools.voxel_grid launched B2 {b2_tool} times")
        clouds = [io.load(f) for f in ds_files]

        # 3. GICP odometry over the downsampled files, with the cell-list
        # arguments tools.odometry gives gicp: the covariance cells and both
        # caps from the host probe, measured on the hashed tables (some of the
        # ~8000 occupied cells of a scan share a bucket of 2^17)
        for i, c in enumerate(clouds):
            kw = odometry_tool.probed_cells(c, c, "gicp", GICP_KW["max_corr_dist"])
            (_, trunc), secs = timed(lambda: regularized_covariances(
                c.xyz, c.mask, GICP_K, cell_size=kw["cov_cell_size"],
                cell_cap=kw["cov_cell_cap"], with_trunc=True))
            print(f"phase 6: scan {i}: {c.capacity} voxels, covariance pass {secs * 1e3:.3f} ms "
                  f"(cell {kw['cov_cell_size']:.4f} m, cap {kw['cov_cell_cap']}, correspondence "
                  f"cap {kw['cell_cap']}, truncated {bool(trunc)}) [{card_line()}]", flush=True)
        index = {id(c): i for i, c in enumerate(clouds)}
        gicp_results = []

        def register_gicp(s, t):
            res, secs = timed(lambda: gicp(s, t, **GICP_KW, **odometry_tool.probed_cells(
                s, t, "gicp", GICP_KW["max_corr_dist"])))
            gicp_results.append((res, secs))
            return res

        poses, secs = timed(lambda: trajectory.odometry_sequence(clouds, register=register_gicp))
        for k, (res, t) in enumerate(gicp_results):
            it = int(res.iterations)
            print(f"phase 6: GICP pair {k + 1}->{k}: {t * 1e3:.3f} ms, {it} iterations "
                  f"({t * 1e3 / max(it, 1):.3f} ms per iteration, host probe and covariances "
                  f"included), "
                  f"converged {bool(res.converged)}, truncated {bool(res.truncated)}, fitness "
                  f"{float(res.fitness):.6f} [{card_line()}]", flush=True)
            check(bool(res.converged), f"path D GICP pair {k + 1} did not converge")
            check(not bool(res.truncated), f"path D GICP pair {k + 1} truncated")
        gicp_ate = trajectory.trajectory_ate(poses, golden, align=False)
        gicp_rpe = trajectory.trajectory_rpe(poses, golden)
        print(f"phase 6: GICP sequence {secs * 1e3:.1f} ms; ATE (unaligned) rmse "
              f"{gicp_ate.rmse:.6f} m, max {gicp_ate.max:.6f} m; RPE {gicp_rpe.trans_rmse:.6f} m, "
              f"{gicp_rpe.rot_rmse:.3e} rad per step", flush=True)
        check(gicp_ate.rmse <= 0.03, f"path D GICP ATE {gicp_ate.rmse} m over 0.03 m")

        # 4. NDT: each downsampled scan against the raw scan before it, from
        # an odometry prior (see NDT_PRIOR_ERROR)
        from scipy.spatial.transform import Rotation

        prior_rng = np.random.default_rng(6)
        priors, true_steps = [], []
        for k in range(1, len(scans)):
            step = np.linalg.inv(golden[k - 1]) @ golden[k]
            off = np.eye(4)
            d = np.append(prior_rng.normal(size=2), 0.0)
            axis = prior_rng.normal(size=3)
            off[:3, 3] = d * NDT_PRIOR_ERROR[0] / np.linalg.norm(d)
            off[:3, :3] = Rotation.from_rotvec(
                axis * NDT_PRIOR_ERROR[1] / np.linalg.norm(axis)).as_matrix()
            true_steps.append(step)
            priors.append(torch.tensor(off @ step, dtype=torch.float32))
        b2_before = launch_count("segsum")
        ndt_results = []

        def register_ndt(s, t, init):
            res, secs = timed(lambda: ndt(s, raw[index[id(t)]], init_transform=init, **NDT_KW))
            ndt_results.append((res, secs))
            return res

        poses, secs = timed(lambda: trajectory.odometry_sequence(
            clouds, register=register_ndt, init_deltas=priors))
        b2_ndt = launch_count("segsum") - b2_before
        for k, ((res, t), step) in enumerate(zip(ndt_results, true_steps)):
            it = int(res.iterations)
            left = res.transform.double().cpu().numpy() @ np.linalg.inv(step)
            rot = float(np.linalg.norm(Rotation.from_matrix(left[:3, :3]).as_rotvec()))
            print(f"phase 6: NDT pair {k + 1}->{k}: {t * 1e3:.3f} ms, {it} iterations "
                  f"({t * 1e3 / max(it, 1):.3f} ms per iteration, grid included), converged "
                  f"{bool(res.converged)}, score {float(res.score):.6f}; left of the prior's "
                  f"error: across the street and up {np.linalg.norm(left[:2, 3]):.4f} m, along "
                  f"{abs(left[2, 3]):.4f} m, rotation {rot:.2e} rad [{card_line()}]", flush=True)
            check(bool(res.converged), f"path D NDT pair {k + 1} did not converge")
            # under a third of the prior's error across the street (rehearsed on
            # the CPU: at most 0.005 m), a quarter in rotation (1.3e-4 rad)
            check(np.linalg.norm(left[:2, 3]) <= 0.015 and rot <= 5e-4,
                  f"path D NDT pair {k + 1} did not correct its prior")
        ndt_ate = trajectory.trajectory_ate(poses, golden, align=False)
        ndt_rpe = trajectory.trajectory_rpe(poses, golden)
        print(f"phase 6: NDT sequence (resolution {NDT_KW['resolution']} m, priors "
              f"{NDT_PRIOR_ERROR[0]} m and {NDT_PRIOR_ERROR[1]} rad off) {secs * 1e3:.1f} ms, "
              f"segsum launches {b2_ndt}; ATE (unaligned) rmse {ndt_ate.rmse:.6f} m, max "
              f"{ndt_ate.max:.6f} m; RPE {ndt_rpe.trans_rmse:.6f} m, {ndt_rpe.rot_rmse:.3e} rad "
              f"per step [{card_line()}]", flush=True)
        check(b2_ndt == len(scans) - 1, f"NDT launched B2 {b2_ndt} times for "
                                        f"{len(scans) - 1} grids")
        check(ndt_ate.rmse <= NDT_ATE_LIMIT, f"path D NDT ATE {ndt_ate.rmse} m over "
                                             f"{NDT_ATE_LIMIT} m")

        # 4b. NDT from the identity, where the scene lets it see every axis:
        # the street with alleys, each downsampled scan against the raw scan
        # before it (one B2 launch per downsample and one per grid)
        alley_scans, alley_golden = alley
        alley_raw = [from_numpy(a, capacity=SCAN_CAPACITY) for a in alley_scans]
        b2_before = launch_count("segsum")
        alley_ds = [filters.voxel_downsample(c, LEAF) for c in alley_raw]
        alley_index = {id(c): i for i, c in enumerate(alley_ds)}
        blind_results = []

        def register_blind(s, t):
            res, secs = timed(lambda: ndt(s, alley_raw[alley_index[id(t)]], **NDT_BLIND_KW))
            blind_results.append((res, secs))
            return res

        poses = trajectory.odometry_sequence(alley_ds, register=register_blind)
        b2_blind = launch_count("segsum") - b2_before
        for k, (res, t) in enumerate(blind_results):
            step = np.linalg.inv(alley_golden[k]) @ alley_golden[k + 1]
            left_t, left_r = pose_gap(res.transform, torch.from_numpy(step))
            print(f"phase 6: NDT from the identity, alley pair {k + 1}->{k}: {t * 1e3:.3f} ms, "
                  f"{int(res.iterations)} iterations, converged {bool(res.converged)}, score "
                  f"{float(res.score):.6f}; left of the {np.linalg.norm(step[:3, 3]):.3f} m step "
                  f"{left_t:.4f} m, {left_r:.2e} rad [{card_line()}]", flush=True)
            check(bool(res.converged), f"NDT from the identity: pair {k + 1} did not converge")
            check(left_t <= NDT_BLIND_STEP_LIMIT and left_r <= 1e-3,
                  f"NDT from the identity left {left_t} m, {left_r} rad of pair {k + 1}'s step")
        blind_ate = trajectory.trajectory_ate(poses, alley_golden, align=False)
        print(f"phase 6: NDT from the identity over {len(alley_scans)} alley scans: segsum "
              f"launches {b2_blind}; ATE (unaligned) rmse {blind_ate.rmse:.6f} m, max "
              f"{blind_ate.max:.6f} m", flush=True)
        check(b2_blind == 2 * len(alley_scans) - 1, f"alley NDT launched B2 {b2_blind} times")
        check(blind_ate.rmse <= NDT_BLIND_ATE_LIMIT,
              f"NDT from the identity: ATE {blind_ate.rmse} m over {NDT_BLIND_ATE_LIMIT} m")

        # 5. tools.odometry itself: the same probed cells, so the same poses
        tool_results = []
        plain_gicp = registration.gicp

        def recording_gicp(*a, **kw):
            tool_results.append(plain_gicp(*a, **kw))
            return tool_results[-1]

        registration.gicp = recording_gicp
        try:
            with contextlib.redirect_stdout(pyio.StringIO()) as out:
                rc, secs = timed(lambda: odometry_tool.main(
                    [*ds_files, "--method", "gicp", "--max-corr-dist", "1.0",
                     "--golden", golden_file]))
        finally:
            registration.gicp = plain_gicp
        line = out.getvalue().strip()
        found = re.search(r"rmse=(\S+) m \(unaligned\)", line)
        print(f"phase 6: tools.odometry --method gicp: return code {rc}, {secs * 1e3:.1f} ms; "
              f"{line}; truncated {[bool(r.truncated) for r in tool_results]}, iterations "
              f"{[int(r.iterations) for r in tool_results]}", flush=True)
        check(rc == 0 and len(tool_results) == len(scans) - 1, "tools.odometry failed")
        check(found is not None and float(found.group(1)) <= 0.03,
              "tools.odometry printed no ATE within 0.03 m")
        check(not any(bool(r.truncated) for r in tool_results), "tools.odometry truncated")
        tool_gap = max(pose_gap(a.transform, b.transform)[0]
                       for a, (b, _) in zip(tool_results, gicp_results))
        check(tool_gap <= 1e-6, f"tools.odometry and step 3 differ by {tool_gap} m")

    # 6. B1 through GICP: an infinite gate takes the brute branch. The noisy
    # pair of paths A and B cut to 8,192 points and moved further; what noise
    # of sigma leaves of a motion is about 5 sigma / sqrt(N) = 2.8e-3 m
    ang = math.radians(BRUTE_GICP_DEG)
    M2 = np.eye(4)
    M2[:3, :3] = [[math.cos(ang), 0, math.sin(ang)], [0, 1, 0], [-math.sin(ang), 0, math.cos(ang)]]
    M2[:3, 3] = BRUTE_GICP_T
    small_tgt = tgt[:BRUTE_GICP_POINTS]
    small_src = (src[:BRUTE_GICP_POINTS] @ M2[:3, :3].T + M2[:3, 3]).astype(np.float32)
    b1_before = launch_count("nn1")
    brute, secs = timed(lambda: gicp(make_cloud(small_src), make_cloud(small_tgt)))
    b1_gicp = launch_count("nn1") - b1_before
    dt, dang = residual_motion(brute.transform, M2 @ M)
    floor = 5 * NOISE / math.sqrt(BRUTE_GICP_POINTS)
    print(f"phase 6: brute GICP on {BRUTE_GICP_POINTS} noisy points: {int(brute.iterations)} "
          f"iterations in {secs * 1e3:.3f} ms, converged {bool(brute.converged)}, nn1 launches "
          f"{b1_gicp}; residual motion {dt:.2e} m (limit {floor:.2e}) {dang:.2e} deg", flush=True)
    check(b1_gicp == int(brute.iterations) >= 3,
          f"brute GICP launched B1 {b1_gicp} times in {int(brute.iterations)} iterations")
    check(bool(brute.converged) and dt <= floor and dang <= 0.01,
          f"brute GICP missed the motion: {dt} m, {dang} deg")

    # the main path's counts end here
    b1_d, b2_d = launch_count("nn1"), launch_count("segsum")
    check(b2_d == b2_tool + b2_ndt + b2_blind and b1_d == b1_gicp,
          "path D's launch counts do not add up")
    record_b1["launches_by_path"]["D"] = b1_d
    record_b2["launches_by_path"]["D"] = b2_d

    # 7. the card against the port's CPU run, one pair cut to 20,000 points
    # (poses, not covariances: neighbour ties decide single neighbourhoods).
    # NDT is compared after five iterations from its prior: later on an
    # iteration gains less than the float32 rounding of the score (1e-6 of
    # ~1e5), which then decides the Armijo test, so two devices take other
    # iterates through the last millimetre; the whole runs are printed.
    s20, t20 = subsample(clouds[1], CARD_VS_CPU_POINTS), subsample(clouds[0], CARD_VS_CPU_POINTS)
    runs = (("GICP", lambda s, t: gicp(s, t, **GICP_KW, **odometry_tool.probed_cells(
                s, t, "gicp", GICP_KW["max_corr_dist"])), True),
            ("NDT, 5 iterations", lambda s, t: ndt(s, t, init_transform=priors[0],
                                                   **dict(NDT_KW, max_iterations=5)), True),
            ("NDT, whole run", lambda s, t: ndt(s, t, init_transform=priors[0], **NDT_KW), False))
    for name, run, checked in runs:
        on_card, csecs = timed(lambda: run(make_cloud(s20), make_cloud(t20)))
        on_cpu, hsecs = timed(lambda: run(make_cloud(s20, device="cpu"),
                                          make_cloud(t20, device="cpu")))
        gap_t, gap_r = pose_gap(on_card.transform, on_cpu.transform)
        print(f"phase 6: {name} on {len(s20)} x {len(t20)} points, card {csecs * 1e3:.1f} ms "
              f"{int(on_card.iterations)} iterations, CPU {hsecs * 1e3:.1f} ms "
              f"{int(on_cpu.iterations)} iterations: |t - t_cpu| {gap_t:.3e} m, rotation "
              f"{gap_r:.3e} rad" + ("" if checked else " (printed, not checked)"), flush=True)
        if checked:
            check(gap_t <= 1e-3 and gap_r <= 1e-4,
                  f"{name} on the card disagrees with the CPU run: {gap_t} m, {gap_r} rad")

    # 8. where the time goes
    cells = odometry_tool.probed_cells(clouds[1], clouds[0], "gicp", GICP_KW["max_corr_dist"])
    device_breakdown("phase 6 (one GICP pair, probed cells given)",
                     lambda: gicp(clouds[1], clouds[0], **cells, **GICP_KW))
    device_breakdown("phase 6 (one NDT pair)", lambda: ndt(clouds[1], raw[0], **NDT_KW))
    blind, secs = timed(lambda: ndt(clouds[1], raw[0], **NDT_KW))
    left = blind.transform.double().cpu().numpy() @ np.linalg.inv(true_steps[0])
    print(f"phase 6: NDT pair 1->0 from the identity (no prior; printed, not checked): "
          f"{int(blind.iterations)} iterations in {secs * 1e3:.1f} ms, converged "
          f"{bool(blind.converged)}; left of the {np.linalg.norm(true_steps[0][:3, 3]):.3f} m "
          f"step: across the street and up {np.linalg.norm(left[:2, 3]):.4f} m, along "
          f"{abs(left[2, 3]):.4f} m", flush=True)
    grid, secs = timed(lambda: build_grid(raw[0].xyz, raw[0].mask, NDT_KW["resolution"]))
    print(f"phase 6: one NDT grid of scan 0 ({SCAN_CAPACITY} points, resolution "
          f"{NDT_KW['resolution']} m): {secs * 1e3:.3f} ms, {int(grid.valid.sum())} valid "
          f"voxels [{card_line()}]", flush=True)
    n_pairs = len(scans) - 1
    return (sum(t for _, t in gicp_results) * 1e3 / n_pairs, gicp_ate.rmse,
            sum(t for _, t in ndt_results) * 1e3 / n_pairs, ndt_ate.rmse)


def pose_matrix(forward: float, deg: float) -> np.ndarray:
    """A scanner pose ``forward`` m along z and turned ``deg`` about y (up)."""
    a = math.radians(deg)
    P = np.eye(4)
    P[:3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0], [-math.sin(a), 0, math.cos(a)]]
    P[2, 3] = forward
    return P


def scan_at(scene: np.ndarray, pose: np.ndarray, rng) -> np.ndarray:
    """One scan of ``scene`` from a scanner at ``pose`` (scan frame to scene
    frame), cut as ``make_virtual_scan_sequence`` cuts its scans: the view
    frustum, ``SCAN_CAPACITY`` points drawn without replacement, range
    noise."""
    kw = SEQUENCE_KW
    inv = np.linalg.inv(pose)
    s = scene @ inv[:3, :3].T + inv[:3, 3]
    z = s[:, 2]
    fov = kw["fov_tan"]
    vis = (z > kw["z_range"][0]) & (z < kw["z_range"][1]) \
        & (np.abs(s[:, 0]) <= fov * z) & (np.abs(s[:, 1]) <= fov * z)
    s = s[vis]
    s = s[rng.choice(len(s), kw["max_points"], replace=False)]
    return (s + rng.normal(scale=kw["noise"], size=s.shape)).astype(np.float32)


def live_rows(cloud):
    """The valid rows of a cloud, as a cloud of that many rows."""
    return cloud.take(torch.nonzero(cloud.mask)[:, 0])


def fpfh_k(cloud, radius: float = E_FPFH_RADIUS) -> int:
    """k for FPFH from the cloud's density: the median number of points
    within ``radius`` of 2,000 sampled points (host kd-tree), within
    [16, 64]."""
    from scipy.spatial import cKDTree

    x = cloud.xyz[cloud.mask].cpu().numpy()
    counts = cKDTree(x).query_ball_point(x[:: max(1, len(x) // 2000)], radius,
                                         return_length=True)
    return int(np.clip(np.median(counts), 16, 64))


def global_front(cloud, k=None, log=None):
    """Path E's chain for one scan: the ground plane by RANSAC, removed;
    voxel_downsample (kernel B2) of the rest to its live voxels;
    estimate_normals (host probe, cell list); estimate_fpfh (brute). Returns
    (cloud with normals, descriptors, plane result, FPFH k, stage seconds)."""
    from pcl_tpu_torch import features, filters, sac, segmentation

    secs = {}
    seg, secs["ground"] = timed(lambda: segmentation.sac_segmentation(
        cloud, sac.PlaneModel(), E_GROUND_THRESHOLD))
    rest = cloud.with_mask(~seg.inliers)
    ds, secs["downsample"] = timed(lambda: live_rows(filters.voxel_downsample(rest, E_LEAF)))
    nc, secs["normals"] = timed(lambda: features.estimate_normals(ds, k=NORMAL_K))
    if k is None:
        k, secs["k probe"] = timed(lambda: fpfh_k(nc))
    f, secs["fpfh"] = timed(lambda: features.estimate_fpfh(nc, k=k))
    if log:
        print(f"{log}: ground inliers {int(seg.num_inliers)} of {int(cloud.mask.sum())}, "
              f"{nc.capacity} voxels, FPFH k {k}; "
              + ", ".join(f"{n} {t * 1e3:.3f} ms" for n, t in secs.items())
              + f" [{card_line()}]", flush=True)
    return nc, f, seg, k, secs


def plane_error(coeffs) -> tuple:
    """Angle (rad) between a plane's normal and the up axis, and its offset's
    distance from the ground's (y = -1.7 m: n = (0, 1, 0), d = 1.7)."""
    c = coeffs.double().cpu().numpy()
    c = c * np.sign(c[1])
    return math.atan2(math.hypot(c[0], c[2]), c[1]), abs(c[3] - 1.7)


def chain_c(src, fs, tgt, ft):
    """Aligner (c), the rejector chain: feature 1-NN correspondences (the
    feature distance as sqdist), one-to-one, sample consensus over a rigid
    model, then the closed form on the inliers."""
    from pcl_tpu_torch.registration import Correspondences, estimate_svd, feature_knn, rejection

    # reject_one_to_one keeps one segment per source row: a target index past
    # the source's capacity would be dropped (ROADMAP C18), so the source is
    # padded to the target's capacity first
    if src.capacity < tgt.capacity:
        fs = torch.cat([fs, fs.new_zeros(tgt.capacity - src.capacity, fs.shape[1])])
        src = src.pad_to(tgt.capacity)
    idx = feature_knn(fs, src.mask, ft, tgt.mask, 1)[:, 0]
    d2 = torch.sum((fs - ft[idx.long()]) ** 2, dim=-1)
    c = Correspondences(idx, d2, src.mask & tgt.mask[idx.long()])
    n0 = int(c.valid.sum())
    c = rejection.reject_one_to_one(c)
    n1 = int(c.valid.sum())
    c = rejection.reject_sample_consensus(c, src.xyz, tgt.xyz, E_INLIER, **E_CHAIN_KW)
    n2 = int(c.valid.sum())
    matched = tgt.xyz[torch.clamp(c.index.long(), 0, tgt.capacity - 1)]
    T = estimate_svd(src.xyz, matched, c.valid.to(torch.float32))
    fit = torch.linalg.vector_norm(src.xyz @ T[:3, :3].T + T[:3, 3] - matched, dim=-1)
    return T, (n0, n1, n2), float(fit[c.valid].mean()) if n2 else float("inf")


def phase7_path_e(segsum, nn1_mod, street, record_b1, record_b2):
    """Path E: feature-based global registration of two scans of the street
    10 m apart (PLY files, ground removal, FPFH, three global aligners, ICP,
    validation)."""
    from pcl_tpu_torch import features, io, search
    from pcl_tpu_torch.core import geometry
    from pcl_tpu_torch.core.cloud import Cloud, make_cloud
    from pcl_tpu_torch.core.transforms import transform_points
    from pcl_tpu_torch.registration import ia, icp, validate_euclidean
    from pcl_tpu_torch.search import bruteforce, hashgrid
    from pcl_tpu_torch.tools.odometry import probed_cells

    failed = []

    def expect(cond: bool, what: str) -> None:
        """A check of this phase, raised with the others at its end."""
        if not cond:
            print(f"phase 7: CHECK FAILED: {what}", flush=True)
            failed.append(what)

    rng = np.random.default_rng(E_SEED)
    P = pose_matrix(*E_POSE)
    scans = [scan_at(street, np.eye(4), rng), scan_at(street, P, rng)]
    with tempfile.TemporaryDirectory() as tmp:
        files = [os.path.join(tmp, f"e{i}.ply") for i in range(2)]
        _, wsecs = timed(lambda: [io.save(f, make_cloud(s)) for f, s in zip(files, scans)])
        raw, rsecs = timed(lambda: [io.load(f) for f in files])
        print(f"phase 7: two scans ({[len(s) for s in scans]} points, the second "
              f"{E_POSE[0]} m on and {E_POSE[1]} deg about y) written as binary PLY in "
              f"{wsecs * 1e3:.1f} ms ({sum(os.path.getsize(f) for f in files) / 1e6:.2f} MB), "
              f"read back in {rsecs * 1e3:.1f} ms", flush=True)
    for cloud, s in zip(raw, scans):
        expect(bool(cloud.mask.all()) and torch.equal(cloud.xyz.cpu(), torch.from_numpy(s)),
              "a scan read back from its PLY file differs from what was written")

    # warm-up of the stages (libraries, allocator) on a quarter of scan 0
    global_front(make_cloud(scans[0][::4]), k=16)

    trace.reset()
    (tgt, ft, seg0, k, secs0) = global_front(raw[0], log="phase 7: scan 0 (target)")
    (src, fs, seg1, _, secs1) = global_front(raw[1], k=k, log="phase 7: scan 1 (source)")
    b2 = launch_count("segsum")
    for i, seg in enumerate((seg0, seg1)):
        ang, off = plane_error(seg.coefficients)
        print(f"phase 7: scan {i} ground plane: normal {ang:.3e} rad from up, offset "
              f"{off:.3e} m from 1.7 m, valid {bool(seg.valid)}", flush=True)
        expect(bool(seg.valid) and ang <= E_PLANE_LIMITS[0] and off <= E_PLANE_LIMITS[1],
              f"scan {i}: ground plane {ang} rad, {off} m off y = -1.7 m")
    expect(b2 == 2, f"path E launched B2 {b2} times for two downsamples")

    def residual(T):
        """Translation across the street and up, along it (m), rotation (rad)
        left of the motion, in scan 0's frame (x across, y up, z along)."""
        d = T.double().cpu().numpy()[:3, 3] - P[:3, 3]
        return math.hypot(d[0], d[1]), abs(d[2]), pose_gap(T, torch.from_numpy(P))[1]

    # keypoints: the aligners sample, match and score the voxels of high
    # curvature (FPFH of a facade voxel is that of every other facade voxel)
    skp, tkp = (c.with_mask(c.attrs["curvature"] > E_KEYPOINT_CURVATURE) for c in (src, tgt))
    print(f"phase 7: keypoints (curvature > {E_KEYPOINT_CURVATURE}): source "
          f"{int(skp.mask.sum())} of {src.capacity}, target {int(tkp.mask.sum())} of "
          f"{tgt.capacity}", flush=True)
    results = {}
    b1 = {}
    for name, run in (
            ("a prerejective", lambda: ia.prerejective_ransac(skp, fs, tkp, ft, **E_PRE_KW)),
            ("b sac_ia", lambda: ia.sac_ia(skp, fs, tkp, ft, **E_IA_KW)),
            ("c rejector chain", lambda: chain_c(skp, fs, tkp, ft))):
        before = launch_count("nn1")
        out, gsecs = timed(run)
        b1[name] = launch_count("nn1") - before
        T = out[0] if name.startswith("c") else out.transform
        ga, gz, gr = residual(T)
        cells = probed_cells(src, tgt, "icp", E_ICP_KW["max_corr_dist"])
        ref, isecs = timed(lambda: icp(src, tgt, init_transform=T, **E_ICP_KW, **cells))
        ra, rz, rr = residual(ref.transform)
        pl, lsecs = timed(lambda: icp(src, tgt, init_transform=T, variant="point_to_plane",
                                      **E_ICP_KW, **cells))
        la, lz, lr = residual(pl.transform)
        results[name] = (T, ref, pl)
        extra = (f"correspondences {out[1]} (feature 1-NN, one-to-one, consensus)"
                 if name.startswith("c") else
                 f"valid {bool(out.valid)}, score {float(out.error):.6f}")
        print(f"phase 7: ({name}) {gsecs * 1e3:.3f} ms, {extra}, nn1 launches {b1[name]}; "
              f"left of the motion: across and up {ga:.3e} m, along {gz:.3e} m, {gr:.3e} rad; "
              f"ICP {isecs * 1e3:.3f} ms, {int(ref.iterations)} iterations, code "
              f"{int(ref.convergence_state)}, truncated {bool(ref.truncated)}: left across and "
              f"up {ra:.3e} m, along {rz:.3e} m, {rr:.3e} rad; point-to-plane ICP "
              f"{lsecs * 1e3:.3f} ms, {int(pl.iterations)} iterations, code "
              f"{int(pl.convergence_state)}: left {la:.3e} m, {lz:.3e} m, {lr:.3e} rad "
              f"[{card_line()}]", flush=True)
        # along the street ICP creeps (ROADMAP C22): it may end by its
        # iteration limit; truncation would make its matches non-nearest
        expect(not bool(ref.truncated) and not bool(pl.truncated), f"({name}) ICP truncated")
        if name.startswith("c"):
            # the chain scores feature matches only: on this street of
            # identical cars and poles its largest consensus is an alias of
            # the motion (PERF.md, path E), so it is held to what it computes,
            # a rigid model that fits the consensus it kept
            expect(out[1][2] >= 3 and out[2] <= E_INLIER,
                   f"({name}) consensus of {out[1][2]} pairs fit to {out[2]} m")
            print(f"phase 7: ({name}) consensus pairs fit the model to {out[2]:.3e} m on "
                  f"average; the motion is {'' if math.hypot(ga, gz) <= E_BASIN[0] else 'not '}"
                  f"in ICP's basin from it (printed, not checked)", flush=True)
            continue
        expect(bool(out.valid), f"({name}) found no valid hypothesis")
        expect(math.hypot(ga, gz) <= E_BASIN[0] and gr <= E_BASIN[1],
               f"({name}) left {ga} m, {gz} m, {gr} rad: outside ICP's basin")
        expect(ra <= E_REFINED[0] and rz <= E_REFINED[1] and rr <= E_REFINED[2],
               f"({name}) refined pose left {ra} m across and up, {rz} m along, {rr} rad")
        expect(la <= E_REFINED_P2L[0] and lz <= E_REFINED_P2L[1] and lr <= E_REFINED_P2L[2],
               f"({name}) point-to-plane pose left {la} m across and up, {lz} m along, {lr} rad")
    expect(b1["a prerejective"] >= 1 and b1["b sac_ia"] >= 1,
          f"the aligners' scoring did not launch B1: {b1}")
    gaps = [pose_gap(results["a prerejective"][i].transform, results["b sac_ia"][i].transform)[0]
            for i in (1, 2)]
    print(f"phase 7: the refined poses of (a) and (b) agree to {gaps[0]:.3e} m (point-to-point), "
          f"{gaps[1]:.3e} m (point-to-plane)", flush=True)

    T_ref = results["a prerejective"][1].transform
    for T, name, accept in ((T_ref, "refined", True), (torch.eye(4), "identity", False)):
        v, vsecs = timed(lambda: validate_euclidean(src, tgt, T.to(src.xyz.device),
                                                    **E_VALIDATE_KW))
        print(f"phase 7: validate_euclidean of the {name} pose: score {float(v.score):.6f}, "
              f"inliers {int(v.num_inliers)}, valid {bool(v.is_valid)}, {vsecs * 1e3:.3f} ms",
              flush=True)
        expect(bool(v.is_valid) == accept, f"validate_euclidean judged the {name} pose wrongly")
    record_b1["launches_by_path"]["E"] = launch_count("nn1")
    record_b2["launches_by_path"]["E"] = launch_count("segsum")

    # hash-grid FPFH against brute FPFH on scan 0, where no probed bucket is
    # truncated and the k-th neighbour lies within the cell. At path E's k a
    # cell holds more than the backend's 32 slots nearly everywhere, so the
    # two backends are held to each other at k = E_HASH_K, cells from the
    # host probe
    kh = E_HASH_K
    cell = search.auto_cell_params(tgt, kh)[0]
    hf, hsecs = timed(lambda: features.estimate_fpfh(tgt, k=kh, backend="hashgrid",
                                                     cell_size=cell))
    bf = features.estimate_fpfh(tgt, k=kh)
    grid = hashgrid.build(tgt.xyz, tgt.mask, cell)
    hidx, _, _, trunc = hashgrid.knn(grid, tgt.xyz, kh)
    bidx, bd2, _ = bruteforce.knn(tgt.xyz, tgt.mask, tgt.xyz, kh)
    firm = (~trunc) & (bd2[:, -1] < cell * cell) & torch.all(
        torch.sort(hidx, dim=1)[0] == torch.sort(bidx, dim=1)[0], dim=1)
    firm = firm & torch.all(firm[bidx.long()], dim=1)      # FPFH mixes the neighbours' rows
    # the same neighbours, but the brute distances are the matmul identity
    # (rounding ~4 ulp of |q|^2 + |t|^2, ROADMAP C1) where the hash grid takes
    # differences; FPFH weighs a neighbour by 1 / d^2, so a bin of a block of
    # 100 may move by 200 times the worst relative error of a weight
    sq = torch.sum(tgt.xyz * tgt.xyz, dim=1)
    rel = 4 * 2.0 ** -24 * (sq[:, None] + sq[bidx.long()]) / torch.clamp(bd2, min=1e-12)
    rel = torch.where(bd2 > 0, rel, 0.0).amax(dim=1)
    tol = 1e-3 + 200.0 * torch.maximum(rel, rel[bidx.long()].amax(dim=1))
    excess = ((hf - bf).abs().amax(dim=1) - tol)[firm]
    herr = float((hf - bf)[firm].abs().max()) if bool(firm.any()) else float("inf")
    tmax = float(tol[firm].max()) if bool(firm.any()) else float("nan")
    print(f"phase 7: hash-grid FPFH at k {kh} (cell {cell:.4f} m, {hsecs * 1e3:.3f} ms): "
          f"{int(trunc.sum())} of {tgt.capacity} points truncated, {int(firm.sum())} compared, "
          f"max |hash - brute| {herr:.3e} (largest tolerance {tmax:.3e})", flush=True)
    expect(int(firm.sum()) >= E_HASH_MIN_SHARE * tgt.capacity and bool((excess <= 0).all()),
          "hash-grid FPFH differs from brute FPFH beyond the distances' rounding")

    # B1 at this shape: the queries of (a), timed beside the bound
    sidx, pick, sub = ia.draw_ia_samples(skp.mask, E_PRE_KW["n_hypotheses"], 3, 5, 1024)
    cand = ia.feature_knn(fs, skp.mask, ft, tkp.mask, 5)
    src_s, tgt_s = ia._matched_samples(skp, tkp, cand, sidx, pick)
    Ts = geometry.umeyama(src_s, tgt_s, torch.ones(src_s.shape[:2], device=src_s.device))
    q = transform_points(Ts, src.xyz[sub.long()]).reshape(-1, 3).contiguous()
    ms = cuda_ms(lambda: nn1_mod.nn1(tkp.xyz, tkp.mask, q), reps=5)
    bound_s, bound_by = nn1_bound_ms(len(q), tgt.capacity)
    slots = nn1_mod.device_slots(torch.cuda.current_device())
    print(f"phase 7: nn1 at path E's shape {len(q)} x {tgt.capacity}: {ms:.3f} ms, bound "
          f"{bound_s * 1e3:.3f} ms ({bound_by}), (slices, slice length) "
          f"{nn1_mod.nn1_plan(len(q), tgt.capacity, slots)} [{card_line()}]", flush=True)
    device_breakdown("phase 7 (prerejective_ransac)",
                     lambda: ia.prerejective_ransac(skp, fs, tkp, ft, **E_PRE_KW))
    record_b1["path_e"] = {"q": len(q), "m": tgt.capacity, "ms": ms,
                           "bound_ms": bound_s * 1e3, "bound_by": bound_by}

    # (a) with the plain 1-NN (at the JAX default count of hypotheses: the
    # plain sweep's time grows as Q M): the same best hypothesis
    few = dict(E_PRE_KW, n_hypotheses=E_PLAIN_HYPOTHESES)
    with_kernel, ksecs = timed(lambda: ia.prerejective_ransac(skp, fs, tkp, ft, **few))
    kernel_nn1 = bruteforce.nn1
    bruteforce.nn1 = nn1_mod.nn1_plain
    try:
        plain, psecs = timed(lambda: ia.prerejective_ransac(skp, fs, tkp, ft, **few))
    finally:
        bruteforce.nn1 = kernel_nn1
    pdiff = float((plain.transform - with_kernel.transform).abs().max())
    print(f"phase 7: (a) with {E_PLAIN_HYPOTHESES} hypotheses: kernel {ksecs * 1e3:.1f} ms, "
          f"plain nn1 {psecs * 1e3:.1f} ms, scores {float(with_kernel.error):.6f} / "
          f"{float(plain.error):.6f}, max |T - T_kernel| {pdiff:.3e}", flush=True)
    expect(pdiff <= 1e-6, f"(a) with plain nn1 chose another hypothesis ({pdiff})")

    # the card against the port's CPU run on a 20k subset, the same samples
    n = min(CARD_VS_CPU_POINTS, src.capacity, tgt.capacity)
    s20, t20 = skp.take(torch.arange(n, device=src.xyz.device)), \
        tkp.take(torch.arange(n, device=tgt.xyz.device))
    fs20, ft20 = fs[:n], ft[:n]
    g = torch.Generator().manual_seed(E_SEED)
    draws = ia.draw_ia_samples(s20.mask.cpu(), 256, 3, 5, 128, g)
    cand = ia.feature_knn(fs20, s20.mask, ft20, t20.mask, 5)
    cand_cpu = ia.feature_knn(fs20.cpu(), s20.mask.cpu(), ft20.cpu(), t20.mask.cpu(), 5)
    on_card = ia.prerejective_scores(s20, t20, cand, *(d.to(s20.xyz.device) for d in draws),
                                     inlier_threshold=E_INLIER)
    on_cpu = ia.prerejective_scores(*(Cloud(xyz=c_.xyz.cpu(), mask=c_.mask.cpu())
                                      for c_ in (s20, t20)), cand.cpu(), *draws,
                                    inlier_threshold=E_INLIER)
    best_card, best_cpu = int(torch.argmax(on_card[1])), int(torch.argmax(on_cpu[1]))
    tdiff = float((on_card[0][best_card].cpu() - on_cpu[0][best_cpu]).abs().max())
    sc_card, sc_cpu = on_card[1].cpu(), on_cpu[1]
    expect(torch.equal(torch.isfinite(sc_card), torch.isfinite(sc_cpu)),
          "card and CPU prerejected other hypotheses")
    fin = torch.isfinite(sc_cpu)
    sdiff = float((sc_card[fin] - sc_cpu[fin]).abs().max()) if bool(fin.any()) else 0.0
    print(f"phase 7: prerejective core on {n} x {n} points, card against CPU: feature kNN "
          f"rows differing {int((cand.cpu() != cand_cpu).any(1).sum())}; best hypothesis "
          f"{best_card} / {best_cpu}, max |T - T_cpu| {tdiff:.3e}, max |score diff| "
          f"{sdiff:.3e}", flush=True)
    expect(best_card == best_cpu and tdiff <= 1e-4,
          "the prerejective core on the card disagrees with the CPU run")
    check(not failed, "path E: " + "; ".join(failed))
    return {k_: secs0[k_] + secs1[k_] for k_ in secs0 if k_ in secs1}


def route_pose(x: float, z: float, deg: float) -> np.ndarray:
    """A scanner pose at (x, 0, z) of the street turned ``deg`` about y (up)."""
    P = pose_matrix(z, deg)
    P[0, 3] = x
    return P


def random_twist(rng, trans: float, rot: float) -> np.ndarray:
    """exp of a twist of ``trans`` m and ``rot`` rad about random directions."""
    from scipy.spatial.transform import Rotation

    T = np.eye(4)
    d, a = rng.normal(size=3), rng.normal(size=3)
    T[:3, 3] = d * trans / np.linalg.norm(d)
    T[:3, :3] = Rotation.from_rotvec(a * rot / np.linalg.norm(a)).as_matrix()
    return T


def drifted(golden, rng, trans: float, rot: float):
    """Odometry poses: the golden steps, each followed by a random error of
    ``trans`` m and ``rot`` rad, accumulated from the exact first pose."""
    out = [np.asarray(golden[0], np.float64)]
    for k in range(1, len(golden)):
        out.append(out[-1] @ np.linalg.inv(golden[k - 1]) @ golden[k]
                   @ random_twist(rng, trans, rot))
    return np.stack(out)


def moved(pts: np.ndarray, T: np.ndarray) -> np.ndarray:
    return (pts @ T[:3, :3].T + T[:3, 3]).astype(np.float32)


def axis_rms(poses, golden):
    """RMS translation error of each pose in its golden scan frame: across
    the street, up, along it (m)."""
    e = np.stack([np.linalg.inv(g) @ p for p, g in zip(poses, golden)])[:, :3, 3]
    return tuple(round(float(x), 4) for x in np.sqrt(np.mean(e * e, axis=0)))


def kitti_graph(V: int, n_loops: int, C: int, seed: int):
    """A pose graph of KITTI sequence 00's length: V poses 1 m apart on four
    laps of a circle (0.5 m up and down), consecutive edges plus ``n_loops``
    seeded edges between laps; C correspondences an edge, points within 15 m
    of the first pose seen from both true poses plus F_KITTI_NOISE of noise.
    Returns (golden [V,4,4], drifted initial poses [V,4,4] float32, edge
    tensors as ``lum`` takes them, on the card)."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    lap = V // 4
    radius = lap / (2 * np.pi)
    th = np.arange(V) / radius
    G = np.tile(np.eye(4), (V, 1, 1))
    G[:, :3, :3] = Rotation.from_rotvec(np.outer(th, [0, 1, 0])).as_matrix()
    G[:, 0, 3] = radius * np.sin(th)
    G[:, 1, 3] = 0.5 * np.sin(np.arange(V) / 50.0)
    G[:, 2, 3] = radius * (1 - np.cos(th))
    first = rng.integers(0, V - lap - 3, n_loops)
    es = np.concatenate([np.arange(V - 1), first])
    ed = np.concatenate([np.arange(1, V), first + lap + rng.integers(-2, 3, n_loops)])
    p = rng.uniform([-15, -2, -15], [15, 5, 15], size=(len(es), C, 3))
    rel = np.linalg.inv(G[ed]) @ G[es]                      # frame i -> frame j
    q = np.einsum("eab,ecb->eca", rel[:, :3, :3], p) + rel[:, None, :3, 3]
    q += rng.normal(scale=F_KITTI_NOISE, size=q.shape)
    init = drifted(G, rng, *F_KITTI_DRIFT)
    dev = torch.device("cuda")
    edges = (torch.from_numpy(es.astype(np.int32)).to(dev),
             torch.from_numpy(ed.astype(np.int32)).to(dev),
             torch.from_numpy(p.astype(np.float32)).to(dev),
             torch.from_numpy(q.astype(np.float32)).to(dev),
             torch.ones(len(es), C, dtype=torch.bool, device=dev))
    return G, init.astype(np.float32), edges


def small_graph(V: int = 8, C: int = 256, seed: int = 14):
    """V scans of one scene along a chain of random steps with one loop edge:
    correspondences are scene points seen from both true poses plus 0.01 m
    of noise; initial poses a few cm and 0.01 rad off."""
    rng = np.random.default_rng(seed)
    true = [np.eye(4)]
    for _ in range(V - 1):
        true.append(true[-1] @ random_twist(rng, 0.5, 0.1))
    scene = rng.normal(scale=3.0, size=(1000, 3))
    pairs = []
    for i, j in [(k, k + 1) for k in range(V - 1)] + [(0, V - 1)]:
        p = scene[rng.choice(len(scene), C, replace=False)]
        pairs.append((i, j, moved(p, np.linalg.inv(true[i])),
                      moved(p, np.linalg.inv(true[j])) + rng.normal(scale=0.01, size=p.shape)
                      .astype(np.float32)))
    init = np.stack([true[0]] + [random_twist(rng, 0.05, 0.01) @ t for t in true[1:]])
    return init.astype(np.float32), pairs, C


def phase8_path_f(segsum, nn1_mod, street, record_b1, record_b2):
    """Path F: pose-graph alignment of a closed route of street scans (LUM in
    tools.lum's flow, with CG, ELCH, tools.lum itself), a graph of KITTI
    sequence 00's length, and the card against the CPU."""
    from pcl_tpu_torch import filters, io
    from pcl_tpu_torch.core.cloud import make_cloud
    from pcl_tpu_torch.core.transforms import transform_points
    from pcl_tpu_torch.registration import trajectory
    from pcl_tpu_torch.registration.graph import (build_edges_from_correspondences,
                                                  elch_distribute, lum)
    from pcl_tpu_torch.registration.icp import icp
    from pcl_tpu_torch.tools import lum as lum_tool

    failed = []

    def expect(cond: bool, what: str) -> None:
        if not cond:
            print(f"phase 8: CHECK FAILED: {what}", flush=True)
            failed.append(what)

    rng = np.random.default_rng(F_SEED)
    golden = np.stack([route_pose(0.0, F_STEP * k, 0.0) for k in range(F_OUT)]
                      + [route_pose(F_BACK[0], F_STEP * (2 * F_OUT - 1 - k), F_BACK[1])
                         for k in range(F_OUT, 2 * F_OUT)])
    V = len(golden)
    end_t, end_r = pose_gap(torch.from_numpy(golden[-1]), torch.from_numpy(golden[0]))
    scans = [scan_at(street, g, rng) for g in golden]
    init = drifted(golden, rng, *F_DRIFT)
    dt, dr = pose_gap(torch.from_numpy(init[-1]), torch.from_numpy(golden[-1]))
    print(f"phase 8: route of {V} scans of {SCAN_CAPACITY} points, {F_OUT} out at {F_STEP} m "
          f"steps and {F_OUT} back ({F_BACK[0]} m across, {F_BACK[1]} deg); last scan "
          f"{end_t:.3f} m and {math.degrees(end_r):.2f} deg from the first; drift at the loop's "
          f"end {dt:.4f} m, {dr:.5f} rad", flush=True)
    expect(end_t <= 1.0 and math.degrees(end_r) <= 5.0, "the route does not close")

    ate0 = trajectory.trajectory_ate(init, golden, align=False).rmse
    warm = filters.voxel_downsample(make_cloud(scans[0]), F_LEAF)        # warm-up
    warm_pairs = lum_tool.correspondence_pairs([warm.xyz[warm.mask].cpu().numpy()] * 2, 1.0,
                                               1.0, 64, "cuda", log=lambda s: None)
    lum(torch.eye(4, device="cuda").repeat(2, 1, 1),
        *build_edges_from_correspondences(warm_pairs, 64))
    trace.reset()
    voxels, secs = timed(lambda: [live_rows(filters.voxel_downsample(make_cloud(s), F_LEAF))
                                  for s in scans])
    local = [v.xyz.cpu().numpy() for v in voxels]
    print(f"phase 8: voxel_downsample({F_LEAF}) of {V} scans in {secs * 1e3:.1f} ms: "
          f"{min(len(p) for p in local)}-{max(len(p) for p in local)} voxels", flush=True)

    # (a) LUM in tools.lum's flow, rounds of correspondences at the current poses
    poses = init.copy()
    kw = dict(loop_dist=F_LUM["loop_dist"], corr_dist=F_GATES[0], max_corr=F_LUM["max_corr"])
    history = [ate0]
    for rnd, gate in enumerate(F_GATES):
        world = [moved(p, T) for p, T in zip(local, poses)]
        pairs, edges_t = timed(lambda: lum_tool.correspondence_pairs(
            world, device="cuda", log=lambda s: None, **dict(kw, corr_dist=gate)))
        loops = [(i, j) for i, j, _, _ in pairs if j != i + 1]
        edges = build_edges_from_correspondences(pairs, kw["max_corr"])
        eye = torch.eye(4, device="cuda").repeat(V, 1, 1)
        res, lsecs = timed(lambda: lum(eye, *edges, max_iterations=F_LUM["iter"]))
        corr = res.poses.double().cpu().numpy()
        if rnd == 0:
            first_round = (world, res, edges)
        poses = np.einsum("vij,vjk->vik", corr, poses)
        history.append(trajectory.trajectory_ate(poses, golden, align=False).rmse)
        print(f"phase 8: (a) round {rnd + 1}, gate {gate} m: {len(pairs)} edges ({len(loops)} not "
              f"consecutive, e.g. {loops[:4]}), correspondences {edges_t * 1e3:.1f} ms, lum "
              f"{lsecs * 1e3:.1f} ms for {int(res.iterations)} iterations, residual "
              f"{float(res.residual):.6f} m^2; ATE {history[-1]:.4f} m", flush=True)
        if rnd == 0:
            expect(bool(loops), "no loop edge besides consecutive ones")
            expect((0, V - 1) in loops, "the loop's ends share no edge")
    axes0, axes = (axis_rms(P, golden) for P in (init, poses))
    print(f"phase 8: (a) RMS error across the street, up, along it: drifted {axes0} m, after "
          f"{axes} m", flush=True)
    print(f"phase 8: (a) ATE (unaligned) drifted {ate0:.4f} m -> after {len(F_GATES)} rounds "
          f"{history[-1]:.4f} m ({history[-1] / ate0:.3f} of it); by round {history[1:]} "
          f"[{card_line()}]", flush=True)
    expect(history[-1] <= F_ATE_LIMIT, f"LUM left ATE {history[-1]} m (limit {F_ATE_LIMIT} m)")
    expect(axes[1] <= F_UP_LIMIT, f"LUM left {axes[1]} m of vertical error")
    expect(history[1] < ate0, "the first LUM round did not lower the ATE")

    # (b) the first round's graph with the CG solver
    world1, res1, edges1 = first_round
    eye = torch.eye(4, device="cuda").repeat(V, 1, 1)
    cg, csecs = timed(lambda: lum(eye, *edges1, max_iterations=F_LUM["iter"], solver="cg"))
    cg_poses = np.einsum("vij,vjk->vik", cg.poses.double().cpu().numpy(), init)
    gap = max(pose_gap(a, b)[0] for a, b in zip(cg.poses, res1.poses))
    print(f"phase 8: (b) CG on round 1's graph: {csecs * 1e3:.1f} ms, ATE "
          f"{trajectory.trajectory_ate(cg_poses, golden, align=False).rmse:.4f} m (dense "
          f"round 1: {history[1]:.4f} m), largest pose gap to dense {gap:.3e} m", flush=True)

    # (c) ELCH: ICP of the loop's end onto its start, spread over the chain
    ends = [make_cloud(world1[-1]), make_cloud(world1[0])]
    loop_icp, isecs = timed(lambda: icp(*ends, **F_ELCH_ICP))
    corr = elch_distribute(eye, loop_icp.transform).double().cpu().numpy()
    elch_poses = np.einsum("vij,vjk->vik", corr, init)
    before = pose_gap(torch.from_numpy(init[-1]), torch.from_numpy(golden[-1]))
    after = pose_gap(torch.from_numpy(elch_poses[-1]), torch.from_numpy(golden[-1]))
    elch_ate = trajectory.trajectory_ate(elch_poses, golden, align=False).rmse
    print(f"phase 8: (c) ELCH: loop ICP {isecs * 1e3:.1f} ms, {int(loop_icp.iterations)} "
          f"iterations, converged {bool(loop_icp.converged)}; loop end off {before[0]:.4f} m "
          f"{before[1]:.5f} rad -> {after[0]:.4f} m {after[1]:.5f} rad; ATE {elch_ate:.4f} m "
          f"(drifted {ate0:.4f} m)", flush=True)
    expect(after[0] < before[0], "ELCH did not lower the loop end's error")

    # (d) tools.lum itself on PCD files of the first round's scans (default device)
    with tempfile.TemporaryDirectory() as tmp:
        files = [os.path.join(tmp, f"f{k:02d}.pcd") for k in range(V)]
        for f, w in zip(files, world1):
            io.save(f, make_cloud(w))
        out = pyio.StringIO()
        with contextlib.redirect_stdout(out):
            (rc, tsecs) = timed(lambda: lum_tool.main(
                [*files, "-loop_dist", str(kw["loop_dist"]), "-corr_dist", str(kw["corr_dist"]),
                 "-max_corr", str(kw["max_corr"]), "-iter", str(F_LUM["iter"])]))
        outs = [io.load(f.replace(".pcd", "_out.pcd")) for f in files]
    ref = [transform_points(res1.poses[k], torch.from_numpy(world1[k]).cuda()) for k in range(V)]
    diff = max(float((o.xyz[o.mask] - r).abs().max()) for o, r in zip(outs, ref))
    print(f"phase 8: (d) tools.lum on {V} PCD files: return code {rc}, {tsecs * 1e3:.1f} ms; "
          f"{out.getvalue().splitlines()[-1]}; max |cloud - (a) round 1| {diff:.3e} m", flush=True)
    expect(rc == 0 and diff <= 1e-5, f"tools.lum differs from (a)'s first round by {diff} m")
    record_b1["launches_by_path"]["F"] = launch_count("nn1")
    record_b2["launches_by_path"]["F"] = launch_count("segsum")
    print(f"phase 8: path F launched nn1 {launch_count('nn1')} times (one per edge and "
          f"round), segsum {launch_count('segsum')} times", flush=True)
    expect(launch_count("nn1") > 0 and launch_count("segsum") == V,
           "path F did not launch B1 and B2 as planned")

    # B1 at the shape path F gives it: an edge's subsampled points against a scan
    tgt = torch.from_numpy(world1[1]).cuda()
    tmask = torch.ones(len(tgt), dtype=torch.bool, device="cuda")
    step = max(1, len(world1[0]) // F_LUM["max_corr"])
    q = torch.from_numpy(np.ascontiguousarray(world1[0][::step][:F_LUM["max_corr"]])).cuda()
    (ik, dk), (ip, dp) = nn1_mod.nn1(tgt, tmask, q), nn1_mod.nn1_plain(tgt, tmask, q)
    ms = cuda_ms(lambda: nn1_mod.nn1(tgt, tmask, q), reps=20)
    plain_ms = cuda_ms(lambda: nn1_mod.nn1_plain(tgt, tmask, q), reps=2)
    bound_s, bound_by = nn1_bound_ms(len(q), len(tgt))
    print(f"phase 8: nn1 at path F's shape {len(q)} x {len(tgt)}: {ms * 1e3:.1f} us, plain "
          f"{plain_ms:.2f} ms, bound {bound_s * 1e6:.1f} us ({bound_by}); differing indices "
          f"{int((ik != ip).sum())}, max |d2 - plain| {float((dk - dp).abs().max()):.3e} "
          f"[{card_line()}]", flush=True)
    expect(torch.equal(ik, ip) and torch.equal(dk, dp),
           "B1 differs from its plain version at path F's shape")
    record_b1["path_f"] = {"q": len(q), "m": len(tgt), "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound_s * 1e3, "bound_by": bound_by}

    # (e) a graph of KITTI sequence 00's length, dense and CG
    G, init_k, edges_k = kitti_graph(F_KITTI_V, F_KITTI_LOOPS, F_KITTI_C, F_SEED)
    ate_k0 = trajectory.trajectory_ate(init_k, G, align=False).rmse
    P0 = torch.from_numpy(init_k).cuda()
    runs = []
    for name, kwk in (("dense", dict(solver="dense")), ("cg", dict(solver="cg")),
                      ("cg 1000", dict(solver="cg", cg_iters=1000))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        r, s = timed(lambda: lum(P0, *edges_k, max_iterations=F_KITTI_ITERS, **kwk))
        ate_k = trajectory.trajectory_ate(r.poses.double().cpu().numpy(), G, align=False).rmse
        per_it = s * 1e3 / max(int(r.iterations), 1)
        runs.append((name, per_it, ate_k))
        print(f"phase 8: (e) V={F_KITTI_V}, E={len(edges_k[0])}, {F_KITTI_C} correspondences "
              f"an edge, {name}: {int(r.iterations)} iterations, {per_it:.1f} ms per iteration, "
              f"ATE {ate_k0:.4f} m -> {ate_k:.4f} m, residual {float(r.residual):.3e} m^2, peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card_line()}]",
              flush=True)
        expect(bool(torch.isfinite(r.poses).all()), f"(e) {name} gave non-finite poses")
        if name == "dense":
            expect(per_it <= F_DENSE_LIMIT_S * 1e3,
                   f"a dense iteration at V={F_KITTI_V} took {per_it} ms")
    # the linearisation about the world origin is far from the poses of a
    # route hundreds of metres long (ROADMAP C31): from the golden poses the
    # solve must stay put
    r = lum(torch.from_numpy(G.astype(np.float32)).cuda(), *edges_k, max_iterations=2)
    ate_t = trajectory.trajectory_ate(r.poses.double().cpu().numpy(), G, align=False).rmse
    print(f"phase 8: (e) dense from the golden poses, 2 iterations: ATE {ate_t:.4f} m", flush=True)
    expect(ate_t <= F_KITTI_TRUTH_ATE, f"(e) LUM from the golden poses moved to ATE {ate_t} m")

    # the card against the port's CPU run on a small graph
    P8, pairs8, C8 = small_graph()
    on = [lum(torch.from_numpy(P8).to(dev), *build_edges_from_correspondences(pairs8, C8, dev),
              max_iterations=5) for dev in ("cuda", "cpu")]
    gaps = [pose_gap(a, b) for a, b in zip(on[0].poses, on[1].poses)]
    gt, gr = max(g[0] for g in gaps), max(g[1] for g in gaps)
    print(f"phase 8: LUM on a V=8 graph, card against CPU: {gt:.3e} m, {gr:.3e} rad", flush=True)
    expect(gt <= 1e-4 and gr <= 1e-4, f"card and CPU LUM differ by {gt} m, {gr} rad")
    check(not failed, "path F: " + "; ".join(failed))
    return {"ate": (ate0, history[-1]), "kitti": runs}


# the room of path G in the camera's world frame (x right, y down, z forward):
# planes (axis, position, bounds of the other two axes in axis order), an
# axis-aligned box, a sphere and a vertical cylinder resting on the floor
G_PLANES = ((1, 1.0, ((-1.45, 1.3), (0.05, 2.7))),          # floor
            (2, 2.7, ((-1.45, 1.3), (-1.45, 1.0))),         # back wall
            (0, 1.3, ((-1.45, 1.0), (0.05, 2.7))))          # side wall
G_BOX = ((-0.6, 0.7, 1.7), (-0.2, 1.0, 2.1))
G_SPHERE = ((0.45, 0.8, 1.5), 0.2)
G_CYLINDER = ((0.3, 2.25), 0.15, (0.5, 1.0))                # (x, z), radius, y range


def _ray_hits(o: np.ndarray, d: np.ndarray):
    """Nearest hit of rays ``o + t d`` (``d [..., 3]``, world) with the room:
    ``(t, unit normal)``, ``t`` inf where nothing is hit."""
    shape = d.shape[:-1]
    best = np.full(shape, np.inf)
    nrm = np.zeros(shape + (3,))

    def take(t, n):
        nonlocal best
        better = (t > 1e-6) & (t < best)
        best = np.where(better, t, best)
        nrm[better] = np.broadcast_to(n, shape + (3,))[better]

    safe = np.where(np.abs(d) > 1e-12, d, 1e-12)
    for axis, at, bounds in G_PLANES:
        t = (at - o[axis]) / safe[..., axis]
        p = o + t[..., None] * d
        others = [a for a in range(3) if a != axis]
        inside = np.ones(shape, bool)
        for a, (lo, hi) in zip(others, bounds):
            inside &= (p[..., a] >= lo) & (p[..., a] <= hi)
        n = np.zeros(3)
        n[axis] = -np.sign(at - o[axis])
        take(np.where(inside, t, np.inf), n)
    lo, hi = (np.array(b) for b in G_BOX)
    t0, t1 = (lo - o) / safe, (hi - o) / safe
    tn, tf = np.minimum(t0, t1), np.maximum(t0, t1)
    face = np.argmax(tn, -1)
    t_in = tn.max(-1)
    n = -np.sign(safe) * np.eye(3)[face]              # the entry face, against the ray
    take(np.where(t_in < tf.min(-1), t_in, np.inf), n)
    c, r = np.array(G_SPHERE[0]), G_SPHERE[1]
    oc = o - c
    b = np.sum(d * oc, -1)
    disc = b * b - (np.sum(d * d, -1) * (oc @ oc - r * r))
    t = (-b - np.sqrt(np.maximum(disc, 0))) / np.sum(d * d, -1)
    p = o + t[..., None] * d
    take(np.where(disc > 0, t, np.inf), (p - c) / r)
    (cx, cz), r, (y0, y1) = G_CYLINDER
    a = d[..., 0] ** 2 + d[..., 2] ** 2
    bb = d[..., 0] * (o[0] - cx) + d[..., 2] * (o[2] - cz)
    cc = (o[0] - cx) ** 2 + (o[2] - cz) ** 2 - r * r
    disc = bb * bb - a * cc
    t = (-bb - np.sqrt(np.maximum(disc, 0))) / np.maximum(a, 1e-12)
    p = o + t[..., None] * d
    side = (disc > 0) & (p[..., 1] >= y0) & (p[..., 1] <= y1)
    n = np.stack([(p[..., 0] - cx) / r, np.zeros(shape), (p[..., 2] - cz) / r], -1)
    take(np.where(side, t, np.inf), n)
    t = (y0 - o[1]) / safe[..., 1]
    p = o + t[..., None] * d
    cap = (p[..., 0] - cx) ** 2 + (p[..., 2] - cz) ** 2 <= r * r
    take(np.where(cap, t, np.inf), np.array([0.0, -1.0, 0.0]))
    return best, nrm


def render_depth(pose: np.ndarray, intr, H: int, W: int, rng=None):
    """Depth [H,W] (float32, 0 where invalid) of the room seen from ``pose``
    (camera-to-world), with range noise growing as the square of the depth
    and a share of invalid pixels when ``rng`` is given, and the true unit
    normals [H,W,3] in the camera frame."""
    v, u = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    d_cam = np.stack([(u - intr.cx) / intr.fx, (v - intr.cy) / intr.fy, np.ones((H, W))], -1)
    t, n = _ray_hits(pose[:3, 3], d_cam @ pose[:3, :3].T)
    n_cam = n @ pose[:3, :3]                 # world normals to the camera frame
    ok = np.isfinite(t) & (t < G_FAR)
    depth = np.where(ok, t, 0.0)
    if rng is not None:
        depth = depth + rng.normal(size=depth.shape) * G_NOISE * depth ** 2
        ok &= rng.random(depth.shape) >= G_INVALID
    return np.where(ok, depth, 0.0).astype(np.float32), n_cam


def room_parts(p: np.ndarray) -> np.ndarray:
    """Unsigned distances ``[6, N]`` of world points [N,3] to the room's
    surfaces: floor, back wall, side wall, box, sphere, cylinder."""
    out = []
    for axis, at, bounds in G_PLANES:
        others = [a for a in range(3) if a != axis]
        off = [np.maximum(np.maximum(lo - p[:, a], p[:, a] - hi), 0) for a, (lo, hi)
               in zip(others, bounds)]
        out.append(np.sqrt((p[:, axis] - at) ** 2 + off[0] ** 2 + off[1] ** 2))
    lo, hi = (np.array(b) for b in G_BOX)
    outside = np.linalg.norm(np.maximum(np.maximum(lo - p, p - hi), 0), axis=1)
    inside = np.minimum(p - lo, hi - p).min(1)
    out.append(np.where(outside > 0, outside, np.abs(inside)))
    out.append(np.abs(np.linalg.norm(p - np.array(G_SPHERE[0]), axis=1) - G_SPHERE[1]))
    (cx, cz), r, (y0, y1) = G_CYLINDER
    rho = np.hypot(p[:, 0] - cx, p[:, 2] - cz)
    dy = np.maximum(np.maximum(y0 - p[:, 1], p[:, 1] - y1), 0)
    side = np.hypot(rho - r, dy)
    cap = np.hypot(p[:, 1] - y0, np.maximum(rho - r, 0))
    out.append(np.minimum(side, cap))
    return np.stack(out)


def room_distance(p: np.ndarray) -> np.ndarray:
    """Unsigned distance of world points [N,3] to the room's surfaces."""
    return room_parts(p).min(axis=0)


def handheld(rng, n: int) -> np.ndarray:
    """n camera poses from G_START, each a random step of G_STEP[0] m and
    G_STEP[1] deg from the last."""
    from scipy.spatial.transform import Rotation

    P = np.eye(4)
    P[:3, :3] = Rotation.from_euler("x", -G_TILT, degrees=True).as_matrix()
    P[:3, 3] = G_START
    out = [P]
    for _ in range(n - 1):
        out.append(out[-1] @ random_twist(rng, G_STEP[0], math.radians(G_STEP[1])))
    return np.stack(out)


def eigen_gap_ok(xyz: np.ndarray, valid: np.ndarray, half: int) -> np.ndarray:
    """Pixels of an organized frame whose integral-image window covariance is
    decided by the data and not by the rounding of float32 integral images
    (ROADMAP C9, C26): lambda1 - lambda0 > max(1e-3 lambda2, 300 delta), the
    eigenvalues from float64 window sums, delta = 2^-24 (I|p|^2 + 2|mu| I|p|)
    / cnt with I the integral images at the window's far corner."""
    H, W = valid.shape

    def box(a):
        I = np.pad(np.cumsum(np.cumsum(a, 0), 1), ((1, 0), (1, 0)) + ((0, 0),) * (a.ndim - 2))
        r, c = np.arange(H), np.arange(W)
        r0, r1 = np.clip(r - half, 0, H), np.clip(r + half + 1, 0, H)
        c0, c1 = np.clip(c - half, 0, W), np.clip(c + half + 1, 0, W)
        return I[r1][:, c1] - I[r0][:, c1] - I[r1][:, c0] + I[r0][:, c0], I[r1][:, c1]

    w = valid.astype(np.float64)
    p = xyz.astype(np.float64) * w[..., None]
    cnt = np.maximum(box(w)[0], 1.0)
    mu = box(p)[0] / cnt[..., None]
    cov = box(p[..., :, None] * p[..., None, :])[0] / cnt[..., None, None] \
        - mu[..., :, None] * mu[..., None, :]
    lam = np.linalg.eigvalsh(cov)
    i2, i1 = box(np.sum(p * p, -1))[1], box(np.linalg.norm(p, axis=-1))[1]
    delta = 2.0 ** -24 * (i2 + 2 * np.linalg.norm(mu, axis=-1) * i1) / cnt
    return lam[..., 1] - lam[..., 0] > np.maximum(1e-3 * lam[..., 2], 300 * delta)


def phase9_path_g(segsum, nn1_mod, record_b1, record_b2):
    """Path G: KinFu mapping of a synthetic room at PCL KinFu's defaults
    (512^3 over 3 m, VGA depth, {10, 5, 4} ICP iterations)."""
    from pcl_tpu_torch.features import integral_image_normals
    from pcl_tpu_torch.filters import fast_bilateral
    from pcl_tpu_torch.fusion import (Intrinsics, WorldModel, depth_to_vertex_map,
                                      extract_surface_points, integrate, kinfu_init,
                                      kinfu_step, load_tsdf, make_volume, raycast, save_tsdf)
    from pcl_tpu_torch.fusion import kinfu as kinfu_mod
    from pcl_tpu_torch.registration import trajectory

    failed = []

    def expect(cond: bool, what: str) -> None:
        if not cond:
            print(f"phase 9: CHECK FAILED: {what}", flush=True)
            failed.append(what)

    intr = Intrinsics(*G_INTR)
    H, W = G_SHAPE
    rng = np.random.default_rng(G_SEED)
    golden = handheld(rng, G_FRAMES)
    (frames, truth), secs = timed(lambda: tuple(zip(*[render_depth(P, intr, H, W, rng)
                                                     for P in golden])))
    print(f"phase 9: {G_FRAMES} frames of {W} x {H} of the room rendered in {secs:.1f} s; "
          f"valid share {np.mean([(f > 0).mean() for f in frames]):.3f}, depth "
          f"{min(f[f > 0].min() for f in frames):.2f}-{max(f.max() for f in frames):.2f} m",
          flush=True)

    # warm-up on a small volume (allocator, libraries)
    start = torch.from_numpy(golden[0]).float().cuda()
    s = kinfu_init(make_volume(64, G_SIZE, origin=G_ORIGIN), H, W, start)
    for f in frames[:2]:
        s = kinfu_step(s, torch.from_numpy(f).cuda(), intr)
    del s
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trace.reset()
    state = kinfu_init(make_volume(G_RES, G_SIZE, origin=G_ORIGIN), H, W, start)
    poses, lost, step_s = [], [], []
    for f in frames:
        state, secs = timed(lambda: kinfu_step(state, torch.from_numpy(f).cuda(), intr))
        poses.append(state.pose.double().cpu().numpy())
        lost.append(bool(state.lost))
        step_s.append(secs)
    record_b1["launches_by_path"]["G"] = launch_count("nn1")
    record_b2["launches_by_path"]["G"] = launch_count("segsum")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ate = trajectory.trajectory_ate(np.stack(poses), golden, align=False)
    ms = np.array(step_s[1:]) * 1e3
    print(f"phase 9: {G_FRAMES} frames at {G_RES}^3: {np.sum(step_s):.2f} s, per frame "
          f"(after the first) mean {ms.mean():.1f} ms, min {ms.min():.1f}, max {ms.max():.1f}; "
          f"lost {sum(lost)}; ATE (unaligned) rmse {ate.rmse:.5f} m, max {ate.max:.5f} m; peak "
          f"memory {peak:.2f} GiB; launches nn1 {launch_count('nn1')}, segsum "
          f"{launch_count('segsum')} [{card_line()}]", flush=True)
    expect(not any(lost), f"frames lost: {[k for k, x in enumerate(lost) if x]}")
    expect(ate.rmse <= G_ATE_LIMIT, f"KinFu ATE {ate.rmse} m over {G_ATE_LIMIT} m")
    expect(launch_count("nn1") == 0 and launch_count("segsum") == 0,
           "path G launched a kernel it does not use")

    # the map: surface points against the room, the last raycast's coverage
    vol = state.volume
    (pts, valid), secs = timed(lambda: extract_surface_points(vol, max_points=G_MAX_POINTS))
    p = pts[valid].cpu().numpy()
    dist = room_distance(p.astype(np.float64))
    vs = G_SIZE / G_RES
    print(f"phase 9: extract_surface_points: {len(p)} points in {secs * 1e3:.1f} ms; distance to "
          f"the room median {np.median(dist) * 1e3:.2f} mm, p90 "
          f"{np.percentile(dist, 90) * 1e3:.2f} mm (voxel {vs * 1e3:.2f} mm)", flush=True)
    expect(len(p) > 0 and np.median(dist) <= vs, "surface points lie off the room")
    last_valid = frames[-1] > 0
    cover = float(state.prev_hit.cpu().numpy()[last_valid].mean())
    print(f"phase 9: the last raycast hits {cover:.4f} of the last frame's valid pixels",
          flush=True)
    expect(cover >= 0.9, f"the last raycast hits {cover} of the valid pixels")

    # where one frame's time goes, stage by stage, from the last state
    d = torch.from_numpy(frames[-1]).cuda()
    pose = state.pose
    stages = {}
    db, stages["bilateral"] = timed(lambda: torch.where(d > 0, fast_bilateral(d), 0.0))

    def pyramid():
        ds = [db, kinfu_mod._pyr_down_depth(db)]
        ds.append(kinfu_mod._pyr_down_depth(ds[-1]))
        m1 = kinfu_mod._pyr_down_map(state.prev_verts, state.prev_normals, state.prev_hit)
        return ds, [(state.prev_verts, state.prev_normals, state.prev_hit), m1,
                    kinfu_mod._pyr_down_map(*m1)]

    (ds, maps), stages["pyramid"] = timed(pyramid)

    def track():
        P = pose
        for level in (2, 1, 0):
            il = kinfu_mod._scale_intrinsics(intr, level)
            P, _ = kinfu_mod._projective_icp(depth_to_vertex_map(ds[level], il), ds[level] > 0,
                                             *maps[level], P, il, pose,
                                             kinfu_mod.LEVEL_ITERS[level], 0.1, math.pi / 6)
        return P

    _, stages["icp"] = timed(track)
    vol2, stages["integrate"] = timed(lambda: integrate(vol, db, intr, pose))
    _, stages["raycast"] = timed(lambda: raycast(vol2, intr, pose, H, W))
    del vol2
    print("phase 9: one frame by stage: " + ", ".join(f"{k} {v * 1e3:.2f} ms"
                                                     for k, v in stages.items())
          + f" [{card_line()}]", flush=True)
    device_breakdown("phase 9 (one kinfu_step)", lambda: kinfu_step(state, d, intr))

    # checkpoint and world model
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "vol.npz")
        _, wsecs = timed(lambda: save_tsdf(path, vol))
        size = os.path.getsize(path)
        back, rsecs = timed(lambda: load_tsdf(path))
    same = all(torch.equal(getattr(back, n), getattr(vol, n))
               for n in ("tsdf", "weight", "origin", "voxel_size", "trunc"))
    print(f"phase 9: save_tsdf of the {G_RES}^3 volume {wsecs:.2f} s ({size / 2**20:.1f} MiB), "
          f"load_tsdf {rsecs:.2f} s, bitwise equal {same}", flush=True)
    expect(same, "the volume read back differs")
    del back
    wm = WorldModel(vs, G_ORIGIN)
    x0 = G_RES // 2
    slab = (vol.tsdf[x0:x0 + 16], vol.weight[x0:x0 + 16])
    wm.push_slab(G_ORIGIN[0] + x0 * vs, *slab)
    got = wm.fetch_slab(G_ORIGIN[0] + x0 * vs, tuple(slab[0].shape))
    round_trip = all(np.array_equal(g, s_.cpu().numpy()) for g, s_ in zip(got, slab))
    print(f"phase 9: WorldModel push and fetch of a 16-plane x-slab: equal {round_trip}",
          flush=True)
    expect(round_trip, "the world model's slab differs")

    # the card against the CPU: three frames at 96^3 and 60 x 80
    small = Intrinsics(G_INTR[0] / 8, G_INTR[1] / 8, (G_INTR[2] + 0.5) / 8 - 0.5,
                       (G_INTR[3] + 0.5) / 8 - 0.5)
    sframes = [render_depth(P, small, H // 8, W // 8, rng)[0] for P in golden[:3]]
    runs = []
    for dev in ("cuda", "cpu"):
        s = kinfu_init(make_volume(96, G_SIZE, origin=G_ORIGIN, device=dev), H // 8, W // 8,
                       torch.from_numpy(golden[0]).float().to(dev))
        out = []
        for f in sframes:
            s = kinfu_step(s, torch.from_numpy(f).to(dev), small)
            out.append((s.pose.double().cpu(), bool(s.lost)))
        runs.append(out)
    gaps = [pose_gap(a[0], b[0]) for a, b in zip(*runs)]
    gt, gr = max(g[0] for g in gaps), max(g[1] for g in gaps)
    print(f"phase 9: three frames at 96^3 and {W // 8} x {H // 8}, card against CPU: {gt:.3e} m, "
          f"{gr:.3e} rad, lost {[x[1] for x in runs[0]]} / {[x[1] for x in runs[1]]}", flush=True)
    expect(gt <= 1e-4 and gr <= 1e-4 and [x[1] for x in runs[0]] == [x[1] for x in runs[1]],
           f"KinFu on the card and the CPU differ by {gt} m, {gr} rad")

    # integral normals of the last frame's vertex map
    vmap = depth_to_vertex_map(d, intr)
    ok = d > 0
    true_n = torch.from_numpy(truth[-1]).float()
    for mode in ("covariance", "gradient"):
        run = (lambda m=mode: integral_image_normals(vmap, ok, mode=m))
        ms_n = cuda_ms(run, reps=5)
        n = run()[0].cpu()
        has = n.abs().sum(-1) > 0
        ang = torch.rad2deg(torch.arccos(torch.clamp((n * true_n).sum(-1).abs(), max=1.0)))[has]
        sub = (vmap[::8, ::8].contiguous(), ok[::8, ::8].contiguous())
        n_card = integral_image_normals(*sub, mode=mode)[0].cpu()
        n_cpu = integral_image_normals(*(a.cpu() for a in sub), mode=mode)[0]
        zero_same = torch.equal(n_card.abs().sum(-1) == 0, n_cpu.abs().sum(-1) == 0)
        cmp = n_cpu.abs().sum(-1) > 0
        if mode == "covariance":
            cmp &= torch.from_numpy(eigen_gap_ok(sub[0].cpu().numpy(), sub[1].cpu().numpy(), 2))
        dots = (n_card * n_cpu).sum(-1)[cmp]
        worst = float(dots.min()) if len(dots) else float("nan")
        print(f"phase 9: integral normals ({mode}) at {W} x {H}: {ms_n:.3f} ms; error against the "
              f"true normals median {float(ang.median()):.2f} deg, p99 "
              f"{float(torch.quantile(ang, 0.99)):.2f} deg over {int(has.sum())} pixels (printed, "
              f"not checked: ROADMAP C25); at {W // 8} x {H // 8} card against CPU: "
              f"{int(cmp.sum())} pixels compared, min n.n' {worst:.7f}, zero normals alike "
              f"{zero_same}", flush=True)
        expect(zero_same and len(dots) > 0 and worst >= 1 - 1e-5,
               f"integral normals ({mode}) on the card differ from the CPU run")
    check(not failed, "path G: " + "; ".join(failed))
    return {"ms_frame": float(ms.mean()), "ate": ate.rmse, "stages": stages, "peak_gib": peak}


def planar_scan(scene: np.ndarray, k: int, rng) -> np.ndarray:
    """Path H (i): a planar laser's scan ``k`` of ``scene``, taken at
    ``pose_matrix(H_PLANAR_STEP[0] k, H_PLANAR_STEP[1] k)``: the points
    ``H_PLANAR_BAND`` m above the ground, written with the ground plane as xy
    (x along the street, y across it) and z = 0."""
    s = scan_at(scene, pose_matrix(H_PLANAR_STEP[0] * k, H_PLANAR_STEP[1] * k), rng)
    h = s[:, 1] + 1.7
    s = s[(h >= H_PLANAR_BAND[0]) & (h <= H_PLANAR_BAND[1])]
    return np.stack([s[:, 2], s[:, 0], np.zeros(len(s), np.float32)], 1).astype(np.float32)


def planar_truth(k: int) -> np.ndarray:
    """(tx, ty, theta) that takes planar scan ``k`` onto scan ``k - 1``."""
    T = np.linalg.inv(pose_matrix(H_PLANAR_STEP[0] * (k - 1), H_PLANAR_STEP[1] * (k - 1))) \
        @ pose_matrix(H_PLANAR_STEP[0] * k, H_PLANAR_STEP[1] * k)
    return np.array([T[2, 3], T[0, 3], math.atan2(T[0, 2], T[2, 2])])


def runner_up_margin(errs: torch.Tensor) -> float:
    """How far, relatively, the least finite error lies below the next."""
    e = torch.sort(errs[torch.isfinite(errs)].double().cpu())[0]
    return float((e[1] - e[0]) / max(abs(float(e[0])), 1e-30)) if len(e) > 1 else math.inf


def phase10_path_h(segsum, nn1_mod, street, alley_scene, c_scans, c_golden, record_b1,
                   record_b2):
    """Path H: the rest of registration on path E's pair and path C's scans:
    FPCS, K-FPCS, batched and host 4PCS, PPF, nonlinear and joint ICP,
    incremental and meta registration, 2-D NDT and ICP, Hausdorff and
    pyramid matching."""
    from pcl_tpu_torch import io
    from pcl_tpu_torch.core import geometry
    from pcl_tpu_torch.core.cloud import Cloud, make_cloud
    from pcl_tpu_torch.registration import (IncrementalRegistration, MetaRegistration,
                                            build_pyramid, compare_pyramids, fpcs, ia, icp,
                                            icp_nl, joint_icp, ndt_2d, ppf, trajectory,
                                            validate_euclidean)
    from pcl_tpu_torch.search import bruteforce
    from pcl_tpu_torch.tools import compute_hausdorff, icp2d, ndt2d as ndt2d_tool
    from pcl_tpu_torch.tools.odometry import probed_cells

    failed = []
    dev = "cuda"

    def expect(cond: bool, what: str) -> None:
        """A check of this phase, raised with the others at its end."""
        if not cond:
            print(f"phase 10: CHECK FAILED: {what}", flush=True)
            failed.append(what)

    parts = {}

    def part(name, fn):
        """Run one part of the main path: its seconds and its B1 and B2
        launches."""
        b1, b2 = launch_count("nn1"), launch_count("segsum")
        out, secs = timed(fn)
        parts[name] = {"s": secs, "b1": launch_count("nn1") - b1,
                       "b2": launch_count("segsum") - b2}
        return out

    def left(T, P):
        """Across the street and up (m), along it (m), rotation (rad) of T
        against P, in scan 0's frame (x across, y up, z along)."""
        d = T.double().cpu().numpy()[:3, 3] - P[:3, 3]
        return math.hypot(d[0], d[1]), abs(d[2]), pose_gap(T, torch.from_numpy(P))[1]

    def fmt(r):
        return f"{r[0]:.3e} m across and up, {r[1]:.3e} m along, {r[2]:.3e} rad"

    rng = np.random.default_rng(E_SEED)
    P = pose_matrix(*E_POSE)
    raw = [scan_at(street, np.eye(4), rng), scan_at(street, P, rng)]
    # warm-up of the stages (libraries, allocator) on a quarter of scan 0
    global_front(make_cloud(raw[0][::4]), k=16)

    trace.reset()
    tgt, ft, _, k, _ = part("front 0", lambda: global_front(make_cloud(raw[0])))
    src, fs, _, _, _ = part("front 1", lambda: global_front(make_cloud(raw[1]), k=k))
    cells = probed_cells(src, tgt, "icp", E_ICP_KW["max_corr_dist"])

    ks, kt = part("ISS", lambda: fpcs.kfpcs_keypoints(src, tgt, H_SALIENT))
    print(f"phase 10: path E's pair, {src.capacity} / {tgt.capacity} voxels; ISS keypoints "
          f"(salient radius {H_SALIENT} m) {int(ks.mask.sum())} / {int(kt.mask.sum())} in "
          f"{parts['ISS']['s'] * 1e3:.1f} ms", flush=True)

    # each aligner at the JAX defaults
    aligners = {
        "a fpcs_align": lambda: fpcs.fpcs_align(src, tgt),
        "b kfpcs_align": lambda: fpcs.kfpcs_align(src, tgt, salient_radius=H_SALIENT),
        "c fpcs4_align": lambda: fpcs.fpcs4_align(src, tgt),
        "d fpcs4_align_host": lambda: fpcs.fpcs4_align_host(live_rows(ks), live_rows(kt)),
        "e ppf_register": lambda: ppf.ppf_register(src, tgt),
    }
    globals_ = {}
    for name, run in aligners.items():
        out = part(name, run)
        T = out.transform
        score = float(out.votes) if name.startswith("e") else float(out.error)
        ref = part(name + " ICP", lambda: icp(src, tgt, init_transform=T,
                                               variant="point_to_plane", **E_ICP_KW, **cells))
        v = validate_euclidean(src, tgt, ref.transform, **E_VALIDATE_KW)
        globals_[name] = (T, ref, v)
        g, r = left(T, P), left(ref.transform, P)
        print(f"phase 10: ({name}) {parts[name]['s'] * 1e3:.3f} ms, valid {bool(out.valid)}, "
              f"{'votes' if name.startswith('e') else 'error'} {score:.6g}, B1 "
              f"{parts[name]['b1']}; left: {fmt(g)}; point-to-plane ICP "
              f"{parts[name + ' ICP']['s'] * 1e3:.3f} ms, {int(ref.iterations)} iterations, "
              f"code {int(ref.convergence_state)}: left {fmt(r)}; validation score "
              f"{float(v.score):.4f} ({bool(v.is_valid)}) [{card_line()}]", flush=True)
        # the JAX package's run fails on both scenes too (ROADMAP C35)
        print(f"phase 10: ({name}) pose printed, not checked: the JAX rehearsal recovers "
              f"the motion on neither scene", flush=True)
    # PPF votes: it scores nothing by distance
    expect(all(parts[n]["b1"] >= 1 for n in globals_ if not n.startswith("e")),
           f"an aligner's scoring did not launch B1: {parts}")

    # the best global result: the candidate (these five and path E's
    # prerejective RANSAC) whose point-to-plane refinement validates best
    skp, tkp = (c.with_mask(c.attrs["curvature"] > E_KEYPOINT_CURVATURE) for c in (src, tgt))
    pre = part("E prerejective", lambda: ia.prerejective_ransac(skp, fs, tkp, ft, **E_PRE_KW))
    ref = icp(src, tgt, init_transform=pre.transform, variant="point_to_plane", **E_ICP_KW,
              **cells)
    globals_["E prerejective"] = (pre.transform, ref,
                                  validate_euclidean(src, tgt, ref.transform, **E_VALIDATE_KW))
    best = min(globals_, key=lambda n: (not bool(globals_[n][2].is_valid),
                                        float(globals_[n][2].score)))
    T0 = globals_[best][0]
    nl = part("f icp_nl", lambda: icp_nl(src, tgt, init_transform=T0, warp="rigid_6d",
                                         **E_ICP_KW))
    r = left(nl.transform, P)
    print(f"phase 10: (f) icp_nl (rigid_6d, 1 m gate) from ({best}) at {fmt(left(T0, P))}: "
          f"{parts['f icp_nl']['s'] * 1e3:.3f} ms, {int(nl.iterations)} iterations, code "
          f"{int(nl.convergence_state)}, B1 {parts['f icp_nl']['b1']}: left {fmt(r)}", flush=True)
    expect(r[0] <= E_REFINED[0] and r[1] <= E_REFINED[1] and r[2] <= E_REFINED[2],
           f"(f) icp_nl left {r}")
    expect(parts["f icp_nl"]["b1"] == int(nl.iterations), "(f) B1 not once an iteration")

    # (g), (h): path C's six scans through its front end (B2 x6), whose
    # odometry_sequence records every pairwise result
    (c_clouds, c_poses, c_results) = part("C front end", lambda: front_end(
        [make_cloud(s) for s in c_scans]))
    s1, t0_ = c_clouds[1], c_clouds[0]
    halves = [(s1.with_mask(side(s1.xyz[:, 0])), t0_.with_mask(side(t0_.xyz[:, 0])))
              for side in (lambda x: x < 0, lambda x: x >= 0)]
    jr = part("g joint_icp", lambda: joint_icp([h[0] for h in halves], [h[1] for h in halves],
                                               **H_JOINT_KW))
    step = np.linalg.inv(c_golden[0]) @ c_golden[1]
    jt, ja = pose_gap(jr.transform, torch.from_numpy(step))
    print(f"phase 10: (g) joint_icp of scan 1 onto scan 0 as two scanners (x < 0, x >= 0; "
          f"{[int(h[0].mask.sum()) for h in halves]} / {[int(h[1].mask.sum()) for h in halves]} "
          f"voxels): {parts['g joint_icp']['s'] * 1e3:.3f} ms, {int(jr.iterations)} iterations, "
          f"code {int(jr.convergence_state)}, B1 {parts['g joint_icp']['b1']}; left {jt:.3e} m, "
          f"{ja:.3e} rad", flush=True)
    expect(jt <= H_JOINT_LIMIT[0] and ja <= H_JOINT_LIMIT[1], f"(g) joint_icp left {jt} m, {ja}")
    expect(parts["g joint_icp"]["b1"] == 2 * int(jr.iterations), "(g) B1 not twice an iteration")

    pair_ts = []

    def register(s, t):
        res = icp(s, t, **ICP_KW)
        pair_ts.append(res.transform)
        return res

    inc = IncrementalRegistration(register=register)
    abs_ = part("h incremental", lambda: [(inc.register_cloud(c), inc.absolute_transform)
                                         for c in c_clouds])
    poses_inc = np.stack([a.double().cpu().numpy() for _, a in abs_])
    same = all(torch.equal(a, b[0].transform) for a, b in zip(pair_ts, c_results))
    gap = max(max(pose_gap(torch.from_numpy(a), torch.from_numpy(b))) for a, b in
              zip(poses_inc, c_poses))
    ate = trajectory.trajectory_ate(poses_inc, c_golden, align=False).rmse
    meta = MetaRegistration(register=lambda s, t: icp(s, t, **ICP_KW))
    ok_meta = part("h meta", lambda: [meta.register_cloud(c) for c in c_clouds[:3]])
    print(f"phase 10: (h) IncrementalRegistration over path C's six scans: "
          f"{parts['h incremental']['s'] * 1e3:.1f} ms, all registered "
          f"{all(o for o, _ in abs_)}, pairwise transforms bitwise those of odometry_sequence "
          f"{same}, absolute poses within {gap:.3e} of its float64 chain, ATE {ate:.6f} m; "
          f"MetaRegistration over three scans {parts['h meta']['s'] * 1e3:.1f} ms, registered "
          f"{ok_meta}, model of {meta.model.capacity} rows ({int(meta.model.mask.sum())} valid)",
          flush=True)
    expect(all(o for o, _ in abs_) and same and gap <= 1e-5 and ate <= H_ATE_LIMIT,
           f"(h) incremental: pairs equal {same}, gap {gap}, ATE {ate}")
    expect(all(ok_meta) and meta.model.capacity == 3 * c_clouds[0].capacity,
           "(h) MetaRegistration did not keep all three scans")

    # (i) a planar laser on the street with alleys
    prng = np.random.default_rng(H_PLANAR_SEED)
    planar = [planar_scan(alley_scene, i, prng) for i in range(H_PLANAR_SCANS)]
    pc = [make_cloud(p) for p in planar]
    for i in range(1, H_PLANAR_SCANS):
        res = part(f"i ndt_2d {i}", lambda: ndt_2d(pc[i], pc[i - 1], **H_NDT2D_KW))
        got, want = res.params.double().cpu().numpy(), planar_truth(i)
        d = np.abs(got - want)
        print(f"phase 10: (i) ndt_2d planar scan {i} ({len(planar[i])} points) onto {i - 1}: "
              f"{parts[f'i ndt_2d {i}']['s'] * 1e3:.1f} ms, {int(res.iterations)} iterations "
              f"at the finest level, converged {bool(res.converged)}, score "
              f"{float(res.score):.4f}; left {math.hypot(d[0], d[1]):.3e} m, {d[2]:.3e} rad",
              flush=True)
        expect(bool(res.converged) and math.hypot(d[0], d[1]) <= H_NDT2D_LIMIT[0]
               and d[2] <= H_NDT2D_LIMIT[1], f"(i) ndt_2d pair {i} left {d}")
        if i == 1:
            first = res
    with tempfile.TemporaryDirectory() as tmp:
        f0, f1, fo = (os.path.join(tmp, n) for n in ("p0.pcd", "p1.pcd", "out.pcd"))
        io.save(f0, pc[0])
        io.save(f1, pc[1])
        with contextlib.redirect_stdout(pyio.StringIO()) as out:
            part("i tools.ndt2d", lambda: ndt2d_tool.main([f1, f0, "-grid",
                                                           str(H_NDT2D_KW["grid_extent"])]))
        text = out.getvalue()
        want = first.params.cpu().numpy()
        expect(f"tx={want[0]:.6f} ty={want[1]:.6f} theta={want[2]:.6f}" in text,
               "tools.ndt2d printed another pose than ndt_2d")
        with contextlib.redirect_stdout(pyio.StringIO()) as out2:
            part("i tools.icp2d", lambda: icp2d.main([f1, f0, fo]))
        text2 = out2.getvalue().strip()
    vals = [float(v) for v in re.findall(r"-?\d+\.\d+", text2)]
    d2 = np.abs(np.array(vals) - planar_truth(1))
    print(f"phase 10: (i) tools.ndt2d {parts['i tools.ndt2d']['s'] * 1e3:.1f} ms, "
          f"{text.splitlines()[0]}; tools.icp2d {parts['i tools.icp2d']['s'] * 1e3:.1f} ms, B1 "
          f"{parts['i tools.icp2d']['b1']}: {text2} (left {math.hypot(d2[0], d2[1]):.3e} m, "
          f"{d2[2]:.3e} rad)", flush=True)
    expect(parts["i tools.icp2d"]["b1"] >= 1, "tools.icp2d did not launch B1")

    # (j) the Hausdorff distance of path E's raw scans: two 120k x 120k sweeps
    with tempfile.TemporaryDirectory() as tmp:
        fa, fb = os.path.join(tmp, "a.pcd"), os.path.join(tmp, "b.pcd")
        io.save(fa, make_cloud(raw[0]))
        io.save(fb, make_cloud(raw[1]))
        with contextlib.redirect_stdout(pyio.StringIO()) as out:
            part("j compute_hausdorff", lambda: compute_hausdorff.main([fa, fb]))
    h_tool = float(out.getvalue().split()[-1])
    print(f"phase 10: (j) tools.compute_hausdorff on the raw scans: {h_tool:.6f} m in "
          f"{parts['j compute_hausdorff']['s'] * 1e3:.1f} ms (B1 "
          f"{parts['j compute_hausdorff']['b1']})", flush=True)

    # (k) pyramid match of the two scans' FPFH
    both = torch.cat([fs[src.mask], ft[tgt.mask]])
    ranges = torch.stack([both.amin(0), both.amax(0)], 1)
    ps = part("k pyramids", lambda: (build_pyramid(fs, src.mask, ranges),
                                     build_pyramid(ft, tgt.mask, ranges)))
    sim, self_sim = float(compare_pyramids(*ps)), float(compare_pyramids(ps[0], ps[0]))
    print(f"phase 10: (k) FPFH pyramids (6 levels, 4096 slots): similarity of the scans "
          f"{sim:.6f}, of scan 1 with itself {self_sim:.7f}", flush=True)
    expect(abs(self_sim - 1.0) <= 1e-6 and 0.0 < sim < 1.0, "(k) pyramid similarities")

    record_b1["launches_by_path"]["H"] = launch_count("nn1")
    record_b2["launches_by_path"]["H"] = launch_count("segsum")
    print("phase 10: parts (ms, B1, B2): " + "; ".join(
        f"{n} {v['s'] * 1e3:.1f}, {v['b1']}, {v['b2']}" for n, v in parts.items())
        + f" [{card_line()}]", flush=True)

    # (j) again, off the main path: with B1 and with its plain version
    a_, b_ = (make_cloud(x) for x in raw)
    h_kernel = float(geometry.hausdorff(a_.xyz, a_.mask, b_.xyz, b_.mask))
    kernel_nn1 = bruteforce.nn1
    bruteforce.nn1 = lambda t, m, q: nn1_mod.nn1_plain(t, m, q)
    try:
        h_plain = float(geometry.hausdorff(a_.xyz, a_.mask, b_.xyz, b_.mask))
    finally:
        bruteforce.nn1 = kernel_nn1
    print(f"phase 10: (j) Hausdorff with B1 {h_kernel!r}, with its plain version {h_plain!r}, "
          f"the tool {h_tool!r}", flush=True)
    expect(h_kernel == h_plain and abs(h_tool - h_kernel) <= 5e-7,
           "(j) Hausdorff with B1 differs from its plain version or the tool")

    # B1 against its plain version at (a)'s shape, timed beside its bound
    seen = []
    kernel_nn1 = bruteforce.nn1

    def capture(t, m, q):
        seen.append((t, m, q))
        return kernel_nn1(t, m, q)

    bruteforce.nn1 = capture
    try:
        fpcs.fpcs_align(src, tgt)
    finally:
        bruteforce.nn1 = kernel_nn1
    t_, m_, q_ = seen[-1]
    ik, dk = nn1_mod.nn1(t_, m_, q_)
    ip, dp = nn1_mod.nn1_plain(t_, m_, q_)
    ms = cuda_ms(lambda: nn1_mod.nn1(t_, m_, q_), reps=5)
    plain_ms = cuda_ms(lambda: nn1_mod.nn1_plain(t_, m_, q_), reps=1)
    bound_s, bound_by = nn1_bound_ms(len(q_), len(t_))
    nd, dd = int((ik != ip).sum()), float((dk - dp).abs().max())
    print(f"phase 10: nn1 at (a)'s shape {len(q_)} x {len(t_)}: {ms:.3f} ms, bound "
          f"{bound_s * 1e3:.3f} ms ({bound_by}), plain {plain_ms:.1f} ms; against plain: "
          f"{nd} indices differ, max |d2 diff| {dd:.3e} [{card_line()}]", flush=True)
    expect(nd == 0 and dd == 0.0, "B1 differs from its plain version at (a)'s shape")
    record_b1["path_h"] = {"q": len(q_), "m": len(t_), "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound_s * 1e3, "bound_by": bound_by, "max_abs_err": dd}

    # the card against the port's CPU run on 2,048-voxel subclouds, the same draws
    def sub2k(c):
        return c.take(torch.nonzero(c.mask)[:H_CPU_POINTS, 0])

    s2, t2 = sub2k(src), sub2k(tgt)
    s2c, t2c = (Cloud(xyz=c.xyz.cpu(), mask=c.mask.cpu(),
                      attrs={"normal": c.attrs["normal"].cpu()}) for c in (s2, t2))
    g = torch.Generator().manual_seed(E_SEED)
    d3 = fpcs.draw_fpcs_samples(s2c.mask, t2c.mask, 64, 512, 8, 128, g)
    d4 = fpcs.draw_fpcs4_samples(s2c.mask, t2c.mask, 32, 256, 128, g)
    dp_ = ppf.draw_ppf_samples(s2c.mask, t2c.mask, 192, 32, 192, g)
    # (a) matches within one voxel: at its default 0.05 m no drawn pair of
    # these 0.3 m voxels matched a base, and every error was +inf
    checks = [
        ("a", lambda s, t, d: fpcs.fpcs_scores(s, t, *d, delta=E_LEAF), d3),
        ("c", lambda s, t, d: fpcs.fpcs4_scores(s, t, *d, pairs_per_base=128, n_hyp=512), d4),
    ]
    for tag, fn, draws in checks:
        Tk, ek = fn(s2, t2, [x.to(dev) for x in draws])
        Tc, ec = fn(s2c, t2c, draws)
        ek, Tk = ek.cpu(), Tk.cpu()
        bk, bc = int(torch.argmin(ek)), int(torch.argmin(ec))
        margin = runner_up_margin(ec)
        tdiff = pose_gap(Tk[bk], Tc[bc])
        fin = torch.isfinite(ec)
        same_set = torch.equal(torch.isfinite(ek), fin)
        both = fin & torch.isfinite(Tc).all(-1).all(-1) & torch.isfinite(Tk).all(-1).all(-1)
        worst_t = float((Tk[both] - Tc[both]).abs().max()) if bool(both.any()) else 0.0
        worst_e = float(((ek - ec).abs() / ec.abs().clamp(min=1e-6))[fin].max()) \
            if bool(fin.any()) else 0.0
        print(f"phase 10: card against CPU ({tag}) on {H_CPU_POINTS}-voxel subclouds: "
              f"{int(fin.sum())} of {len(ec)} hypotheses valid on both: {same_set}; max "
              f"|T diff| {worst_t:.3e}, max relative error diff {worst_e:.3e}; best {bk} / {bc} "
              f"(runner-up {margin:.2e} behind), {tdiff[0]:.3e} m, {tdiff[1]:.3e} rad", flush=True)
        expect(same_set and bool(fin.any()), f"({tag}) no live hypothesis, or not the same set")
        if margin > 1e-5:
            expect(bk == bc and tdiff[0] <= 1e-4 and tdiff[1] <= 1e-4,
                   f"({tag}) on the card chose another hypothesis than on the CPU")
    pk = ppf.ppf_core(s2, t2, *(x.to(dev) for x in dp_))
    pcpu = ppf.ppf_core(s2c, t2c, *dp_)
    pdiff = pose_gap(pk.transform, pcpu.transform)
    print(f"phase 10: card against CPU (e): votes {int(pk.votes)} / {int(pcpu.votes)}, "
          f"{pdiff[0]:.3e} m, {pdiff[1]:.3e} rad", flush=True)
    expect(int(pk.votes) == int(pcpu.votes) and max(pdiff) <= 1e-4, "(e) card against CPU")
    k2s, k2t = (live_rows(c).take(torch.arange(min(H_CPU_KEYPOINTS, int(c.mask.sum())),
                                               device=c.xyz.device)) for c in (ks, kt))
    hk = fpcs.fpcs4_align_host(k2s, k2t)
    hc = fpcs.fpcs4_align_host(*(Cloud(xyz=c.xyz.cpu(), mask=c.mask.cpu()) for c in (k2s, k2t)))
    hdiff = pose_gap(hk.transform, hc.transform)
    print(f"phase 10: card against CPU (d) on {H_CPU_KEYPOINTS} keypoints each: errors "
          f"{float(hk.error):.6f} / {float(hc.error):.6f}, {hdiff[0]:.3e} m, {hdiff[1]:.3e} rad",
          flush=True)
    expect(bool(hk.valid) == bool(hc.valid) and max(hdiff) <= 1e-4, "(d) card against CPU")
    # LM's accept test is a float32 decision, and along the street its system
    # is nearly singular (ROADMAP C22): once the device's rounding flips one
    # accept, the runs take other steps (3.9e-3 m apart after ten iterations,
    # 1.1e-4 m after sixty), so they are compared after the first two, as
    # NDT's Armijo test is (C13)
    nl_kw = dict(E_ICP_KW, max_iterations=2)
    nk = icp_nl(s2, t2, init_transform=T0, warp="rigid_6d", **nl_kw)
    nc = icp_nl(s2c, t2c, init_transform=T0.cpu(), warp="rigid_6d", **nl_kw)
    ndiff = pose_gap(nk.transform, nc.transform)
    print(f"phase 10: card against CPU (f): {int(nk.iterations)} / {int(nc.iterations)} "
          f"iterations, {ndiff[0]:.3e} m, {ndiff[1]:.3e} rad", flush=True)
    expect(max(ndiff) <= 1e-4, "(f) card against CPU")
    small = [sub2k(c) for c in c_clouds]
    inc_k, inc_c = IncrementalRegistration(**ICP_KW), IncrementalRegistration(**ICP_KW)
    for c in small:
        inc_k.register_cloud(c)
        inc_c.register_cloud(Cloud(xyz=c.xyz.cpu(), mask=c.mask.cpu(),
                                   attrs={"normal": c.attrs["normal"].cpu()}))
    idiff = pose_gap(inc_k.absolute_transform, inc_c.absolute_transform)
    print(f"phase 10: card against CPU (h) on {H_CPU_POINTS}-voxel scans: last pose "
          f"{idiff[0]:.3e} m, {idiff[1]:.3e} rad", flush=True)
    expect(max(idiff) <= 1e-4, "(h) card against CPU")
    check(not failed, "path H: " + "; ".join(failed))
    return parts


def path_i_inputs(scans, golden, src, tgt):
    """Path I's inputs as host arrays, the same for every rank: path A's
    120k pair; path C's pair 1 -> 0 (downsampled, normals); path D's
    downsampled pair 1 -> 0 (the voxels only) and its NDT target, the raw scan
    0, with pair 1's prior; path F (e)'s graph; path G's first frames."""
    from scipy.spatial.transform import Rotation

    from pcl_tpu_torch import features, filters
    from pcl_tpu_torch.core.cloud import compact, from_numpy

    d = {"a/src": src, "a/tgt": tgt}
    raw = [from_numpy(s, capacity=SCAN_CAPACITY) for s in scans[:2]]
    ds = [filters.voxel_downsample(c, LEAF) for c in raw]
    nc = [features.estimate_normals(c, k=NORMAL_K) for c in ds]
    for name, c in (("src", nc[1]), ("tgt", nc[0])):
        d[f"c/{name}"], d[f"c/{name}_mask"] = c.xyz.cpu().numpy(), c.mask.cpu().numpy()
    d["c/tgt_normals"] = nc[0].attrs["normal"].cpu().numpy()
    for name, c in (("src", ds[1]), ("tgt", ds[0])):
        n = int(c.mask.sum())
        d[f"d/{name}"] = compact(c).xyz[:n].cpu().numpy()
    d["d/ndt_tgt"] = scans[0]
    d["step"] = np.linalg.inv(golden[0]) @ golden[1]
    # pair 1's prior as path D draws it (NDT_PRIOR_ERROR, seed 6)
    prior_rng = np.random.default_rng(6)
    off = np.eye(4)
    dd = np.append(prior_rng.normal(size=2), 0.0)
    axis = prior_rng.normal(size=3)
    off[:3, 3] = dd * NDT_PRIOR_ERROR[0] / np.linalg.norm(dd)
    off[:3, :3] = Rotation.from_rotvec(axis * NDT_PRIOR_ERROR[1] / np.linalg.norm(axis)).as_matrix()
    d["d/prior"] = (off @ d["step"]).astype(np.float32)
    G, init, edges = kitti_graph(F_KITTI_V, F_KITTI_LOOPS, F_KITTI_C, F_SEED)
    d["f/golden"], d["f/init"] = G, init
    for k, e in zip(("es", "ed", "cs", "cd", "cv"), edges):
        d[f"f/{k}"] = e.cpu().numpy()
    from pcl_tpu_torch.fusion import Intrinsics
    intr = Intrinsics(*G_INTR)
    rng = np.random.default_rng(G_SEED)
    poses = handheld(rng, G_FRAMES)[:I_FRAMES]
    d["g/poses"] = poses.astype(np.float32)
    d["g/frames"] = np.stack([render_depth(P, intr, *G_SHAPE, rng)[0] for P in poses])
    return d


def path_i_run(mesh, d, tag):
    """Path I's calls on ``mesh``, every rank alike: returns the outputs (host
    arrays; TSDF slabs as digests of their bytes) and, per call, the seconds,
    the iterations (frames for TSDF), the collectives and their bytes, and the
    B1 and B2 launches of this rank."""
    from pcl_tpu_torch.fusion import Intrinsics, WorldModel, make_volume
    from pcl_tpu_torch.ops import nn1 as nn1_mod
    from pcl_tpu_torch.ops import segsum
    from pcl_tpu_torch.parallel import (sharded_gicp, sharded_icp, sharded_lum,
                                        sharded_ndt)
    from pcl_tpu_torch.parallel.tsdf_sharded import (integrate_sharded, raycast_sharded,
                                                     shift_sharded)

    dev = mesh.device
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in d.items()}
    out, stats = {}, {}

    def ones(x):
        return torch.ones(len(x), dtype=torch.bool, device=dev)


    def call(name, fn, n):
        mesh.counts.clear()
        b1, b2 = launch_count("nn1"), launch_count("segsum")
        r, secs = timed(fn)
        stats[name] = {"s": secs, "n": n, "b1": launch_count("nn1") - b1,
                       "b2": launch_count("segsum") - b2,
                       "collectives": {k: list(v) for k, v in mesh.counts.items()}}
        c = stats[name]
        print(f"{tag}: {name}: {secs * 1e3:.1f} ms, {secs * 1e3 / n:.3f} ms per "
              f"{'frame' if name == 'tsdf' else 'iteration'} ({n}); collectives "
              + ", ".join(f"{k} {v[0]} ({v[1]} B)" for k, v in c["collectives"].items())
              + f"; B1 {c['b1']}, B2 {c['b2']}", flush=True)
        return r

    T, _, _ = call("icp A", lambda: sharded_icp(mesh, t["a/src"], ones(t["a/src"]), t["a/tgt"],
                                                ones(t["a/tgt"]), max_iterations=30), 30)
    out["icp A"] = T.cpu().numpy()
    T, _, _ = call("icp C", lambda: sharded_icp(
        mesh, t["c/src"], t["c/src_mask"], t["c/tgt"], t["c/tgt_mask"],
        tgt_normals=t["c/tgt_normals"], max_corr_dist=ICP_KW["max_corr_dist"],
        max_iterations=ICP_KW["max_iterations"], variant="point_to_plane",
        corr_backend="cell", cell_cap=ICP_KW["cell_cap"]), ICP_KW["max_iterations"])
    out["icp C"] = T.cpu().numpy()
    T, _, _ = call("gicp D", lambda: sharded_gicp(
        mesh, t["d/src"], ones(t["d/src"]), t["d/tgt"], ones(t["d/tgt"]),
        max_corr_dist=GICP_KW["max_corr_dist"], max_iterations=I_GICP_ITERS,
        k_covariances=GICP_K), I_GICP_ITERS)
    out["gicp D"] = T.cpu().numpy()
    holder = {}

    def run_ndt():
        holder["r"] = sharded_ndt(mesh, t["d/src"], ones(t["d/src"]), t["d/ndt_tgt"],
                                  ones(t["d/ndt_tgt"]), init_transform=t["d/prior"], **NDT_KW)
        return holder["r"]

    T, _, it = call("ndt D", run_ndt, 1)
    stats["ndt D"]["n"] = int(it)
    out["ndt D"] = T.cpu().numpy()
    edges = [t[f"f/{k}"] for k in ("es", "ed", "cs", "cd", "cv")]
    r = call("lum F", lambda: sharded_lum(mesh, t["f/init"], *edges,
                                          max_iterations=F_KITTI_ITERS),
             F_KITTI_ITERS * 48)
    out["lum F"] = r.poses.cpu().numpy()
    out["lum F golden"] = sharded_lum(mesh, t["f/golden"].float(), *edges,
                                      max_iterations=2).poses.cpu().numpy()

    intr = Intrinsics(*G_INTR)
    H, W = G_SHAPE

    def fuse():
        vol = make_volume(G_RES, G_SIZE, origin=G_ORIGIN, device=dev)
        for k in range(I_FRAMES):
            vol = integrate_sharded(mesh, vol, t["g/frames"][k], intr, t["g/poses"][k])
        return vol

    vol = call("tsdf", fuse, I_FRAMES)
    out["slab"] = np.asarray([digest(vol.tsdf), digest(vol.weight)])
    pose = t["g/poses"][-1]
    verts, nrm, hit = call("raycast", lambda: raycast_sharded(mesh, vol, intr, pose, H, W), 1)
    out.update({"verts": verts.cpu().numpy(), "normals": nrm.cpu().numpy(),
                "hit": hit.cpu().numpy()})
    vol2, ev_t, ev_w, ev_origin = call("shift", lambda: shift_sharded(mesh, vol), 1)
    wm = WorldModel(float(vol.voxel_size), world_origin=vol.origin.cpu().numpy())
    wm.push_slab(float(ev_origin[0]), ev_t, ev_w)
    back_t, back_w = wm.fetch_slab(float(ev_origin[0]), tuple(ev_t.shape))
    out["world model"] = np.asarray(bool(np.array_equal(back_t, ev_t.cpu().numpy())
                                         and np.array_equal(back_w, ev_w.cpu().numpy())))
    out["evicted"] = np.asarray([digest(ev_t), digest(ev_w)])
    out["shifted"] = np.asarray([digest(vol2.tsdf), digest(vol2.weight)])
    return out, stats, vol


def path_i_warmup(mesh, d):
    """Each sharded function once on small inputs (libraries, the NCCL
    communicator, the allocator), outside the counts."""
    from pcl_tpu_torch.parallel import sharded_gicp, sharded_icp, sharded_lum, sharded_ndt

    dev = mesh.device
    a = torch.from_numpy(d["d/src"][:4096]).to(dev)
    b = torch.from_numpy(d["d/tgt"][:4096]).to(dev)
    m = torch.ones(len(a), dtype=torch.bool, device=dev)
    sharded_icp(mesh, a, m, b, m, max_iterations=2)
    sharded_gicp(mesh, a, m, b, m, max_corr_dist=1.0, max_iterations=2)
    sharded_ndt(mesh, a, m, b, m, max_iterations=2, **{"resolution": 2.0})
    e = [torch.from_numpy(d[f"f/{k}"][:64]).to(dev) for k in ("es", "ed", "cs", "cd", "cv")]
    sharded_lum(mesh, torch.from_numpy(d["f/init"]).to(dev), *e, max_iterations=1,
                cg_iters=2)
    torch.cuda.synchronize()


def path_i_rank(rank: int, workdir: str) -> int:
    """One of the I_RANKS processes of path I (b): ranks that share the card
    join under gloo, run path I's calls and save their outputs."""
    import torch.distributed as dist

    from pcl_tpu_torch.parallel import make_mesh, runtime

    runtime.initialize_multihost(init_method=f"file://{workdir}/store",
                                 num_processes=I_RANKS, process_id=rank)
    mesh = make_mesh()
    check(mesh.backend == "gloo" and mesh.device.type == "cuda",
          f"rank {rank}: backend {mesh.backend} on {mesh.device}")
    d = dict(np.load(os.path.join(workdir, "inputs.npz")))
    path_i_warmup(mesh, d)
    out, stats, _ = path_i_run(mesh, d, f"phase 11 (b) rank {rank}")
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(stats, f)
    dist.destroy_process_group()
    return 0


def tsdf_gap_voxels(vol_a, vol_b, d, intr):
    """Voxels where two fused volumes differ, and how many of them lie
    within 1e-4 pixel of a half pixel or within 1e-6 m of the truncation
    band's edge in some frame (ROADMAP C27), in float64."""
    diff = (vol_a.tsdf != vol_b.tsdf) | (vol_a.weight != vol_b.weight)
    idx = torch.nonzero(diff.reshape(-1))[:, 0].cpu().numpy()
    R = vol_a.tsdf.shape[0]
    g = np.stack([idx // (R * R), (idx // R) % R, idx % R], 1).astype(np.float64)
    world = np.asarray(G_ORIGIN) + (g + 0.5) * (G_SIZE / R)
    trunc = float(vol_a.trunc)
    excused = np.zeros(len(idx), bool)
    for P, depth in zip(d["g/poses"].astype(np.float64), d["g/frames"]):
        w2c = np.linalg.inv(P)
        c = world @ w2c[:3, :3].T + w2c[:3, 3]
        z = np.maximum(c[:, 2], 1e-9)
        u = intr.fx * c[:, 0] / z + intr.cx
        v = intr.fy * c[:, 1] / z + intr.cy
        half = lambda a: np.abs(a - np.floor(a) - 0.5) < 1e-4  # noqa: E731
        ui = np.clip(np.round(u), 0, depth.shape[1] - 1).astype(int)
        vi = np.clip(np.round(v), 0, depth.shape[0] - 1).astype(int)
        band = np.abs(depth[vi, ui] - c[:, 2] + trunc) < 1e-6
        excused |= half(u) | half(v) | band
    return len(idx), int(excused.sum())


def phase11_path_i(segsum, nn1_mod, scans, golden, src, tgt, M, record_b1, record_b2):
    """Path I: the sharded functions at full width on one card, (a) one rank
    under NCCL in this process against the single-device functions, (b)
    I_RANKS ranks sharing the card under gloo against (a)."""
    import torch.distributed as dist

    from pcl_tpu_torch.core.cloud import make_cloud
    from pcl_tpu_torch.core.transforms import transform_points
    from pcl_tpu_torch.fusion import Intrinsics, integrate, make_volume, raycast
    from pcl_tpu_torch.parallel import make_mesh
    from pcl_tpu_torch.registration import trajectory
    from pcl_tpu_torch.registration.gicp import gicp
    from pcl_tpu_torch.registration.graph import lum
    from pcl_tpu_torch.registration.icp import icp
    from pcl_tpu_torch.registration.ndt import ndt
    from pcl_tpu_torch.tools import odometry as odometry_tool

    d, secs = timed(lambda: path_i_inputs(scans, golden, src, tgt))
    print(f"phase 11: path I inputs in {secs:.1f} s: path C pair {int(d['c/src_mask'].sum())} / "
          f"{int(d['c/tgt_mask'].sum())} voxels, path D pair {len(d['d/src'])} / "
          f"{len(d['d/tgt'])}, LUM V={F_KITTI_V} E={len(d['f/es'])}, {I_FRAMES} VGA frames",
          flush=True)
    check(not dist.is_initialized(), "a process group exists before path I")
    mesh = make_mesh()
    check(mesh.backend == "nccl" and mesh.shape == {"points": 1},
          f"one rank: backend {mesh.backend}, mesh {mesh.shape}")
    path_i_warmup(mesh, d)
    trace.reset()
    out_a, stats_a, vol_a = path_i_run(mesh, d, "phase 11 (a) NCCL, one rank")
    record_b1["launches_by_path"]["I"] = launch_count("nn1")
    record_b2["launches_by_path"]["I"] = launch_count("segsum")
    print(f"phase 11: (a) launches B1 {launch_count('nn1')}, B2 "
          f"{launch_count('segsum')} [{card_line()}]", flush=True)
    # B1 once an iteration behind the brute correspondences (path C's ICP takes
    # the cell list), B2 once for NDT's grid
    check(stats_a["icp A"]["b1"] == 30 and stats_a["gicp D"]["b1"] == I_GICP_ITERS
          and stats_a["ndt D"]["b2"] == 1,
          "(a) launches: " + ", ".join(f"{k} B1 {v['b1']} B2 {v['b2']}"
                                        for k, v in stats_a.items()))
    check(stats_a["icp A"]["collectives"]["psum"] == [30, 30 * 18 * 4],
          "(a) icp A: not one 18-float all-reduce an iteration")

    # (a) against the single-device functions on the same inputs
    dev = torch.device("cuda")
    ref = {}

    def single(name, fn, n_of):
        r, secs = timed(fn)
        n = n_of(r)
        ref[name] = r
        print(f"phase 11: single-device {name}: {secs * 1e3:.1f} ms, {secs * 1e3 / n:.3f} ms per "
              f"{'frame' if name == 'tsdf' else 'iteration'} ({n})", flush=True)
        return r

    def cl(k, m=None):
        return make_cloud(d[k], None if m is None else d[m])

    sa, ta = cl("a/src"), cl("a/tgt")
    single("icp A", lambda: icp(sa, ta, max_iterations=30), lambda r: int(r.iterations))
    c_src = cl("c/src", "c/src_mask")
    c_tgt = cl("c/tgt", "c/tgt_mask").with_attrs(
        normal=torch.from_numpy(d["c/tgt_normals"]).to(dev))
    single("icp C", lambda: icp(c_src, c_tgt, **ICP_KW), lambda r: int(r.iterations))
    ds, dt_ = cl("d/src"), cl("d/tgt")
    single("gicp D", lambda: gicp(ds, dt_, **GICP_KW, **odometry_tool.probed_cells(
        ds, dt_, "gicp", GICP_KW["max_corr_dist"])), lambda r: int(r.iterations))
    single("ndt D", lambda: ndt(ds, cl("d/ndt_tgt"), init_transform=torch.from_numpy(
        d["d/prior"]).to(dev), **NDT_KW), lambda r: int(r.iterations))
    edges = [torch.from_numpy(d[f"f/{k}"]).to(dev) for k in ("es", "ed", "cs", "cd", "cv")]
    single("lum F", lambda: lum(torch.from_numpy(d["f/init"]).to(dev), *edges,
                                max_iterations=F_KITTI_ITERS, solver="cg"),
           lambda r: int(r.iterations) * 48)
    intr = Intrinsics(*G_INTR)
    H, W = G_SHAPE

    def fuse():
        vol = make_volume(G_RES, G_SIZE, origin=G_ORIGIN)
        for k in range(I_FRAMES):
            vol = integrate(vol, torch.from_numpy(d["g/frames"][k]).to(dev), intr,
                            torch.from_numpy(d["g/poses"][k]).to(dev))
        return vol

    vol_s = single("tsdf", fuse, lambda r: I_FRAMES)
    rc_s = single("raycast", lambda: raycast(vol_s, intr, torch.from_numpy(
        d["g/poses"][-1]).to(dev), H, W), lambda r: 1)

    # each result against its path's limit, and against the single-device run
    step = torch.from_numpy(d["step"])
    limits = {}
    dt, dang = residual_motion(torch.from_numpy(out_a["icp A"]), M)
    limits["icp A"] = (dt <= 1e-3 and dang <= 0.01, f"{dt:.2e} m, {dang:.2e} deg of M left")
    for name in ("icp C", "gicp D"):
        g = pose_gap(torch.from_numpy(out_a[name]), step)
        limits[name] = (g[0] <= 0.03, f"{g[0]:.4f} m, {g[1]:.2e} rad from the true step")
    from scipy.spatial.transform import Rotation
    left = out_a["ndt D"].astype(np.float64) @ np.linalg.inv(d["step"])
    rot = float(np.linalg.norm(Rotation.from_matrix(left[:3, :3]).as_rotvec()))
    limits["ndt D"] = (np.linalg.norm(left[:2, 3]) <= 0.015 and rot <= 5e-4,
                       f"left of the prior: {np.linalg.norm(left[:2, 3]):.4f} m across and "
                       f"up, {rot:.2e} rad")
    ate_f = trajectory.trajectory_ate(out_a["lum F golden"].astype(np.float64), d["f/golden"],
                                      align=False).rmse
    limits["lum F"] = (ate_f <= F_KITTI_TRUTH_ATE and bool(np.isfinite(out_a["lum F"]).all()),
                       f"from the golden poses ATE {ate_f:.4f} m")
    gaps = {}
    for name, (ok, what) in limits.items():
        mine = torch.from_numpy(out_a[name])
        theirs = ref[name].poses if name == "lum F" else ref[name].transform[None]
        g = [pose_gap(a, b) for a, b in zip(mine.reshape(-1, 4, 4), theirs)]
        gaps[name] = (max(x[0] for x in g), max(x[1] for x in g))
        print(f"phase 11: (a) {name}: {what}; against the single-device function "
              f"{gaps[name][0]:.3e} m, {gaps[name][1]:.3e} rad", flush=True)
        check(ok, f"(a) {name} misses its path's limit: {what}")
    # the same arithmetic on one rank as ndt and lum(solver="cg"); ICP's
    # Umeyama from moments (point-to-point) and its sums (point-to-plane),
    # and GICP's brute covariances against gicp's cell-list ones, differ
    for name in ("ndt D", "lum F"):
        check(max(gaps[name]) <= I_POSE_TOL, f"(a) sharded {name} differs from the "
              f"single-device function by {gaps[name]}")
    n_diff, n_excused = tsdf_gap_voxels(vol_a, vol_s, d, intr)
    print(f"phase 11: (a) TSDF after {I_FRAMES} frames: {n_diff} of {G_RES ** 3} voxels differ "
          f"from integrate's, {n_excused} of them within 1e-4 px of a half pixel or 1e-6 m of "
          f"the band (C27)", flush=True)
    check(n_diff == n_excused, "(a) the sharded volume differs from integrate's")
    hit_s = rc_s[2].cpu().numpy()
    vdiff = float(np.abs(out_a["verts"] - rc_s[0].cpu().numpy()).max())
    print(f"phase 11: (a) raycast: {int(hit_s.sum())} hits, equal to raycast's "
          f"{bool(np.array_equal(out_a['hit'], hit_s))}, max |v - v_raycast| {vdiff:.3e} m; "
          f"world model round trip {bool(out_a['world model'])}", flush=True)
    check(np.array_equal(out_a["hit"], hit_s) and vdiff <= 1e-6,
          "(a) sharded raycast differs from raycast")
    check(bool(out_a["world model"]), "(a) the evicted slab does not round-trip")
    del vol_s, rc_s, ref
    mesh.close()
    check(not dist.is_initialized(), "(a) the one-rank group outlived its mesh")
    torch.cuda.empty_cache()

    # B1 against its plain version at the shapes path I gives it, after the
    # counts were read: sharded GICP's shard (the whole source at one rank,
    # rank 0's block at I_RANKS) against its target, and rank 0's block of
    # path A's source at I_RANKS against path A's target (one rank's 120k x
    # 120k is phase 1's main case); the queries are the shards moved by the
    # final transforms, as a next iteration would give them
    record_b1["path_i"] = []
    for name, T, sx, tx in (
            ("sharded GICP, one rank", out_a["gicp D"], d["d/src"], d["d/tgt"]),
            (f"sharded GICP, rank 0 of {I_RANKS}", out_a["gicp D"],
             d["d/src"][:-(-len(d["d/src"]) // I_RANKS)], d["d/tgt"]),
            (f"sharded ICP on path A, rank 0 of {I_RANKS}", out_a["icp A"],
             d["a/src"][:-(-len(d["a/src"]) // I_RANKS)], d["a/tgt"])):
        q = transform_points(torch.from_numpy(T).to(dev),
                             torch.from_numpy(np.ascontiguousarray(sx)).to(dev))
        t = torch.from_numpy(np.ascontiguousarray(tx)).to(dev)
        m = torch.ones(len(t), dtype=torch.bool, device=dev)
        err, _ = nn1_against_plain(nn1_mod, f"at {name}'s shape", t, m, q, tag="phase 11")
        ms = cuda_ms(lambda: nn1_mod.nn1(t, m, q), reps=10)
        plain_ms = cuda_ms(lambda: nn1_mod.nn1_plain(t, m, q), reps=1)
        bound_s, bound_by = nn1_bound_ms(len(q), len(t))
        print(f"phase 11: nn1 at {name}'s shape {len(q)} x {len(t)}: {ms:.3f} ms, plain "
              f"{plain_ms:.1f} ms, bound {bound_s * 1e3:.3f} ms ({bound_by}) [{card_line()}]",
              flush=True)
        record_b1["path_i"].append({"case": name, "q": len(q), "m": len(t), "ms": ms,
                                    "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
                                    "bound_by": bound_by, "max_abs_err": err})

    # (b) I_RANKS ranks sharing the card under gloo
    with tempfile.TemporaryDirectory() as work:
        np.savez(os.path.join(work, "inputs.npz"), **d)
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--path-i-rank",
                                   str(r), work]) for r in range(I_RANKS)]
        t0 = time.perf_counter()
        # all ranks polled together: when one fails or time runs out, the
        # rest (blocked in a collective) are killed at once
        while (any(p.poll() is None for p in procs) and time.perf_counter() - t0 < I_JOIN_S
               and not any(p.poll() for p in procs)):
            time.sleep(0.2)
        killed = [p.poll() is None for p in procs]
        for p, k in zip(procs, killed):
            if k:
                p.kill()
                p.wait()
        codes = [p.returncode for p in procs]
        print(f"phase 11: (b) {I_RANKS} gloo ranks exited {codes} in "
              f"{time.perf_counter() - t0:.1f} s (killed: {killed})", flush=True)
        check(codes == [0] * I_RANKS, f"(b) a rank failed: exit codes {codes}")
        outs = [dict(np.load(os.path.join(work, f"rank{r}.npz"))) for r in range(I_RANKS)]
        stats = []
        for r in range(I_RANKS):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                stats.append(json.load(f))
    Rl = G_RES // I_RANKS
    slabs = [[digest(x[k * Rl:(k + 1) * Rl]) for x in (vol_a.tsdf, vol_a.weight)]
             for k in range(I_RANKS)]
    # the evicted slab of I_RANKS ranks is (a)'s first Rl planes; rank r's slab
    # after the shift is (a)'s slab r + 1, the last rank's enters empty
    evicted = slabs[0]
    empty = torch.ones_like(vol_a.tsdf[:Rl])
    shifted = slabs[1:] + [[digest(empty), digest(torch.zeros_like(empty))]]
    for r, (o, st) in enumerate(zip(outs, stats)):
        for name in ("icp A", "icp C", "gicp D", "ndt D"):
            g = pose_gap(torch.from_numpy(o[name]), torch.from_numpy(out_a[name]))
            print(f"phase 11: (b) rank {r} {name}: {g[0]:.3e} m, {g[1]:.3e} rad from (a)",
                  flush=True)
            check(g[0] <= I_POSE_TOL and g[1] <= I_POSE_TOL, f"(b) rank {r} {name} off (a)")
        # LUM from the drifted poses moves poses up to ~360 m from the origin
        # (float32 resolution 3e-5 m there) and diverges (ROADMAP C31), so
        # its translations are held to I_POSE_TOL plus 2^-20 (8 ulp) of their
        # distance from the origin; from the golden poses to I_POSE_TOL
        gl = [pose_gap(torch.from_numpy(a), torch.from_numpy(b))
              for a, b in zip(o["lum F"], out_a["lum F"])]
        excess = max(g[0] - 2.0 ** -20 * float(np.linalg.norm(b[:3, 3]))
                     for g, b in zip(gl, out_a["lum F"]))
        gl = (max(x[0] for x in gl), max(x[1] for x in gl))
        gg = [pose_gap(torch.from_numpy(a), torch.from_numpy(b))
              for a, b in zip(o["lum F golden"], out_a["lum F golden"])]
        gg = (max(x[0] for x in gg), max(x[1] for x in gg))
        vdiff = float(np.abs(o["verts"] - out_a["verts"]).max())
        print(f"phase 11: (b) rank {r} lum F from the golden poses: {gg[0]:.3e} m, {gg[1]:.3e} "
              f"rad from (a); from the drifted poses {gl[0]:.3e} m ({excess:.3e} m beyond 8 ulp "
              f"of the distance), {gl[1]:.3e} rad; TSDF slab "
              f"bitwise (a)'s {list(o['slab']) == slabs[r]}; raycast hits equal "
              f"{bool(np.array_equal(o['hit'], out_a['hit']))}, max |v - v_a| {vdiff:.3e} m; "
              f"evicted slab bitwise {list(o['evicted']) == evicted}", flush=True)
        check(max(gg) <= I_POSE_TOL, f"(b) rank {r} LUM from the golden poses off (a)")
        check(excess <= I_POSE_TOL and gl[1] <= I_POSE_TOL, f"(b) rank {r} LUM off (a)")
        check(list(o["slab"]) == slabs[r], f"(b) rank {r}: TSDF slab differs from (a)'s")
        check(np.array_equal(o["hit"], out_a["hit"]) and vdiff <= 1e-6,
              f"(b) rank {r}: raycast differs from (a)")
        check(list(o["evicted"]) == evicted and bool(o["world model"]),
              f"(b) rank {r}: evicted slab differs from (a)'s")
        check(list(o["shifted"]) == shifted[r], f"(b) rank {r}: shifted slab is not (a)'s next")
        for name in ("icp A", "gicp D"):
            check(st[name]["b1"] > 0, f"(b) rank {r} {name} launched no B1")
        check(st["ndt D"]["b2"] == 1, f"(b) rank {r} ndt D launched B2 {st['ndt D']['b2']} times")
    table = []
    for name in ("icp A", "icp C", "gicp D", "ndt D", "lum F", "tsdf", "raycast", "shift"):
        one = stats_a[name]
        two = [st[name] for st in stats]
        per = lambda c: c["s"] * 1e3 / max(c["n"], 1)  # noqa: E731
        table.append({"call": name, "ms_one_rank": per(one),
                      "ms_two_ranks": max(per(c) for c in two),
                      "collectives_per_unit": {k: [v[0] / max(one["n"], 1), v[1] / max(one["n"], 1)]
                                               for k, v in one["collectives"].items()},
                      "b1_per_rank": [one["b1"]] + [c["b1"] for c in two],
                      "b2_per_rank": [one["b2"]] + [c["b2"] for c in two]})
    print("phase 11: summary " + json.dumps(table) + f" [{card_line()}]", flush=True)
    return table


def digest(x: torch.Tensor) -> str:
    """SHA-256 of a tensor's bytes: two tensors with equal digests are
    bitwise equal."""
    import hashlib
    return hashlib.sha256(x.contiguous().cpu().numpy().tobytes()).hexdigest()


def filter_front(cloud):
    """Path J's filters before the voxel grid: the crop box, statistical and
    radius outlier removal, and the ground found by the progressive
    morphological filter (with the street's up axis as z). Returns the
    filtered cloud, its ground mask and each stage's seconds."""
    from pcl_tpu_torch import filters
    from pcl_tpu_torch.core.transforms import transform_cloud

    secs = {}
    c, secs["crop"] = timed(lambda: filters.crop_box(cloud, (-J_BOX,) * 3, (J_BOX,) * 3))
    c, secs["sor"] = timed(lambda: filters.statistical_outlier_removal(c, **J_SOR))
    c, secs["ror"] = timed(lambda: filters.radius_outlier_removal(c, **J_ROR))
    up = torch.from_numpy(J_UP).to(cloud.xyz.device)
    ground, secs["pmf"] = timed(lambda: filters.progressive_morphological_filter(
        transform_cloud(up, c), **J_PMF))
    return c, ground, secs


def sor_margin(cloud, mean_k=J_SOR["mean_k"], stddev_mult=J_SOR["stddev_mult"]):
    """Per point: whether its mean k-NN distance lies within 1e-5 of the
    statistical filter's threshold, or its k-th and (k+1)-th neighbours tie to
    1e-4 (ROADMAP C12); such points may fall either way on another device."""
    from pcl_tpu_torch import search

    k = mean_k
    _, d2, valid = search.knn(cloud, cloud.xyz, k + 2)
    d = torch.sqrt(torch.clamp(d2[:, 1:k + 1], min=0.0))
    v = valid[:, 1:k + 1]
    nv = v.sum(1)
    mean_d = torch.where(v, d, 0.0).sum(1) / torch.clamp(nv, min=1)
    m = cloud.mask & (nv >= k)
    g_mean = mean_d[m].mean()
    thresh = g_mean + stddev_mult * mean_d[m].std()
    tie = (d2[:, k + 1] - d2[:, k]).abs() <= 1e-4 * d2[:, k + 1]
    return ((mean_d - thresh).abs() <= 1e-5 * thresh) | tie


def phase12_path_j(segsum, nn1_mod, scans, golden, record_b1, record_b2):
    """Path J: the filter front end on path C's six scans, then
    voxel_downsample (B2), normals and point-to-plane odometry."""
    from pcl_tpu_torch import filters
    from pcl_tpu_torch.core.cloud import from_numpy
    from pcl_tpu_torch.core.transforms import transform_cloud
    from pcl_tpu_torch.registration import trajectory

    raw = [from_numpy(s, capacity=SCAN_CAPACITY) for s in scans]
    filter_front(raw[1])                                  # warm-up
    trace.reset()
    kept = []
    for i, c in enumerate(raw):
        f, ground, secs = filter_front(c)
        kept.append(f.with_mask(~ground))
        print(f"phase 12: scan {i}: " + ", ".join(f"{k} {v * 1e3:.1f} ms"
                                                  for k, v in secs.items())
              + f"; {int(f.mask.sum())} points after the outlier filters, ground "
              f"{int(ground.sum())}, kept {int(kept[-1].mask.sum())}", flush=True)
        if i == 0:
            f0, g0 = f, ground
    (clouds, poses, results), secs = timed(lambda: front_end(kept))
    launches = launch_count("segsum")
    record_b1["launches_by_path"]["J"] = launch_count("nn1")
    record_b2["launches_by_path"]["J"] = launches
    ate = trajectory.trajectory_ate(poses, golden, align=False)
    print(f"phase 12: front end on the filtered scans {secs * 1e3:.1f} ms: voxels "
          f"{[int(c.mask.sum()) for c in clouds]}, ICP iterations "
          f"{[int(r.iterations) for r, _ in results]}, converged "
          f"{[bool(r.converged) for r, _ in results]}, ATE (unaligned) {ate.rmse:.6f} m; "
          f"B2 launches {launches} [{card_line()}]", flush=True)
    check(launches == N_SCANS, f"path J launched B2 {launches} times for {N_SCANS} scans")

    # the ground: scan 0's frame is the street's (golden[0] is the identity)
    xyz = f0.xyz.cpu().numpy()
    live = f0.mask.cpu().numpy()
    g = g0.cpu().numpy()
    on_ground = live & (np.abs(xyz[:, 1] + 1.7) <= 0.06) & (np.abs(xyz[:, 0]) <= 9.5)
    on_facade = live & (np.abs(xyz[:, 0]) >= 9.95) & (xyz[:, 1] >= -1.7 + 3.5)
    kept_ground = float(g[on_ground].mean())
    facade_ground = float(g[on_facade].mean())
    print(f"phase 12: scan 0 ground mask: {kept_ground:.4f} of {int(on_ground.sum())} ground "
          f"points, {facade_ground:.4f} of {int(on_facade.sum())} facade points 3.5 m up",
          flush=True)
    check(kept_ground >= 0.95, f"the ground mask keeps {kept_ground} of the ground")
    check(facade_ground == 0.0, f"the ground mask takes {facade_ground} of the facades")

    # scan 0's masks on the card against the port's CPU run
    c_cpu = from_numpy(scans[0], capacity=SCAN_CAPACITY, device="cpu")
    (f_cpu, g_cpu, _), csecs = timed(lambda: filter_front(c_cpu))
    margin = sor_margin(filters.crop_box(c_cpu, (-J_BOX,) * 3, (J_BOX,) * 3)).numpy()
    differ = f0.mask.cpu().numpy() != f_cpu.mask.numpy()
    gdiff = g != g_cpu.numpy()
    print(f"phase 12: scan 0 card against CPU ({csecs:.1f} s on the CPU): {int(differ.sum())} "
          f"points differ after the outlier filters ({int((differ & margin).sum())} at the "
          f"threshold's rounding or a neighbour tie, {int(margin.sum())} such points in all); "
          f"ground masks differ on {int((gdiff & ~differ).sum())} points kept by both",
          flush=True)
    check(not (differ & ~margin).any(), "scan 0: the outlier masks differ from the CPU run")
    check(not (gdiff & ~differ).any(), "scan 0: the ground masks differ from the CPU run")

    # more filters, timed on scan 0
    c0 = raw[0]
    times = {}
    for name, fn in (("approximate_voxel_grid", lambda: filters.approximate_voxel_grid(c0, LEAF)),
                     ("farthest_point_sample", lambda: filters.farthest_point_sample(c0, J_FPS)),
                     ("grid_minimum", lambda: filters.grid_minimum(
                         transform_cloud(torch.from_numpy(J_UP).cuda(), c0), 1.0))):
        fn()
        r, times[name] = timed(fn)
        print(f"phase 12: {name} on scan 0: {times[name] * 1e3:.2f} ms, {int(r.mask.sum())} "
              f"points", flush=True)
    check(int(filters.farthest_point_sample(c0, J_FPS).mask.sum()) == J_FPS,
          "farthest_point_sample did not give its samples")
    return {"ate": ate.rmse, **times}


def street_attributes(world: np.ndarray, scan: np.ndarray):
    """Path K's intensity and RGB of scan points, a function of where each
    point lies in the street (``world``, the scene frame) and of its range
    (``scan``, the scanner's frame): a reflectance per surface (ground,
    facades, poles, cars) with a pattern, falling off with range; asphalt
    with lane marks, brick facades with windows, grey poles and a colour per
    car. Returns ``(intensity [N], rgb [N, 3])`` as float32."""
    x, y, z = world[:, 0], world[:, 1], world[:, 2]
    ground = y < -1.55
    facade = np.abs(x) > 9.8
    dz = (z - 5.0) - 10.0 * np.round((z - 5.0) / 10.0)
    pole = ~ground & ~facade & (np.hypot(np.abs(x) - 7.0, dz) < 0.35)
    car = ~(ground | facade | pole)
    pattern = 0.5 + 0.5 * np.sin(1.3 * z) * np.cos(0.9 * x + 0.7 * y)
    refl = np.select([ground, facade, pole], [0.15, 0.45, 0.7], 0.9)
    rng_ = np.linalg.norm(scan, axis=1)
    intensity = refl * (0.8 + 0.4 * pattern) / (1.0 + (rng_ / 40.0) ** 2)
    rgb = np.empty((len(x), 3))
    lane = ground & (np.abs(x) < 0.15) & ((z % 6.0) < 3.0)
    rgb[ground] = (0.22 + 0.12 * pattern[ground])[:, None]
    rgb[lane] = 0.9
    window = facade & ((y + 1.7) % 3.0 > 1.0) & ((z % 4.0) > 1.5)
    rgb[facade] = np.stack([0.55 + 0.25 * pattern, 0.28 + 0.12 * pattern,
                            0.22 + 0.05 * pattern], 1)[facade]
    rgb[window] = np.stack([0.3 + 0.1 * pattern, 0.36 + 0.1 * pattern,
                            0.48 + 0.1 * pattern], 1)[window]
    rgb[pole] = (0.6, 0.6, 0.62)
    palette = np.array([(0.8, 0.1, 0.1), (0.1, 0.2, 0.7), (0.9, 0.9, 0.9), (0.1, 0.1, 0.1),
                        (0.2, 0.6, 0.2), (0.9, 0.7, 0.1), (0.5, 0.5, 0.55), (0.6, 0.3, 0.1),
                        (0.3, 0.7, 0.8), (0.7, 0.2, 0.6)])
    which = np.clip(np.round((z - 10.25) / 19.0), 0, 9).astype(int)
    rgb[car] = palette[which[car]] * (0.85 + 0.15 * pattern[car, None])
    return intensity.astype(np.float32), np.clip(rgb, 0, 1).astype(np.float32)


def path_k_scans(street):
    """Path E's two raw scans (the same draws as phases 7 and 10) as clouds
    with path K's intensity and RGB, and the motion of scan 1."""
    from pcl_tpu_torch.core.cloud import make_cloud

    rng = np.random.default_rng(E_SEED)
    P = pose_matrix(*E_POSE)
    out = []
    for pose in (np.eye(4), P):
        s = scan_at(street, pose, rng)
        inten, rgb = street_attributes(s @ pose[:3, :3].T + pose[:3, 3], s)
        c = make_cloud(s)
        out.append(c.with_attrs(intensity=torch.from_numpy(inten).to(c.xyz.device),
                                rgb=torch.from_numpy(rgb).to(c.xyz.device)))
    return out, P


def k_keypoints(vox, raw):
    """(a) for one scan: Harris 3-D and SUSAN over K_RADIUS, ISS as path H
    takes it, SIFT on the raw scan's intensity. Returns ({name: mask over
    the voxels, or over the raw points for SIFT}, {name: seconds})."""
    from pcl_tpu_torch import keypoints

    out, secs = {}, {}
    out["harris"], secs["harris"] = timed(lambda: keypoints.harris3d_keypoints(
        vox, K_RADIUS, threshold=K_HARRIS_THRESHOLD)[0])
    out["susan"], secs["susan"] = timed(lambda: keypoints.susan_keypoints(vox, K_RADIUS)[0])
    out["iss"], secs["iss"] = timed(lambda: keypoints.iss3d_keypoints(
        vox, H_SALIENT, 0.5 * H_SALIENT, density_weights=True)[0])
    out["sift"], secs["sift"] = timed(lambda: keypoints.sift_keypoints(raw, **K_SIFT)[0])
    return out, secs


def k_descriptors(vox, kidx, gen):
    """(b) for one scan: every descriptor of the slice, at the keypoints
    ``kidx`` where it describes a keypoint (SHOT and BOARD take the voxels as
    search surface; the functions without ``surface`` compute every voxel's
    row and the keypoints' rows are taken), on the voxels otherwise. Returns
    {name: (output, seconds, peak MiB)}."""
    from pcl_tpu_torch import features
    from pcl_tpu_torch.features import color_features, intensity, local_misc, lrf, rops, rsd
    from pcl_tpu_torch.features import shape_context

    kq = vox.take(kidx)
    grad = {}

    def gradient():
        grad["g"] = intensity.intensity_gradient(vox, K_RADIUS)
        return grad["g"][kidx]

    runs = {
        "SHOT (every voxel)": lambda: features.estimate_shot(vox, K_RADIUS, k=K_SHOT_K),
        "SHOT (keypoints, surface)": lambda: features.estimate_shot(kq, K_RADIUS, k=K_SHOT_K,
                                                                    surface=vox),
        "SHOT colour": lambda: features.estimate_shot_color(vox, K_RADIUS)[kidx],
        "USC": lambda: shape_context.estimate_usc(vox, K_RADIUS)[0][kidx],
        "3DSC": lambda: shape_context.estimate_3dsc(vox, K_RADIUS, gen=gen)[kidx],
        "RoPS": lambda: rops.estimate_rops(vox, K_RADIUS)[0][kidx],
        "spin images": lambda: local_misc.spin_images(vox, K_RADIUS)[kidx],
        "BOARD": lambda: lrf.board_lrf(kq, K_RADIUS, surface=vox)[0],
        "FLARE": lambda: lrf.flare_lrf(vox, K_RADIUS)[0][kidx],
        "RSD": lambda: torch.stack(rsd.estimate_rsd(vox, K_RADIUS), 1)[kidx],
        "principal curvatures": lambda: torch.stack(
            local_misc.principal_curvatures(vox)[:2], 1)[kidx],
        "intensity gradient": gradient,
        "RIFT": lambda: intensity.rift(vox, K_RADIUS, grad["g"])[kidx],
        "intensity spin": lambda: intensity.intensity_spin(vox, K_RADIUS)[kidx],
        "PFHRGB": lambda: color_features.estimate_pfhrgb(vox)[kidx],
        "CPPF": lambda: color_features.estimate_cppf(vox)[kidx],
        "boundary": lambda: local_misc.boundary_estimation(vox, K_RADIUS),
        "difference of normals": lambda: local_misc.difference_of_normals(vox),
        "moment invariants": lambda: local_misc.moment_invariants(vox, K_RADIUS),
        "FPFH persistence": lambda: features.feature_persistence(
            lambda r: features.estimate_fpfh(vox, k=fpfh_k(vox, r)), K_PERSISTENCE, vox.mask)[0],
    }
    out = {}
    for name, fn in runs.items():
        torch.cuda.reset_peak_memory_stats()
        r, secs = timed(fn)
        out[name] = (r, secs, torch.cuda.max_memory_allocated() / 2 ** 20)
    return out


def k_cluster_descriptors(cl, gen):
    """(d) for one cluster cloud (its own capacity): the global
    descriptors of PCL's cluster-recognition tutorial."""
    from pcl_tpu_torch import features

    return {
        "VFH": features.estimate_vfh(cl),
        "CVFH": features.estimate_cvfh(cl).histograms,
        "OUR-CVFH": features.estimate_our_cvfh(cl).histograms,
        "CRH": features.estimate_crh(cl),
        "ESF": features.estimate_esf(cl, gen=gen),
        "GASD": features.estimate_gasd(cl),
        "GASD colour": features.estimate_gasd_color(cl),
        "GRSD": features.estimate_grsd(cl, 2 * E_LEAF),
    }


def float64_cuts():
    """``tests/float64_cuts.py``: the descriptor tests' float64 margin checks
    (numpy only), loaded from this checkout."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "float64_cuts.py")
    spec = importlib.util.spec_from_file_location("float64_cuts", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def invariance_firm(cloud, what: str, eps: float = 1e-4) -> np.ndarray:
    """Rows of SHOT, USC or RoPS whose every decision float64 finds firm
    (ROADMAP C45, C49), by the parity tests' checks (``float64_cuts``) on
    this cloud's own neighbour lists: the frame, each bin, and the
    neighbour set (no neighbour within ``eps`` radius of the support radius,
    and a list cut at its cap only where the next neighbour lies clearly
    further)."""
    from pcl_tpu_torch.search import bruteforce

    cuts = float64_cuts()
    r = float(np.float32(K_RADIUS))
    cap = K_SHOT_K if what == "SHOT" else 64
    if what == "SHOT":
        found = bruteforce.knn(cloud.xyz, cloud.mask, cloud.xyz, cap + 1)
    else:
        found = bruteforce.radius(cloud.xyz, cloud.mask, cloud.xyz, K_RADIUS, cap=cap + 1)[:3]
    idx, d2, ok = (t.cpu().numpy() for t in found)
    xyz, live = cloud.xyz.cpu().numpy(), cloud.mask.cpu().numpy()
    ok = ok & (d2 <= r * r) & live[:, None]
    d = np.sqrt(np.maximum(d2.astype(np.float64), 0.0))
    with np.errstate(invalid="ignore"):
        at_cap = ok[:, cap] & (np.abs(d[:, cap] - d[:, cap - 1]) < eps * r)
    idx, d2, ok = idx[:, :cap], d2[:, :cap], ok[:, :cap]
    if what == "SHOT":
        firm = cuts.shot_firm(xyz, cloud.attrs["normal"].cpu().numpy(), xyz, idx, d2, ok,
                              K_RADIUS, eps=eps)
    elif what == "USC":
        frames, firm = cuts.hard_lrf64(xyz, idx, ok & (d2 > 1e-12), K_RADIUS, eps=eps)
        firm &= cuts.sc_firm(frames, xyz, idx, ok, d2, r, 0.1 * r, eps=eps)
    else:
        frames, firm = cuts.hard_lrf64(xyz, idx, ok, K_RADIUS, eps=eps)
        firm &= cuts.rops_firm(frames, xyz, idx, ok, r, eps=eps)
    return firm & live & ~at_cap


def row_agreement(a: torch.Tensor, b: torch.Tensor, tol: float):
    """Rows of ``a`` and ``b`` (same shape) further apart than ``tol`` and
    the largest difference."""
    d = (a.double().cpu() - b.double().cpu()).abs().reshape(a.shape[0], -1) \
        if a.ndim > 1 else (a.double().cpu() - b.double().cpu()).abs()[:, None]
    worst = d.amax(1)
    return int((worst > tol).sum()), float(worst.max()) if len(worst) else 0.0


def cpu_clone(c):
    from pcl_tpu_torch.core.cloud import Cloud

    return Cloud(xyz=c.xyz.cpu(), mask=c.mask.cpu(), attrs={k: v.cpu() for k, v in c.attrs.items()})


def k_card_vs_cpu(vox, raw, expect):
    """(f): every function of the slice on a 2,048-voxel subcloud on the
    card and on the CPU, the same draws on both. Each row of output is held
    to the tolerance of the CPU parity tests; rows whose decision turns on a
    near-tie that rounding decides (kNN ties, C12; eigenvalues that meet, C9;
    a bin edge, C45) are counted, at most the share given. Returns the lines
    printed."""
    from pcl_tpu_torch import features, keypoints, segmentation
    from pcl_tpu_torch.features import (color_features, cvfh, global_desc, gasd, intensity,
                                        local_misc, lrf, rops, rsd, shape_context, shot)

    s = vox.take(torch.nonzero(vox.mask)[:K_CPU_POINTS, 0])
    dev = s.xyz.device
    c = cpu_clone(s)
    n = s.capacity
    rnd = torch.randn((n, 3), generator=torch.Generator().manual_seed(E_SEED))
    tri = global_desc.draw_esf_samples(c.mask, 4096, torch.Generator().manual_seed(E_SEED))
    g_c = intensity.intensity_gradient(c, K_RADIUS)
    g_k = intensity.intensity_gradient(s, K_RADIUS)
    gx, tx = _patch_mesh()
    mesh_k = rops.estimate_rops_mesh(torch.from_numpy(gx).to(dev), tx, np.arange(0, 400, 9),
                                     0.2)
    mesh_c = rops.estimate_rops_mesh(torch.from_numpy(gx), tx, np.arange(0, 400, 9), 0.2)
    raw_sub = raw.take(torch.arange(min(K_CPU_RAW, raw.capacity), device=raw.xyz.device))
    raw_c = cpu_clone(raw_sub)

    def both(fn):
        return fn(s, g_k, rnd.to(dev), tri.to(dev), raw_sub), fn(c, g_c, rnd, tri, raw_c)

    cases = [
        # name, function of (cloud, gradients, 3DSC draw, ESF draw, raw), tol, share
        ("SHOT", lambda v, g, r, t, w: shot.estimate_shot_interpolated(v, K_RADIUS), 2e-5, 0.05),
        ("SHOT hard", lambda v, g, r, t, w: shot.estimate_shot_hard(v, K_RADIUS), 1e-6, 0.05),
        ("SHOT colour", lambda v, g, r, t, w: shot.estimate_shot_color(v, K_RADIUS), 1e-6, 0.05),
        ("USC", lambda v, g, r, t, w: shape_context.estimate_usc(v, K_RADIUS)[0], 1e-5, 0.05),
        ("3DSC", lambda v, g, r, t, w: shape_context.estimate_3dsc_core(v, K_RADIUS, r), 1e-5,
         0.05),
        ("RoPS", lambda v, g, r, t, w: rops.estimate_rops(v, K_RADIUS)[0], 1e-4, 0.05),
        ("BOARD", lambda v, g, r, t, w: lrf.board_lrf(v, K_RADIUS)[0], 1e-4, 0.05),
        ("FLARE", lambda v, g, r, t, w: lrf.flare_lrf(v, K_RADIUS)[0], 1e-4, 0.05),
        ("spin images", lambda v, g, r, t, w: local_misc.spin_images(v, K_RADIUS), 1e-6, 0.05),
        ("spin images (PCL's)", lambda v, g, r, t, w: local_misc.spin_images_reference(
            v, K_RADIUS), 1e-5, 0.05),
        ("principal curvatures", lambda v, g, r, t, w: torch.stack(
            local_misc.principal_curvatures(v)[:2], 1), 1e-4, 0.02),
        ("boundary", lambda v, g, r, t, w: local_misc.boundary_estimation(v, K_RADIUS), 0.5,
         0.01),
        ("difference of normals", lambda v, g, r, t, w: local_misc.difference_of_normals(v),
         1e-4, 0.02),
        ("moment invariants", lambda v, g, r, t, w: local_misc.moment_invariants(v, K_RADIUS),
         1e-4, 0.0),
        ("moment of inertia", lambda v, g, r, t, w: _unit(local_misc.moment_of_inertia(
            v).moment_of_inertia)[None], 1e-5, 0.0),
        ("RSD", lambda v, g, r, t, w: torch.stack(rsd.estimate_rsd(v, K_RADIUS), 1), 1e-4, 0.01),
        ("GRSD", lambda v, g, r, t, w: rsd.estimate_grsd(v, 2 * E_LEAF)[None], 1e-3, 0.0),
        ("Harris 3-D", lambda v, g, r, t, w: keypoints.harris3d_keypoints(
            v, K_RADIUS, threshold=K_HARRIS_THRESHOLD)[1], 1e-6, 0.0),
        ("SUSAN", lambda v, g, r, t, w: keypoints.susan_keypoints(v, K_RADIUS)[1], 1e-6, 0.01),
        ("Euclidean clusters", lambda v, g, r, t, w: segmentation.euclidean_clusters(
            v, K_CLUSTER_TOLERANCE)[0], 0.5, 0.0),
        ("region growing", lambda v, g, r, t, w: segmentation.region_growing(v)[0], 0.5, 0.02),
        ("VFH", lambda v, g, r, t, w: global_desc.estimate_vfh(v)[None], 0.2, 0.0),
        ("ESF", lambda v, g, r, t, w: global_desc.estimate_esf_core(v, t)[None], 0.1, 0.0),
        ("CVFH", lambda v, g, r, t, w: cvfh.estimate_cvfh(v).histograms, 0.2, 0.0),
        ("OUR-CVFH", lambda v, g, r, t, w: cvfh.estimate_our_cvfh(v).histograms, 0.2, 0.0),
        ("CRH", lambda v, g, r, t, w: cvfh.estimate_crh(v)[None], 1e-5, 0.0),
        ("GASD", lambda v, g, r, t, w: gasd.estimate_gasd(v)[None], 1e-5, 0.0),
        ("GASD colour", lambda v, g, r, t, w: gasd.estimate_gasd_color(v)[None], 1e-3, 0.0),
        ("intensity gradient", lambda v, g, r, t, w: g, 1e-4, 0.0),
        ("intensity spin", lambda v, g, r, t, w: intensity.intensity_spin(v, K_RADIUS), 1e-5,
         0.0),
        ("RIFT", lambda v, g, r, t, w: intensity.rift(v, K_RADIUS, g), 1e-4, 0.01),
        ("PFHRGB", lambda v, g, r, t, w: color_features.estimate_pfhrgb(v), 1e-4, 0.05),
        ("CPPF", lambda v, g, r, t, w: color_features.estimate_cppf(v), 1e-3, 0.0),
    ]
    lines = []
    for name, fn, tol, share in cases:
        a, b = both(fn)
        off, worst = row_agreement(a, b, tol)
        lines.append(f"{name} {off}/{a.shape[0]} rows beyond {tol:g} (max {worst:.2e})")
        expect(off <= share * a.shape[0], f"(f) {name}: {off} of {a.shape[0]} rows differ "
                                          f"beyond {tol} on the card and the CPU")
    # crh_align of a CRH against itself turned by 17 bins: the peak (the
    # runners-up may tie, C47)
    h = [cvfh.estimate_crh(x) for x in (s, c)]
    ak, ac = (cvfh.crh_align(x, torch.roll(x, -17), 3)[0] for x in h)
    lines.append(f"crh_align peak {float(ak[0]):.6f} / {float(ac[0]):.6f}")
    expect(float(ak[0]) == float(ac[0]) and abs(float(ac[0]) - 17 / 90 * 2 * math.pi) < 1e-5,
           "(f) crh_align")
    lines.append(persistence_card_vs_cpu(s, c, expect))
    off, worst = row_agreement(mesh_k[0], mesh_c[0], 1e-4)
    lines.append(f"RoPS mesh {off}/{len(mesh_c[0])} rows beyond 1e-4 (max {worst:.2e})")
    expect(off <= 0.1 * len(mesh_c[0]), "(f) RoPS mesh differs on the card and the CPU")
    pk, pc = (torch.stack(color_features.ppfrgb_features(
        x.xyz[:-1], x.attrs["normal"][:-1], x.attrs["rgb"][:-1], x.xyz[1:],
        x.attrs["normal"][1:], x.attrs["rgb"][1:]), 1) for x in (s, c))
    off, worst = row_agreement(pk, pc, 1e-3)
    lines.append(f"PPFRGB {off}/{len(pc)} rows beyond 1e-3 (max {worst:.2e})")
    expect(off == 0, "(f) ppfrgb_features differ on the card and the CPU")
    # SIFT's keypoint clouds: the octaves are voxel grids (bitwise alike,
    # C11); an extremum within rounding of a neighbour's value may go either way
    nk, nc = (int(keypoints.sift.sift_keypoints_cloud(x, **K_SIFT).mask.sum())
              for x in (raw_sub, raw_c))
    lines.append(f"SIFT keypoints {nk} / {nc} on {raw_sub.capacity} raw points")
    expect(abs(nk - nc) <= 0.05 * nc + 1, "(f) SIFT differs on the card and the CPU")
    return lines


def persistence_card_vs_cpu(s, c, expect) -> str:
    """(f) for FPFH persistence at K_PERSISTENCE on the subcloud ``s`` (card)
    and ``c`` (CPU): the persistent masks (at most K_PERSIST_MASK_SHARE of
    the rows differ: an FPFH bin that flips at its edge, C19, moves a row
    across the threshold), and the distances on the rows whose FPFH float64
    finds firm at every scale (no pair of the row or of a neighbour within
    ``float64_cuts.EDGE`` of a bin's cut, and the same kNN lists on both
    devices). A scale's mean descriptor moves with every flipped bin
    elsewhere, so a firm row's distance may move by its own row's L1
    difference plus the two means' L1 gap (the triangle inequality), plus
    1e-5 of the sums' scale for float32 rounding. Returns the line printed."""
    from pcl_tpu_torch import features
    from pcl_tpu_torch.search import bruteforce

    cuts = float64_cuts()
    kept = ([], [])

    def fpfh_at(v, keep):
        def fn(x):
            keep.append(features.estimate_fpfh(v, k=16 + int(4 * x)))
            return keep[-1]
        return fn

    (pk, dk), (pc, dc) = (features.feature_persistence(fpfh_at(v, keep), K_PERSISTENCE, v.mask)
                          for v, keep in zip((s, c), kept))
    mask_off = int((pk.cpu() != pc).sum())
    dk, dc = dk.double().cpu().numpy(), dc.double().numpy()
    xyz, nrm, live = c.xyz.numpy(), c.attrs["normal"].numpy(), c.mask.numpy()
    firm, row_err, excess, gaps = live.copy(), 0.0, -math.inf, []
    for x in K_PERSISTENCE:
        k = 16 + int(4 * x)
        ic, _, vc = (t.numpy() for t in bruteforce.knn(c.xyz, c.mask, c.xyz, k))
        same = np.all(bruteforce.knn(s.xyz, s.mask, s.xyz, k)[0].cpu().numpy() == ic, 1)
        vc = vc & live[:, None]
        firm &= cuts.fpfh_firm(cuts.spfh_firm(xyz, nrm, ic, vc) & same, ic, vc)
    for j in range(len(K_PERSISTENCE)):
        fk, fc = kept[0][j].double().cpu().numpy(), kept[1][j].double().numpy()
        mu_c = fc[live].mean(0)
        gaps.append(float(np.abs(fk[live].mean(0) - mu_c).sum()))
        slack = (np.abs(fk - fc).sum(1) + gaps[-1]
                 + 1e-5 * (np.abs(dc[j]).max() + np.abs(mu_c).sum()))
        row_err = max(row_err, float(np.abs(fk - fc)[firm].max(initial=0.0)))
        excess = max(excess, float((np.abs(dk[j] - dc[j]) - slack)[firm].max(initial=-math.inf)))
    n_live = int(live.sum())
    expect(mask_off <= K_PERSIST_MASK_SHARE * n_live,
           f"(f) FPFH persistence: {mask_off} of {n_live} masks differ on the card and the CPU")
    expect(int(firm.sum()) >= K_PERSIST_FIRM_SHARE * n_live and row_err <= 1e-4
           and excess <= 0.0, f"(f) FPFH persistence on firm rows: {int(firm.sum())} of {n_live} "
           f"firm, FPFH rows by {row_err:.3e}, distances beyond their slack by {excess:.3e}")
    return (f"FPFH persistence {mask_off}/{n_live} masks differ; on {int(firm.sum())} firm "
            f"rows FPFH within {row_err:.2e}, distances within their slack (largest excess "
            f"{excess:.2e}; means' L1 gaps {', '.join(f'{g:.3e}' for g in gaps)})")


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.abs().max().clamp(min=1e-30)


def axis_rotation(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rotation matrix of ``angle`` rad about ``axis`` (Rodrigues)."""
    k = axis / np.linalg.norm(axis)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(angle) * K + (1 - math.cos(angle)) * K @ K


def _patch_mesh(n=20):
    """A triangulated n x n height field over 1 m (two triangles a cell)."""
    v, u = np.mgrid[0:n, 0:n].astype(np.float64) / (n - 1)
    z = 0.15 * np.sin(3 * u) * np.cos(2 * v)
    xyz = np.stack([u, v, z], -1).reshape(-1, 3).astype(np.float32)
    i = np.arange(n * n).reshape(n, n)
    a, b, c, d = i[:-1, :-1].ravel(), i[:-1, 1:].ravel(), i[1:, :-1].ravel(), i[1:, 1:].ravel()
    return xyz, np.concatenate([np.stack([a, b, c], 1), np.stack([b, d, c], 1)])


# path L: surface reconstruction and the rest of segmentation on path G's room
L_SEED = 10
L_NAMES = ("floor", "back wall", "side wall", "box", "sphere", "cylinder")
L_OBJECTS = (3, 4, 5)
L_COLORS = np.array([[0.30, 0.40, 0.60], [0.85, 0.82, 0.70], [0.60, 0.75, 0.90],
                     [0.85, 0.15, 0.10], [0.15, 0.70, 0.20], [0.15, 0.30, 0.85]], np.float32)
# the room's planes in the world, normals into the room: n.p + d = 0
L_PLANE_TRUTH = {0: ((0.0, -1.0, 0.0), 1.0), 1: ((0.0, 0.0, -1.0), 2.7),
                 2: ((-1.0, 0.0, 0.0), 1.3)}
L_CENTERS = {3: tuple(0.5 * (np.array(G_BOX[0]) + np.array(G_BOX[1]))), 4: G_SPHERE[0],
             5: (G_CYLINDER[0][0], 0.5 * sum(G_CYLINDER[2]), G_CYLINDER[0][1])}
L_FLOOR_SEED = (0.6, 1.0, 1.0)             # a floor point clear of the objects (world)
L_SAME_PLANE = (math.radians(5.0), 0.05)    # rad, m: two regions of one plane
# min-cut's radius for the box: its half diagonal (0.32 m) and 0.13 m; at 0.32 m its
# faces' source and sink links are equal and the cut keeps nothing (a CPU run)
L_BOX_RADIUS = 0.45
L_FULL = dict(
    shape=G_SHAPE, intr=G_INTR, leaf=0.01, normal_k=16, fast_mesh_edge=0.05,
    # the frame's normals: k-NN over PCL's demo's 20 x 20 smoothing window (C63)
    frame_normal_k=400,
    # PCL's organized multi-plane segmentation demo
    planes=dict(min_inliers=10_000, angular_threshold=0.0349, distance_threshold=0.02),
    cc_distance=0.02, prism=(0.01, 0.6), hull_inset=0.05, concave_alpha=0.1,
    cluster=dict(tolerance=0.02, min_cluster_size=500),
    mls_radius=0.03, smoothed=(0.02, 0.03, 0.05),              # PCL's resampling tutorial
    # PCL's greedy projection tutorial
    gp3=dict(search_radius=0.025, mu=2.5, k=100, min_angle=math.pi / 18,
             max_angle=2 * math.pi / 3, eps_angle=math.pi / 4),
    hoppe_res=128, poisson_depth=8, rbf_res=32,
    # PCL's supervoxel tutorial's weights
    sv=dict(seed_resolution=0.1, color_importance=0.2, spatial_importance=0.4,
            normal_importance=1.0, max_seeds=4096),
    mincut=dict(sigma=0.25, source_weight=0.8, k=14),          # PCL's min-cut tutorial
    walker=dict(k=10, sigma=0.05, n_labels=4, cg_iters=200),
    hue=dict(cluster_tolerance=0.02, delta_hue=0.1),          # k 12: the JAX one's only k (C67)
    upsample=dict(search_radius=0.03, upsampling_radius=0.01, step_size=0.005,
                  density=40_000.0, voxel_size=0.01),
    grid_res=48, surfel_radius=0.03, bspline_stride=4, fpfh_k=16, grab_margin=0.05)
# 80 x 60 for the CPU tests (``tests/test_torch_path_l.py``): radii grown with the pixels
L_SMALL = dict(
    L_FULL, shape=(60, 80), intr=(G_INTR[0] / 8, G_INTR[1] / 8, (G_INTR[2] + 0.5) / 8 - 0.5,
                                  (G_INTR[3] + 0.5) / 8 - 0.5),
    leaf=0.04, fast_mesh_edge=0.2, frame_normal_k=16,
    planes=dict(min_inliers=150, angular_threshold=0.1, distance_threshold=0.05),
    cc_distance=0.1, hull_inset=0.1, concave_alpha=0.3,
    cluster=dict(tolerance=0.1, min_cluster_size=5), mls_radius=0.12, smoothed=(0.08, 0.12, 0.2),
    gp3=dict(L_FULL["gp3"], search_radius=0.1, k=30), hoppe_res=32, poisson_depth=5, rbf_res=16,
    sv=dict(L_FULL["sv"], seed_resolution=0.25, max_seeds=512),
    walker=dict(k=10, sigma=0.1, n_labels=4, cg_iters=200),
    hue=dict(cluster_tolerance=0.1, delta_hue=0.1),
    upsample=dict(search_radius=0.12, upsampling_radius=0.04, step_size=0.02, density=2500.0,
                  voxel_size=0.04),
    grid_res=16, surfel_radius=0.12, bspline_stride=1, grab_margin=0.1)
# limits of (e): 1.5 x the JAX package's CPU rehearsal (tests/rehearse_path_l.py jax) and
# the port's card run, which read alike to 1e-5 (the IoU: their value / 1.5): plane 0.03426
# deg and 0.001442 m; mesh medians 0.005027 / 0.022965 / 0.004412 m, p99 0.025745 / 0.92383
# / 0.27466 m (Hoppe's far-field sheets, C69); impurity 0.005332; min-cut IoU 0.95083
L_LIMITS = dict(plane_deg=0.0514, plane_m=0.00216,
                mesh_median=dict(gp3=0.00754, hoppe=0.0345, poisson=0.00662),
                mesh_p99=dict(gp3=0.0386, hoppe=1.386, poisson=0.412),
                sv_impurity=0.0080, mincut_iou=0.634)


def to_world(p: np.ndarray, pose: np.ndarray) -> np.ndarray:
    return (np.asarray(p, np.float64) @ pose[:3, :3].T + pose[:3, 3])


def to_camera(p, pose: np.ndarray) -> np.ndarray:
    return ((np.asarray(p, np.float64) - pose[:3, 3]) @ pose[:3, :3]).astype(np.float32)


def path_l_frame(L):
    """Path G's frame 0 of the room (``render_depth`` from the handheld
    start, seed ``L_SEED``) as an organized frame in the camera, each pixel
    with the colour of its surface and a little noise: ``xyz [H, W, 3]``,
    ``valid``, ``depth``, ``rgb``, ``part`` (the surface: ``L_NAMES``, -1
    where invalid) and the camera's ``pose``."""
    return room_frame(L, handheld(np.random.default_rng(G_SEED), 1)[0], L_SEED)


def room_frame(L, pose: np.ndarray, seed: int):
    """The room seen from ``pose`` at ``L``'s shape and intrinsics, range
    noise, dropped pixels and colour noise from ``default_rng(seed)``: the
    keys of :func:`path_l_frame`."""
    from pcl_tpu_torch.fusion import Intrinsics

    intr = Intrinsics(*L["intr"])
    H, W = L["shape"]
    rng = np.random.default_rng(seed)
    depth, _ = render_depth(pose, intr, H, W, rng)
    v, u = np.mgrid[0:H, 0:W]
    xyz = np.stack([(u - intr.cx) / intr.fx * depth, (v - intr.cy) / intr.fy * depth, depth], -1)
    xyz = xyz.astype(np.float32)
    valid = depth > 0
    part = np.argmin(room_parts(to_world(xyz.reshape(-1, 3), pose)), 0).reshape(H, W)
    rgb = np.clip(L_COLORS[part] + 0.03 * rng.normal(size=(H, W, 3)), 0, 1)
    return dict(xyz=xyz, valid=valid, depth=depth, pose=pose, part=np.where(valid, part, -1),
                rgb=np.where(valid[..., None], rgb, 0).astype(np.float32))


def plane_in_camera(i: int, pose: np.ndarray):
    """True plane ``i`` in the camera frame: ``(unit normal, offset)``."""
    n, d = L_PLANE_TRUTH[i]
    n = np.asarray(n)
    return n @ pose[:3, :3], float(d + n @ pose[:3, 3])


def nearest_region(regions, i: int, pose: np.ndarray):
    """The planar region closest to true plane ``i``: its normal within
    ``L_SAME_PLANE`` of the truth's, the nearest offset among those, else the
    nearest normal."""
    n, d = plane_in_camera(i, pose)

    def gap(r):
        c = r.coefficients.astype(np.float64)
        cos = abs(float(c[:3] @ n))
        return (cos < math.cos(L_SAME_PLANE[0]), abs(np.sign(c[:3] @ n) * c[3] - d)
                if cos >= math.cos(L_SAME_PLANE[0]) else -cos)

    return min(regions, key=gap)


def same_plane_regions(regions, ref):
    """Every region whose plane lies within ``L_SAME_PLANE`` of ``ref``'s:
    an occluder cuts a plane into several regions."""
    c0 = ref.coefficients.astype(np.float64)
    out = []
    for r in regions:
        c = r.coefficients.astype(np.float64)
        cos = float(c[:3] @ c0[:3])
        if abs(cos) >= math.cos(L_SAME_PLANE[0]) and abs(np.sign(cos) * c[3] - c0[3]) \
                <= L_SAME_PLANE[1]:
            out.append(r)
    return out


def hull_polygon(pts: np.ndarray, coeff: np.ndarray, inset: float, alpha: float, hulls):
    """The floor's convex hull as a polygon for the prism (PCL's tutorial:
    inliers projected onto the plane, a 2-D hull): the points in plane
    coordinates go to ``hulls(points [N, 3] with z 0, alpha) -> (the convex
    hull's vertices, the concave hull's edges)``; the vertices in angular
    order are moved ``inset`` toward their centroid (the walls' base stays out
    of the prism) and put back in 3-D. Returns ``(polygon [P, 3], the concave
    hull's edge count)``."""
    n = coeff[:3] / np.linalg.norm(coeff[:3])
    e1 = np.cross(n, [1.0, 0.0, 0.0] if abs(n[0]) < 0.9 else [0.0, 1.0, 0.0])
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(n, e1)
    c = pts.mean(0) - (pts.mean(0) @ n + coeff[3]) * n
    uv = (pts - c) @ np.stack([e1, e2], 1)
    verts, edges = hulls(np.concatenate([uv, np.zeros((len(uv), 1))], 1).astype(np.float32),
                         alpha)
    v = verts[:, :2].astype(np.float64)
    mid = v.mean(0)
    v = v[np.argsort(np.arctan2(v[:, 1] - mid[1], v[:, 0] - mid[0]))]
    r = np.linalg.norm(v - mid, axis=1, keepdims=True)
    v = mid + (v - mid) * np.maximum(r - inset, 0) / np.maximum(r, 1e-12)
    return (c + v[:, :1] * e1 + v[:, 1:] * e2).astype(np.float32), len(edges)


def port_hulls(dev):
    """``hull_polygon``'s hulls on the port: 2-D convex and concave hulls."""
    from pcl_tpu_torch.core.cloud import make_cloud
    from pcl_tpu_torch.surface import concave_hull, convex_hull

    def hulls(flat, alpha):
        c = make_cloud(flat, device=dev)
        return convex_hull(c, dim=2)[0], concave_hull(c, alpha, dim=2)[1]

    return hulls


def _stamp(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


def path_l_chain(frame, L, dev, on_stage=None):
    """Path L's main path on the port, on ``dev``: (a) organized
    segmentation, (b) the tabletop flow, (c) reconstruction, (d)
    segmentation of the voxels. Returns ``(out, seconds)``: host arrays and
    each call's host time. ``on_stage(name)`` is told each call's name
    before it runs."""
    from pcl_tpu_torch import features, filters, keypoints
    from pcl_tpu_torch import segmentation as seg
    from pcl_tpu_torch import surface as srf
    from pcl_tpu_torch.core.cloud import make_cloud
    from pcl_tpu_torch.features import integral_image_normals
    from pcl_tpu_torch.search import bruteforce

    out, secs = {}, {}
    part = ["(a)"]

    def run(name, fn):
        if on_stage is not None:
            on_stage(name)
        t0 = _stamp(dev)
        r = fn()
        secs[f"{part[0]} {name}"] = _stamp(dev) - t0
        return r

    def t(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    H, W = L["shape"]
    pose = frame["pose"]
    xyz_img, valid_img, rgb_img = t(frame["xyz"]), t(frame["valid"]), t(frame["rgb"])
    pix = make_cloud(xyz_img.reshape(-1, 3), valid_img.reshape(-1),
                     {"rgb": rgb_img.reshape(-1, 3)}, device=dev)

    # (a) organized segmentation of the whole frame, on kNN normals (C63)
    pn = run("normals (frame, k-NN)",
             lambda: features.estimate_normals(pix, k=L["frame_normal_k"]))
    n_img = pn.attrs["normal"].reshape(H, W, 3)
    labels, regions = run("organized_multi_plane_segmentation",
                          lambda: seg.organized_multi_plane_segmentation(xyz_img, n_img, valid_img,
                                                                         **L["planes"]))
    out["plane_labels"], out["regions"], out["frame_normal"] = labels, regions, n_img.cpu().numpy()
    i_n, _ = run("integral_image_normals", lambda: integral_image_normals(xyz_img, valid_img))
    _, out["integral_regions"] = seg.organized_multi_plane_segmentation(
        xyz_img, i_n, valid_img & (i_n.abs().sum(-1) > 0), **L["planes"])
    out["cc_labels"] = run("organized_connected_components",
                           lambda: seg.organized_connected_components(
                               xyz_img, valid_img, L["cc_distance"])).cpu().numpy()
    org = make_cloud(xyz_img.reshape(-1, 3), valid_img.reshape(-1), width=W, height=H, device=dev)
    out["fast_mesh"] = run("organized_fast_mesh",
                           lambda: srf.organized_fast_mesh(org, L["fast_mesh_edge"]))

    # (b) the tabletop flow on the floor
    part[0] = "(b)"
    floor = max(same_plane_regions(regions, nearest_region(regions, 0, pose)),
                key=lambda r: r.count)
    coeff = floor.coefficients
    fpts = frame["xyz"].reshape(-1, 3)[np.concatenate(
        [r.indices for r in same_plane_regions(regions, floor)])]
    (hull, n_concave) = run("convex_hull + concave_hull (floor)",
                            lambda: hull_polygon(fpts, coeff, L["hull_inset"], L["concave_alpha"],
                                                 port_hulls(dev)))
    out["hull"], out["concave_edges"], out["floor_coeff"] = hull, n_concave, coeff
    prism = run("extract_polygonal_prism",
                lambda: seg.extract_polygonal_prism(pix, hull, coeff, *L["prism"]))
    objects = pix.with_mask(t(prism))
    cl, _ = run("euclidean_clusters", lambda: seg.euclidean_clusters(objects, **L["cluster"]))
    out["prism"], out["clusters"] = prism, cl.cpu().numpy()

    # (c) reconstruction on the frame's voxels
    part[0] = "(c)"
    vox = run("voxel_downsample", lambda: live_rows(filters.voxel_downsample(pix, L["leaf"])))
    vox = run("normals (voxels)", lambda: features.estimate_normals(vox, k=L["normal_k"]))
    vxyz = vox.xyz.cpu().numpy()
    vpart = np.argmin(room_parts(to_world(vxyz, pose)), 0)
    out["vox_xyz"], out["vox_normal"], out["vox_rgb"], out["vox_part"] = (
        vxyz, vox.attrs["normal"].cpu().numpy(), vox.attrs["rgb"].cpu().numpy(), vpart)
    mls = {}
    for r in sorted(set(L["smoothed"]) | {L["mls_radius"]}):
        mls[r] = run(f"moving_least_squares r={r}",
                     lambda r=r: srf.moving_least_squares(vox, r, polynomial_order=2))
    out["mls_xyz"] = mls[L["mls_radius"]].xyz.cpu().numpy()
    out["keypoints"] = run("smoothed_surfaces_keypoints",
                           lambda: keypoints.smoothed_surfaces_keypoints(
                               vox, [mls[r] for r in L["smoothed"]], L["smoothed"][1]))
    out["gp3"] = run("greedy_projection_triangulation",
                     lambda: srf.greedy_projection_triangulation(vox, **L["gp3"]))
    out["hoppe"] = run("reconstruct_hoppe",
                       lambda: srf.reconstruct_hoppe(vox, resolution=L["hoppe_res"]))
    out["poisson"] = run("poisson_reconstruction",
                         lambda: srf.poisson_reconstruction(vox, depth=L["poisson_depth"]))
    obj = {i: live_rows(vox.with_mask(t(vpart == i))) for i in L_OBJECTS}
    out["rbf"] = run("marching_cubes_rbf (box)",
                     lambda: srf.marching_cubes_rbf(obj[3], resolution=L["rbf_res"]))
    V, F = out["hoppe"]
    out["laplacian"] = run("laplacian_smooth", lambda: srf.laplacian_smooth(V, F))
    out["taubin"] = run("taubin_smooth", lambda: srf.taubin_smooth(V, F))
    out["subdivided"] = run("subdivide_linear", lambda: srf.subdivide_linear(V, F))
    out["decimated"] = run("decimate_cluster", lambda: srf.decimate_cluster(V, F))
    back = nearest_region(regions, 1, pose)
    wall = make_cloud(frame["xyz"].reshape(-1, 3)[back.indices[::L["bspline_stride"]]],
                      device=dev)
    out["wall_xyz"] = wall.xyz.cpu().numpy()
    out["bspline"] = run("fit_bspline_surface", lambda: srf.fit_bspline_surface(wall))
    out["bspline_iterated"] = run("fit_bspline_surface_iterated",
                                  lambda: srf.fit_bspline_surface_iterated(wall))
    out["bspline_trimmed"] = run("fit_trimmed_bspline_surface",
                                 lambda: srf.fit_trimmed_bspline_surface(wall))
    def residual(s):
        uv = torch.clamp((((wall.xyz - s.centroid) @ s.frame.T)[:, :2] - s.origin) / s.scale, 0, 1)
        return float(torch.linalg.vector_norm(srf.eval_bspline_surface(s, uv) - wall.xyz,
                                              dim=1).mean())

    out["bspline_residual"] = [residual(out["bspline"]), residual(out["bspline_iterated"]),
                               residual(out["bspline_trimmed"].surface)]
    out["bspline_mesh"] = run("convert_surface_to_mesh",
                              lambda: srf.convert_surface_to_mesh(out["bspline"], 16))
    up = L["upsample"]
    out["up_local"] = run("mls_upsample_local_plane (sphere)",
                          lambda: srf.mls_upsample_local_plane(
                              obj[4], up["search_radius"], up["upsampling_radius"],
                              up["step_size"]))
    out["up_random"] = run("mls_upsample_random_density (cylinder)",
                           lambda: srf.mls_upsample_random_density(
                               obj[5], up["search_radius"], up["upsampling_radius"],
                               up["density"], seed=L_SEED))
    out["up_dilation"] = run("mls_upsample_voxel_dilation (box)",
                             lambda: srf.mls_upsample_voxel_dilation(
                                 obj[3], up["search_radius"], up["voxel_size"]))
    out["grid_projection"] = run("grid_projection (sphere)",
                                 lambda: srf.grid_projection(obj[4], resolution=L["grid_res"]))
    out["surfel"] = run("surfel_smoothing (cylinder)",
                        lambda: srf.surfel_smoothing(obj[5], L["surfel_radius"]))
    out["bilateral"] = run("bilateral_upsampling (frame)",
                           lambda: srf.bilateral_upsampling(t(frame["depth"]),
                                                            rgb_img)).cpu().numpy()
    out["texture"] = run("texture_mapping (Hoppe mesh)",
                         lambda: srf.texture_mapping(V, F, np.eye(4), *L["intr"], W, H))

    # (d) segmentation of the voxels
    part[0] = "(d)"
    sv = run("supervoxel_clustering", lambda: seg.supervoxel_clustering(vox, **L["sv"]))
    out["sv_labels"] = sv.labels.cpu().numpy()
    out["lccp"] = run("lccp_segmentation", lambda: seg.lccp_segmentation(sv))[0]
    out["cpc"] = run("cpc_segmentation", lambda: seg.cpc_segmentation(vox, sv))
    box_c = to_camera(L_CENTERS[3], pose)
    out["mincut"] = run("min_cut_segmentation (box)",
                        lambda: seg.min_cut_segmentation(vox, box_c, radius=L_BOX_RADIUS,
                                                         **L["mincut"]))
    lo, hi = (np.array(b) for b in G_BOX)
    vw = to_world(vxyz, pose)
    grab0 = np.all((vw >= lo - L["grab_margin"]) & (vw <= hi + L["grab_margin"]), axis=1)
    out["grab"] = run("grab_cut (box)", lambda: seg.grab_cut(vox, grab0))
    near = [int(np.argmin(np.linalg.norm(vxyz - to_camera(c, pose), axis=1)))
            for c in (L_CENTERS[3], L_CENTERS[4], L_CENTERS[5], L_FLOOR_SEED)]
    seed = np.zeros(len(vxyz), bool)
    seed[near[0]] = True
    out["hue"] = run("seeded_hue_segmentation (box)",
                     lambda: seg.seeded_hue_segmentation(vox, t(seed), **L["hue"])).cpu().numpy()
    seeds = -np.ones(len(vxyz), np.int64)
    seeds[near] = np.arange(4)
    out["walker_seeds"] = seeds
    out["walker"] = run("random_walker", lambda: seg.random_walker(vox, t(seeds),
                                                                  **L["walker"])).cpu().numpy()
    fpfh = run("estimate_fpfh (voxels)", lambda: features.estimate_fpfh(vox, k=L["fpfh_k"]))
    # each voxel's (b) cluster: that of its nearest clustered pixel within a voxel
    kept = torch.nonzero(cl >= 0)[:, 0]
    idx, d2 = run("voxels to (b)'s clusters (1-NN)",
                  lambda: bruteforce.nn1(pix.xyz[kept], pix.mask[kept], vox.xyz))
    vc = torch.where(d2 <= L["leaf"] ** 2, cl[kept][idx.long()], -1).cpu().numpy()
    ids = np.unique(vc[vc >= 0])
    out["vox_cluster"] = np.searchsorted(ids, vc) * (vc >= 0) - (vc < 0)
    f_np = fpfh.cpu().numpy()
    clf = seg.UnaryClassifier()
    gen = torch.Generator(device=dev).manual_seed(L_SEED)
    run("UnaryClassifier.train", lambda: clf.train([f_np[out["vox_cluster"] == c]
                                                    for c in range(len(ids))],
                                                   generator=gen, device=dev))
    out["unary"] = run("UnaryClassifier.segment", lambda: clf.segment(f_np))
    return out, secs


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    return float((a & b).sum() / max((a | b).sum(), 1))


def path_l_metrics(frame, out, L) -> dict:
    """Path L's measures from host arrays: the planes against the truth,
    the clusters' objects, the meshes' distances to the room, supervoxel
    impurity, LCCP's separation, the min-cut's IoU with the box's cluster,
    and shares of the other segmentations."""
    pose, part = frame["pose"], frame["part"].reshape(-1)
    m = {}
    planes = {}
    for i in L_PLANE_TRUTH:
        if (part == i).sum() < L["planes"]["min_inliers"]:
            continue
        r = nearest_region(out["regions"], i, pose)
        n, d = plane_in_camera(i, pose)
        c = r.coefficients.astype(np.float64)
        ang = math.degrees(math.acos(min(1.0, abs(float(c[:3] @ n)))))
        planes[L_NAMES[i]] = (ang, abs(float(np.sign(c[:3] @ n) * c[3] - d)))
    m["planes"] = planes
    m["n_regions"] = len(out["regions"])
    m["n_integral_regions"] = len(out["integral_regions"])
    cl = out["clusters"]
    ids = np.unique(cl[cl >= 0])
    m["cluster_objects"] = sorted(int(np.bincount(part[cl == c], minlength=6).argmax())
                                  for c in ids)
    for name in ("gp3", "hoppe", "poisson", "rbf", "fast_mesh"):
        V, F = out[name]
        V = np.asarray(V)[np.unique(F)] if len(F) else np.zeros((0, 3))
        dist = room_distance(to_world(V, pose))
        m[f"{name}_mesh"] = (len(V), len(F), float(np.median(dist)) if len(V) else math.inf,
                             float(np.percentile(dist, 99)) if len(V) else math.inf)
    vpart = out["vox_part"]
    sv = out["sv_labels"]
    impure = 0
    for s in np.unique(sv[sv >= 0]):
        p = vpart[sv == s]
        impure += len(p) - np.bincount(p).max()
    m["sv_impurity"] = impure / max(int((sv >= 0).sum()), 1)
    m["n_supervoxels"] = len(np.unique(sv[sv >= 0]))
    lccp = out["lccp"]

    def major(lab, i):
        v = lab[(vpart == i) & (lab >= 0)]
        return int(np.bincount(v).argmax()) if len(v) else -1

    m["lccp_segments"] = {L_NAMES[i]: major(lccp, i) for i in (0,) + L_OBJECTS}
    m["lccp_separates"] = all(m["lccp_segments"][L_NAMES[i]] != m["lccp_segments"]["floor"]
                              for i in L_OBJECTS)
    vc = out["vox_cluster"]
    boxc = [c for c in np.unique(vc[vc >= 0]) if np.bincount(vpart[vc == c]).argmax() == 3]
    box = np.isin(vc, boxc) if boxc else vpart == 3
    m["mincut_iou"] = _iou(out["mincut"], box)
    m["mincut_fg"] = int(out["mincut"].sum())
    m["grab_iou"] = _iou(out["grab"], box)
    m["hue_iou"] = _iou(out["hue"], box)
    m["walker_share"] = {L_NAMES[i]: float((out["walker"][vpart == i] == k).mean())
                         for k, i in enumerate(L_OBJECTS + (0,))}
    m["unary_share"] = [float((out["unary"][vc == c] == c).mean())
                        for c in np.unique(vc[vc >= 0])]
    m["keypoints"] = int(np.asarray(out["keypoints"]).sum())
    m["voxels"] = len(vpart)
    m["bspline_residual"] = out["bspline_residual"]
    return m


@contextlib.contextmanager
def kernel_calls(bruteforce, segsum):
    """Keeps the inputs of every B1 call (a 3-D ``bruteforce.nn1``) and
    every B2 call (``segsum.segment_sum_sorted``) made inside, each tagged
    with ``calls["stage"]`` at the time, so that the kernels can be held to
    their plain versions at the main path's own shapes. The kernels run and
    count their launches as before."""
    kernel_nn1, kernel_segsum = bruteforce.nn1, segsum.segment_sum_sorted
    calls = {"stage": None, "nn1": [], "segsum": []}

    def nn1(t, m, q, *args, **kw):
        if q.shape[-1] == 3:
            calls["nn1"].append((calls["stage"], t, m, q))
        return kernel_nn1(t, m, q, *args, **kw)

    def keep(vals, seg):
        calls["segsum"].append((calls["stage"], vals, seg))
        return kernel_segsum(vals, seg)

    bruteforce.nn1, segsum.segment_sum_sorted = nn1, keep
    try:
        yield calls
    finally:
        bruteforce.nn1, segsum.segment_sum_sorted = kernel_nn1, kernel_segsum


def phase13_path_k(segsum, nn1_mod, street, record_b1, record_b2):
    """Path K: descriptors, keypoints and clusters on path E's pair."""
    from pcl_tpu_torch import features, segmentation
    from pcl_tpu_torch.core.cloud import Cloud
    from pcl_tpu_torch.core.transforms import transform_points
    from pcl_tpu_torch.features import rops, shape_context
    from pcl_tpu_torch.registration import ia, icp
    from pcl_tpu_torch.search import bruteforce
    from pcl_tpu_torch.tools.odometry import probed_cells

    failed = []

    def expect(cond: bool, what: str) -> None:
        """A check of this phase, raised with the others at its end."""
        if not cond:
            print(f"phase 13: CHECK FAILED: {what}", flush=True)
            failed.append(what)

    raw, P = path_k_scans(street)
    gen = torch.Generator(device=raw[0].xyz.device)
    # warm-up (libraries, allocator, the solvers' handles) on a quarter of scan 0
    wc = raw[0].take(torch.arange(0, raw[0].capacity, 4, device=raw[0].xyz.device))
    wv, _, _, _, _ = global_front(wc, k=16)
    wk, _ = k_keypoints(wv, wc)
    k_descriptors(wv, torch.nonzero(wk["iss"])[:, 0], gen.manual_seed(0))

    trace.reset()
    with kernel_calls(bruteforce, segsum) as calls:
        fronts, kps, ksecs = [], [], []
        for i in (0, 1):
            calls["stage"] = f"voxel grid, scan {i}"
            v, fp, _, k, _ = global_front(raw[i], k=None if i == 0 else fronts[0][3])
            fronts.append((v, fp, None, k))
            calls["stage"] = f"SIFT, scan {i}"
            kp, secs = k_keypoints(v, raw[i])
            kps.append(kp)
            ksecs.append(secs)
            print(f"phase 13: (a) scan {i}: {v.capacity} voxels; keypoints "
                  + ", ".join(f"{n} {int(m.sum())} ({secs[n] * 1e3:.1f} ms)"
                              for n, m in kp.items())
                  + f" (SIFT over the {raw[i].capacity} raw points) [{card_line()}]", flush=True)
            expect(all(int(m.sum()) > 0 for m in kp.values()),
                   f"(a) scan {i}: a detector found no keypoint")
        tgt, src = fronts[0][0], fronts[1][0]
        union = [kp["harris"] | kp["iss"] for kp in kps]
        kidx = [torch.nonzero(u)[:, 0] for u in union]

        # (b) descriptors
        calls["stage"] = "descriptors"
        desc = [k_descriptors(fronts[i][0], kidx[i], gen.manual_seed(E_SEED + i))
                for i in (0, 1)]
        for name in desc[0]:
            outs = [d[name][0] for d in desc]
            finite = all(bool(torch.isfinite(o.float()).all()) for o in outs)
            print(f"phase 13: (b) {name}: {list(outs[0].shape)} / {list(outs[1].shape)}, "
                  f"{desc[0][name][1] * 1e3:.2f} / {desc[1][name][1] * 1e3:.2f} ms, peak "
                  f"{desc[0][name][2]:.0f} / {desc[1][name][2]:.0f} MiB, finite {finite} "
                  f"[{card_line()}]", flush=True)
            expect(finite, f"(b) {name} is not finite")
        shot_all = [d["SHOT (every voxel)"][0] for d in desc]
        for i in (0, 1):
            d = (desc[i]["SHOT (keypoints, surface)"][0] - shot_all[i][kidx[i]]).abs().max()
            expect(float(d) <= 1e-6, f"(b) scan {i}: SHOT at the keypoints with the voxels as "
                                     f"surface differs from the voxels' own rows by {float(d)}")
        device_breakdown("phase 13 (SHOT at every voxel of scan 1)",
                         lambda: features.estimate_shot(fronts[1][0], K_RADIUS, k=K_SHOT_K))
        pers = [int(d["FPFH persistence"][0].sum()) for d in desc]
        print(f"phase 13: (b) persistent FPFH voxels at {K_PERSISTENCE} m: {pers}; boundary "
              f"voxels {[int(d['boundary'][0].sum()) for d in desc]}", flush=True)

        # (c) matching: SHOT and FPFH of scan 1's keypoints to their nearest in scan 0's
        def inlier_share(f1, f0):
            nn = ia.feature_knn(f1[kidx[1]], torch.ones_like(kidx[1], dtype=torch.bool),
                                f0[kidx[0]], torch.ones_like(kidx[0], dtype=torch.bool), 1)[:, 0]
            truth = transform_points(torch.from_numpy(P).float().to(src.xyz.device),
                                     src.xyz[kidx[1]])
            gap = torch.linalg.vector_norm(truth - tgt.xyz[kidx[0][nn.long()]], dim=1)
            return float((gap <= K_MATCH).float().mean())

        share_shot = inlier_share(shot_all[1], shot_all[0])
        share_fpfh = inlier_share(fronts[1][1], fronts[0][1])
        print(f"phase 13: (c) {len(kidx[1])} scan-1 keypoints (Harris and ISS) matched into "
              f"{len(kidx[0])} of scan 0 by their nearest descriptor: within {K_MATCH} m of the "
              f"true counterpart SHOT {share_shot:.4f}, FPFH {share_fpfh:.4f}", flush=True)
        skp, tkp = src.with_mask(union[1]), tgt.with_mask(union[0])
        calls["stage"] = "prerejective sweep"
        b1 = launch_count("nn1")
        pre, psecs = timed(lambda: ia.prerejective_ransac(skp, shot_all[1], tkp, shot_all[0],
                                                          **E_PRE_KW))
        b1 = launch_count("nn1") - b1
        calls["stage"] = "point-to-plane ICP"
        cells = probed_cells(src, tgt, "icp", E_ICP_KW["max_corr_dist"])
        ref = icp(src, tgt, init_transform=pre.transform, variant="point_to_plane", **E_ICP_KW,
                  **cells)

        def left(T):
            d = T.double().cpu().numpy()[:3, 3] - P[:3, 3]
            return math.hypot(d[0], d[1]), abs(d[2]), pose_gap(T, torch.from_numpy(P))[1]

        g, r = left(pre.transform), left(ref.transform)
        print(f"phase 13: (c) prerejective RANSAC on the SHOT matches ({E_PRE_KW}): "
              f"{psecs * 1e3:.1f} ms, B1 {b1}, valid {bool(pre.valid)}, score "
              f"{float(pre.error):.6f}; left {g[0]:.3e} m across and up, {g[1]:.3e} m along, "
              f"{g[2]:.3e} rad; point-to-plane ICP {int(ref.iterations)} iterations: left "
              f"{r[0]:.3e} m, {r[1]:.3e} m, {r[2]:.3e} rad", flush=True)
        # the JAX package's CPU rehearsal on this pair (tests/rehearse_path_k.py)
        # misses path E's limits too: 0.47% of the keypoints' SHOT matches are
        # right (ROADMAP C54)
        print("phase 13: (c) pose printed, not checked: the JAX package's CPU rehearsal on "
              "this pair does not meet path E's limits either (PERF.md, path K)", flush=True)

        # (d) clusters and their global descriptors
        clusters = []
        for i in (0, 1):
            v = fronts[i][0]
            calls["stage"] = f"ESF midpoints, scan {i}"
            (labels, n_all), csecs = timed(lambda: segmentation.euclidean_clusters(
                v, K_CLUSTER_TOLERANCE, min_cluster_size=K_CLUSTER_MIN))
            ids = torch.unique(labels[labels >= 0])
            cl = [live_rows(v.with_mask(labels == c)) for c in ids]
            out, dsecs = timed(lambda: [k_cluster_descriptors(c, gen.manual_seed(E_SEED))
                                        for c in cl])
            clusters.append((cl, out))
            finite = all(bool(torch.isfinite(x).all()) for o in out for x in o.values())
            vfh_ok = all(all(abs(float(o["VFH"][45 * b:45 * (b + 1)].sum()) - 100.0) < 1e-2
                             for b in range(4))
                         and abs(float(o["VFH"][180:].sum()) - 100.0) < 1e-2 for o in out)
            print(f"phase 13: (d) scan {i}: {n_all} components, {len(cl)} clusters of at least "
                  f"{K_CLUSTER_MIN} voxels (tolerance {K_CLUSTER_TOLERANCE} m) in "
                  f"{csecs * 1e3:.1f} ms; sizes "
                  f"{sorted((c.capacity for c in cl), reverse=True)[:12]}; eight global "
                  f"descriptors each in {dsecs * 1e3:.1f} ms; finite {finite}, VFH blocks sum "
                  f"to 100 {vfh_ok}", flush=True)
            expect(len(cl) >= 5 and finite and vfh_ok, f"(d) scan {i}: clusters or descriptors")
        # the same car in both scans: clusters of car size whose centroids meet
        # under the known motion
        car = None
        cents = [[c.xyz.mean(0) for c in cl] for cl, _ in clusters]
        T = torch.from_numpy(P).float().to(src.xyz.device)
        for j1, c1 in enumerate(clusters[1][0] if cents[0] else []):
            ext = (c1.xyz.amax(0) - c1.xyz.amin(0)).cpu().numpy()
            if not (math.hypot(ext[0], ext[2]) >= 2.0 and ext[1] <= 2.5):
                continue
            w = transform_points(T, cents[1][j1][None])[0]
            d0 = [float((w - c0).norm()) for c0 in cents[0]]
            j0 = int(np.argmin(d0))
            if d0[j0] <= 1.0 and (car is None or c1.capacity > car[2]):
                car = (j0, j1, c1.capacity)
        expect(car is not None, "(d) no car seen in both scans")
        if car is not None:
            h0, h1 = clusters[0][1][car[0]]["CRH"], clusters[1][1][car[1]]["CRH"]
            ang, score = features.crh_align(h0, h1, 3)
            print(f"phase 13: (d) the car of {clusters[0][0][car[0]].capacity} / {car[2]} "
                  f"voxels in both scans: crh_align roll {[round(float(a), 4) for a in ang]} "
                  f"rad, scores {[round(float(x), 5) for x in score]}", flush=True)

    record_b1["launches_by_path"]["K"] = launch_count("nn1")
    record_b2["launches_by_path"]["K"] = launch_count("segsum")
    print(f"phase 13: path K launched B1 {launch_count('nn1')} times, B2 "
          f"{launch_count('segsum')} times", flush=True)
    expect(launch_count("segsum") == 2 + 2 * K_SIFT["n_octaves"],
           "path K's B2 launches are not one a downsample and one a SIFT octave")
    n_clusters = sum(len(cl) for cl, _ in clusters)
    stages = [c[0] for c in calls["nn1"]]
    expect(len(calls["nn1"]) == launch_count("nn1")
           and len(calls["segsum"]) == launch_count("segsum")
           and stages.count("prerejective sweep") == b1
           and sum(s_.startswith("SIFT") for s_ in stages) == 2
           and sum(s_.startswith("ESF") for s_ in stages) == n_clusters,
           f"path K's kernel calls were not all kept for (g): B1 {stages}, B2 "
           f"{[c[0] for c in calls['segsum']]}")

    # (e) invariance: scan 1's voxels moved by a seeded rigid motion
    rng = np.random.default_rng(E_SEED + 13)
    M = np.eye(4)
    M[:3, :3] = axis_rotation(rng.normal(size=3), math.radians(K_MOVE[1]))
    M[:3, 3] = rng.normal(size=3) * K_MOVE[0] / math.sqrt(3.0)
    Mt = torch.from_numpy(M).float().to(src.xyz.device)
    moved = Cloud(xyz=transform_points(Mt, src.xyz), mask=src.mask,
                  attrs=dict(src.attrs, normal=src.attrs["normal"] @ Mt[:3, :3].T))
    # rows with a decision float64 finds within 1e-4 of its cut (a facade
    # voxel on the 0.3 m lattice has a near-isotropic in-plane covariance,
    # SHOT's sign vote ties, and lattice neighbours sit on the sector lines)
    # are counted apart (C45, C49)
    inv_lines = []
    for name, fn in (("SHOT", lambda c: features.estimate_shot(c, K_RADIUS, k=K_SHOT_K)),
                     ("USC", lambda c: shape_context.estimate_usc(c, K_RADIUS)[0]),
                     ("RoPS", lambda c: rops.estimate_rops(c, K_RADIUS)[0])):
        a = fn(src) if name != "SHOT" else shot_all[1]
        b = fn(moved)
        f = torch.from_numpy(invariance_firm(src, name)).to(a.device)
        off, worst = row_agreement(a[f], b[f], K_INVARIANCE_TOL)
        loose, _ = row_agreement(a[~f], b[~f], K_INVARIANCE_TOL)
        inv_lines.append(f"{name}: of {int(f.sum())} firm rows {off} beyond "
                         f"{K_INVARIANCE_TOL:g} (max {worst:.2e}); of the other "
                         f"{int((~f).sum())}, {loose} beyond")
        expect(off <= K_INVARIANCE_SHARE * int(f.sum()),
               f"(e) {name} moved with the cloud: {off} firm rows beyond {K_INVARIANCE_TOL}")
    print(f"phase 13: (e) scan 1 moved by {K_MOVE[0]} m and {K_MOVE[1]} deg: "
          + "; ".join(inv_lines), flush=True)

    # (f) the card against the CPU on 2,048-voxel subclouds
    for i in (0, 1):
        lines, fsecs = timed(lambda: k_card_vs_cpu(fronts[i][0], raw[i], expect))
        print(f"phase 13: (f) scan {i}, card against CPU on {K_CPU_POINTS} voxels "
              f"({fsecs:.1f} s): " + "; ".join(lines), flush=True)

    # (g) every kernel call of (a)-(d) against its plain version, at the
    # shapes the main path gave it, bitwise; the prerejective sweep at its
    # full shape, the plain version on its first K_PLAIN_ROWS queries
    shapes1, esf = [], []
    for stage, t_, m_, q_ in calls["nn1"]:
        n = min(len(q_), K_PLAIN_ROWS)
        ik, dk = nn1_mod.nn1(t_, m_, q_)
        ip, dp = nn1_mod.nn1_plain(t_, m_, q_[:n])
        nd, dd = int((ik[:n] != ip).sum()), float((dk[:n] - dp).abs().max())
        expect(nd == 0 and dd == 0.0, f"(g) B1 differs from its plain version at {stage} "
                                      f"{len(q_)} x {len(t_)}: {nd} indices, d2 by {dd}")
        ms = cuda_ms(lambda: nn1_mod.nn1(t_, m_, q_), reps=5)
        plain_ms = cuda_ms(lambda: nn1_mod.nn1_plain(t_, m_, q_[:n]), reps=1)
        bound_s, bound_by = nn1_bound_ms(len(q_), len(t_))
        if stage.startswith("SIFT"):
            stage = f"{stage}, snap"
        row = {"case": stage, "q": len(q_), "m": len(t_), "ms": ms, "plain_ms": plain_ms,
               "plain_rows": n, "bound_ms": bound_s * 1e3, "bound_by": bound_by,
               "max_abs_err": dd}
        if stage.startswith("ESF"):
            esf.append(row)
            continue
        shapes1.append(row)
        print(f"phase 13: (g) nn1 at {stage} {len(q_)} x {len(t_)}: {ms:.3f} ms, bound "
              f"{bound_s * 1e3:.4f} ms ({bound_by}), plain {plain_ms:.2f} ms on {n} queries; "
              f"{nd} indices differ, max |d2 diff| {dd:.3e} [{card_line()}]", flush=True)
    # the clusters' ESF calls in one row: times and bounds summed over the calls
    by = [r["bound_by"] for r in esf]
    shapes1.append({"case": f"ESF midpoints ({len(esf)} calls)", "q": sum(r["q"] for r in esf),
                    "shapes": [[r["q"], r["m"]] for r in esf],
                    **{k: sum(r[k] for r in esf) for k in ("ms", "plain_ms", "bound_ms")},
                    "bound_by": max(set(by), key=by.count),
                    "max_abs_err": max(r["max_abs_err"] for r in esf)})
    print(f"phase 13: (g) nn1 at the clusters' ESF midpoints, {len(esf)} calls of "
          f"{min(r['q'] for r in esf)}-{max(r['q'] for r in esf)} x "
          f"{min(r['m'] for r in esf)}-{max(r['m'] for r in esf)}: {shapes1[-1]['ms']:.3f} ms "
          f"in all, bound {shapes1[-1]['bound_ms']:.4f} ms, plain {shapes1[-1]['plain_ms']:.2f} "
          f"ms; max |d2 diff| {shapes1[-1]['max_abs_err']:.3e} [{card_line()}]", flush=True)
    record_b1["path_k"] = shapes1
    shapes2, octave = [], {}
    for stage, vals, seg in calls["segsum"]:
        if stage.startswith("SIFT"):
            octave[stage] = octave.get(stage, -1) + 1
            stage = f"{stage}, octave {octave[stage]}"
        k_ = segsum.segment_sum_sorted(vals, seg)
        p_ = segsum.segment_sum_sorted_plain(vals, seg)
        err = float((k_ - p_).abs().max())
        n_seg = int(seg[seg < len(seg)].max()) + 1
        ms = cuda_ms(lambda: segsum.segment_sum_sorted(vals, seg), reps=20)
        plain_ms = cuda_ms(lambda: segsum.segment_sum_sorted_plain(vals, seg), reps=5)
        bound_s, bound_by = segsum_bound_ms(vals.shape[0], vals.shape[1], n_seg)
        # torch.segment_reduce from segment lengths (the invalid tail one more)
        lengths = torch.bincount(torch.clamp(seg, max=n_seg).long(), minlength=n_seg + 1)
        library_ms = cuda_ms(lambda: torch.segment_reduce(vals, "sum", lengths=lengths), reps=20)
        # runs of up to 64 rows add in row order in both (bitwise); a longer
        # run (a dense voxel by the scanner) is shared by a block, in another order
        scale = float(p_.abs().max())
        print(f"phase 13: (g) segsum at {stage} {list(vals.shape)} -> {n_seg} voxels: "
              f"{ms * 1e3:.1f} us, bound {bound_s * 1e6:.2f} us ({bound_by}), plain "
              f"{plain_ms * 1e3:.1f} us, torch.segment_reduce {library_ms * 1e3:.1f} us; max "
              f"|kernel - plain| {err:.3e} [{card_line()}]", flush=True)
        expect(err <= 1e-6 * scale, f"(g) B2 differs from its plain version at {stage}")
        shapes2.append({"case": stage, "n": vals.shape[0], "w": vals.shape[1],
                        "segments": n_seg, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_s * 1e3, "bound_by": bound_by, "max_abs_err": err,
                        "library_ms": library_ms})
    record_b2["path_k"] = shapes2
    check(not failed, "path K: " + "; ".join(failed))
    return {n: [d[n][1] for d in desc] for n in desc[0]}


L_CPU_VOXELS = 2048        # (e): the card against the CPU on this many voxels about the box
L_PLAIN_ROWS = 1 << 18     # (f): B1's plain version on the first rows of a large call


def l_card_vs_cpu(frame, out, expect):
    """(e): the slice's functions on the card against the port's CPU run, on
    the ``L_CPU_VOXELS`` voxels nearest the box's centre and on the frame
    taken every 8th pixel, with the CPU tests' tolerances: returns lines to
    print."""
    from pcl_tpu_torch import features
    from pcl_tpu_torch import segmentation as seg
    from pcl_tpu_torch import surface as srf
    from pcl_tpu_torch.core.cloud import make_cloud
    from pcl_tpu_torch.surface import poisson

    pose, lines = frame["pose"], []
    vxyz = out["vox_xyz"]
    near = np.argsort(np.linalg.norm(vxyz - to_camera(L_CENTERS[3], pose), axis=1),
                      kind="stable")[:L_CPU_VOXELS]
    sub = dict(xyz=vxyz[near], normal=out["vox_normal"][near], rgb=out["vox_rgb"][near])
    clouds = {d: make_cloud(sub["xyz"], attrs={"normal": sub["normal"], "rgb": sub["rgb"]},
                            device=d) for d in ("cuda", "cpu")}
    res = {}
    for d, c in clouds.items():
        r = {}
        m = srf.moving_least_squares(c, 0.03)
        r["mls"] = (m.xyz.cpu().numpy(), m.attrs["normal"].cpu().numpy(),
                    m.attrs["curvature"].cpu().numpy())
        r["gp3"] = srf.greedy_projection_triangulation(c, **L_FULL["gp3"])
        lo, hi = srf.reconstruction.hoppe_grid_bounds(c, 0.05)
        r["sdf"] = srf.hoppe_signed_distance(c, lo, hi, 32).cpu().numpy()
        gmin, _, cell, _ = poisson.poisson_bounds(c, 5, 1.15)
        chi, iso, _ = poisson.indicator_grid(c.xyz, c.mask, c.attrs["normal"],
                                             torch.from_numpy(gmin).to(d),
                                             torch.from_numpy(cell).to(d), 32)
        r["chi"] = (chi.cpu().numpy(), float(iso))
        sv = seg.supervoxel_clustering(c, 0.05, max_seeds=512)
        r["sv"] = (sv.labels.cpu().numpy(), sv.centers.cpu().numpy())
        r["lccp"] = seg.lccp_segmentation(sv)[0]
        r["mincut"] = seg.min_cut_segmentation(c, to_camera(L_CENTERS[3], pose),
                                               radius=L_BOX_RADIUS, **L_FULL["mincut"])
        seeds = -np.ones(len(near), np.int64)
        seeds[[0, len(near) - 1]] = [0, 1]
        r["walker"] = seg.random_walker(c, torch.from_numpy(seeds).to(d), n_labels=2,
                                        k=10, sigma=0.05).cpu().numpy()
        res[d] = r
    a, b = res["cuda"], res["cpu"]
    # normals up to their sign (C64), where the fit ran (curvature > 0)
    fitted = (a["mls"][2] > 0) & (b["mls"][2] > 0)
    e_mls = [float(np.abs(a["mls"][0] - b["mls"][0]).max()),
             float(1 - np.abs((a["mls"][1] * b["mls"][1]).sum(1))[fitted].min(initial=1.0))]
    expect(e_mls[0] <= 1e-5 and e_mls[1] <= 1e-4 and fitted.mean() > 0.99,
           f"(e) MLS on the card and the CPU differ by {e_mls[0]} m, normals by {e_mls[1]}")
    gp3_same = np.array_equal(a["gp3"][1], b["gp3"][1])
    # Hoppe: grid points whose two nearest voxels tie within 8 ulp of |q|^2 +
    # |t|^2 may take either (C55); the samples themselves may differ in their
    # last bit (linspace's rounding on each device)
    lo, hi = srf.reconstruction.hoppe_grid_bounds(clouds["cpu"], 0.05)
    q = srf.reconstruction.grid_points(torch.from_numpy(lo), torch.from_numpy(hi), 32).numpy()
    d2 = ((q[:, None, :].astype(np.float64) - sub["xyz"][None].astype(np.float64)) ** 2).sum(-1)
    part = np.partition(d2, 1, axis=1)
    scale = (q.astype(np.float64) ** 2).sum(1) + (sub["xyz"].astype(np.float64) ** 2).sum(1).max()
    firm = (part[:, 1] - part[:, 0] > 8 * 2.0 ** -23 * scale).reshape(a["sdf"].shape)
    sdf_gap = float(np.abs(a["sdf"] - b["sdf"])[firm].max())
    chi_gap = float(np.abs(a["chi"][0] - b["chi"][0]).max() / np.abs(b["chi"][0]).max())
    expect(sdf_gap <= 1e-6 and firm.mean() > 0.95,
           f"(e) Hoppe's SDF on the card and the CPU differs by {sdf_gap} on "
           f"{int(firm.sum())} firm grid points")
    expect(chi_gap <= 1e-5, f"(e) Poisson's chi on the card and the CPU differs by {chi_gap}")
    sv_same = np.array_equal(a["sv"][0], b["sv"][0])
    sv_gap = float(np.abs(a["sv"][1] - b["sv"][1]).max())
    expect(sv_same and sv_gap <= 1e-5, f"(e) supervoxels differ: labels equal {sv_same}, "
                                       f"centres by {sv_gap}")
    expect(np.array_equal(a["lccp"], b["lccp"]), "(e) LCCP differs on the card and the CPU")
    n_cut = int((a["mincut"] != b["mincut"]).sum())
    n_walk = int((a["walker"] != b["walker"]).sum())
    expect(n_cut <= 0.01 * len(near) and n_walk <= 0.01 * len(near),
           f"(e) min-cut ({n_cut}) or random walker ({n_walk}) labels differ")
    lines.append(f"{L_CPU_VOXELS} voxels: MLS {e_mls[0]:.2e} m, normals 1 - |n.n'| "
                 f"{e_mls[1]:.2e} on {int(fitted.sum())} fitted, GP3 triangles equal {gp3_same} "
                 f"({len(a['gp3'][1])}), Hoppe SDF {sdf_gap:.2e} on {int(firm.sum())} of "
                 f"{firm.size} grid points (the rest near a 1-NN tie), "
                 f"Poisson chi {chi_gap:.2e} of its largest, supervoxels equal {sv_same} "
                 f"(centres {sv_gap:.2e}), LCCP equal, min-cut {n_cut} and random walker "
                 f"{n_walk} labels differ")
    # the organized functions on every 8th pixel, with k-NN normals from the CPU
    xyz, valid = frame["xyz"][::8, ::8].copy(), frame["valid"][::8, ::8].copy()
    h, w = valid.shape
    pix = make_cloud(xyz.reshape(-1, 3), valid.reshape(-1), device="cpu")
    nrm = features.estimate_normals(pix, k=16).attrs["normal"].reshape(h, w, 3).numpy()
    org = {}
    for d in ("cuda", "cpu"):
        lab, regs = seg.organized_multi_plane_segmentation(
            xyz, nrm, valid, min_inliers=150, angular_threshold=0.1, distance_threshold=0.05,
            device=d)
        cc = seg.organized_connected_components(xyz, valid, 0.1, device=d).cpu().numpy()
        org[d] = (lab, [r.coefficients for r in regs], cc)
    same = (np.array_equal(org["cuda"][0], org["cpu"][0])
            and np.array_equal(org["cuda"][2], org["cpu"][2]))
    gap = max([float(np.abs(x - y).max()) for x, y in zip(org["cuda"][1], org["cpu"][1])] or [0])
    expect(same and gap <= 1e-6, f"(e) organized segmentation differs: labels equal {same}, "
                                 f"planes by {gap}")
    lines.append(f"{w} x {h} pixels: plane and component labels equal {same}, "
                 f"{len(org['cpu'][1])} planes within {gap:.1e}")
    return lines


def hold_to_plain(calls, nn1_mod, segsum, expect, tag, plain_rows, card, time_once=False):
    """Every kept B1 and B2 call (``kernel_calls``) again, held to its plain
    version at its own shape (B1's plain version on the first ``plain_rows``
    queries; B1 bitwise, B2 within 1e-6 of the largest sum) and timed beside
    its bound, its plain version and, for B2, ``torch.segment_reduce``.
    ``time_once`` times B1 once per shape (the first call of it; later calls
    of that shape are held, not timed, and counted in its row); with
    ``time_once="stage"`` once per stage and query count, the row giving the
    range of the targets' counts (``m_min``, ``m_max``). Returns the rows of
    B1 and of B2 for the kernels' JSON line."""
    rows1 = []
    by_shape = {}
    for stage, t_, m_, q_ in calls["nn1"]:
        t_, m_, q_ = t_.contiguous(), m_.contiguous(), q_.contiguous()
        n = min(len(q_), plain_rows)
        ik, dk = nn1_mod.nn1(t_, m_, q_)
        ip, dp = nn1_mod.nn1_plain(t_, m_, q_[:n])
        nd, dd = int((ik[:n] != ip).sum()), float((dk[:n] - dp).abs().max()) if n else 0.0
        expect(nd == 0 and dd == 0.0, f"B1 differs from its plain version at {stage} "
                                      f"{len(q_)} x {len(t_)}: {nd} indices, d2 by {dd}")
        shape = (stage, len(q_)) if time_once == "stage" else (len(q_), len(t_))
        if time_once and shape in by_shape:
            row = by_shape[shape]
            row["calls"] += 1
            row["max_abs_err"] = max(row["max_abs_err"], dd)
            if time_once == "stage":
                row["m_min"], row["m_max"] = min(row["m_min"], len(t_)), max(row["m_max"], len(t_))
            continue
        ms = cuda_ms(lambda: nn1_mod.nn1(t_, m_, q_), reps=5)
        plain_ms = cuda_ms(lambda: nn1_mod.nn1_plain(t_, m_, q_[:n]), reps=1)
        bound_s, bound_by = nn1_bound_ms(len(q_), len(t_))
        row = {"case": stage, "q": len(q_), "m": len(t_), "ms": ms, "plain_ms": plain_ms,
               "plain_rows": n, "bound_ms": bound_s * 1e3, "bound_by": bound_by,
               "max_abs_err": dd, "calls": 1}
        if time_once == "stage":
            row["m_min"] = row["m_max"] = len(t_)
        rows1.append(row)
        by_shape[shape] = row
        print(f"{tag} nn1 at {stage} {len(q_)} x {len(t_)}: {ms:.3f} ms, bound "
              f"{bound_s * 1e3:.4f} ms ({bound_by}), plain {plain_ms:.2f} ms on {n} queries; "
              f"{nd} indices differ, max |d2 diff| {dd:.3e} [{card}]", flush=True)
    if time_once:
        print(f"{tag} nn1: {len(calls['nn1'])} calls held to the plain version, "
              f"{len(rows1)} shapes timed", flush=True)
    if time_once == "stage":
        for row in rows1:
            print(f"{tag} nn1 at {row['case']}: {row['calls']} calls of {row['q']} x "
                  f"{row['m_min']}-{row['m_max']}", flush=True)
    rows2 = []
    for stage, vals, seg_ in calls["segsum"]:
        k_ = segsum.segment_sum_sorted(vals, seg_)
        p_ = segsum.segment_sum_sorted_plain(vals, seg_)
        err = float((k_ - p_).abs().max())
        n_seg = int(seg_[seg_ < len(seg_)].max()) + 1
        ms = cuda_ms(lambda: segsum.segment_sum_sorted(vals, seg_), reps=20)
        plain_ms = cuda_ms(lambda: segsum.segment_sum_sorted_plain(vals, seg_), reps=5)
        bound_s, bound_by = segsum_bound_ms(vals.shape[0], vals.shape[1], n_seg)
        lengths = torch.bincount(torch.clamp(seg_, max=n_seg).long(), minlength=n_seg + 1)
        library_ms = cuda_ms(lambda: torch.segment_reduce(vals, "sum", lengths=lengths), reps=20)
        expect(err <= 1e-6 * float(p_.abs().max()),
               f"B2 differs from its plain version at {stage}")
        rows2.append({"case": stage, "n": vals.shape[0], "w": vals.shape[1], "segments": n_seg,
                      "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
                      "bound_by": bound_by, "max_abs_err": err, "library_ms": library_ms})
        print(f"{tag} segsum at {stage} {list(vals.shape)} -> {n_seg} segments: "
              f"{ms * 1e3:.1f} us, bound {bound_s * 1e6:.2f} us ({bound_by}), plain "
              f"{plain_ms * 1e3:.1f} us, torch.segment_reduce {library_ms * 1e3:.1f} us; max "
              f"|kernel - plain| {err:.3e} [{card}]", flush=True)
    return rows1, rows2


def phase14_path_l(segsum, nn1_mod, record_b1, record_b2):
    """Path L: surface reconstruction and the rest of segmentation on path
    G's room, frame 0, at VGA and 1 cm voxels."""
    from pcl_tpu_torch.search import bruteforce

    failed = []

    def expect(cond: bool, what: str) -> None:
        """A check of this phase, raised with the others at its end."""
        if not cond:
            print(f"phase 14: CHECK FAILED: {what}", flush=True)
            failed.append(what)

    dev = torch.device("cuda")
    frame, fsecs = timed(lambda: path_l_frame(L_FULL))
    print(f"phase 14: frame 0 of the room at {G_SHAPE[1]} x {G_SHAPE[0]} rendered in "
          f"{fsecs:.1f} s: {int(frame['valid'].sum())} valid pixels, by surface "
          + ", ".join(f"{n} {int((frame['part'] == i).sum())}" for i, n in enumerate(L_NAMES)),
          flush=True)
    # warm-up at 80 x 60 (libraries, solvers, allocator)
    _, wsecs = timed(lambda: path_l_chain(path_l_frame(L_SMALL), L_SMALL, dev))
    print(f"phase 14: warm-up at 80 x 60 in {wsecs:.1f} s", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trace.reset()
    with kernel_calls(bruteforce, segsum) as calls:
        (out, secs), total = timed(lambda: path_l_chain(
            frame, L_FULL, dev, on_stage=lambda n: calls.__setitem__("stage", n)))
    record_b1["launches_by_path"]["L"] = launch_count("nn1")
    record_b2["launches_by_path"]["L"] = launch_count("segsum")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    card = card_line()
    print(f"phase 14: path L in {total:.1f} s, peak memory {peak:.2f} GiB, launches nn1 "
          f"{launch_count('nn1')}, segsum {launch_count('segsum')} [{card}]",
          flush=True)
    for name, v in secs.items():
        print(f"phase 14: {name}: {v * 1e3:.1f} ms [{card}]", flush=True)
    parts = {p: sum(v for k, v in secs.items() if k.startswith(p))
             for p in ("(a)", "(b)", "(c)", "(d)")}
    print("phase 14: by part " + ", ".join(f"{p} {v:.2f} s" for p, v in parts.items()),
          flush=True)
    expect(launch_count("nn1") >= 3 and launch_count("segsum") >= 1,
           "path L launched B1 fewer than 3 times (Hoppe, grid projection, the voxels' 1-NN) "
           "or B2 never (the voxel grid)")
    expect(len(calls["nn1"]) == launch_count("nn1")
           and len(calls["segsum"]) == launch_count("segsum"),
           "the kept kernel calls do not match the launch counts")

    m = path_l_metrics(frame, out, L_FULL)
    print("phase 14: metrics " + json.dumps(m, default=float), flush=True)
    lim = L_LIMITS
    expect(set(m["planes"]) == {L_NAMES[i] for i in L_PLANE_TRUTH
                                if (frame["part"] == i).sum() >= L_FULL["planes"]["min_inliers"]},
           f"(a) visible planes found: {sorted(m['planes'])}")
    for name, (deg, off) in m["planes"].items():
        expect(deg <= lim["plane_deg"] and off <= lim["plane_m"],
               f"(a) the {name} lies {deg:.4f} deg and {off:.5f} m off")
    expect(m["cluster_objects"] == list(L_OBJECTS),
           f"(b) the clusters' objects are {m['cluster_objects']}, not one box, sphere, cylinder")
    for name in ("gp3", "hoppe", "poisson"):
        _, nf, med, p99 = m[f"{name}_mesh"]
        expect(nf > 0 and med <= lim["mesh_median"][name] and p99 <= lim["mesh_p99"][name],
               f"(c) the {name} mesh lies off the room: median {med:.5f} m, p99 {p99:.5f} m")
    expect(m["sv_impurity"] <= lim["sv_impurity"],
           f"(d) supervoxel impurity {m['sv_impurity']:.4f}")
    # printed, not checked: the JAX package's convexity test merges a box top
    # with the floor beside it (parallel normals count as convex, C68)
    print(f"phase 14: (d) LCCP separates the objects from the floor: {m['lccp_separates']} "
          f"(the major segment of each: {m['lccp_segments']})", flush=True)
    expect(m["mincut_iou"] >= lim["mincut_iou"],
           f"(d) the min-cut foreground's IoU with the box's cluster is {m['mincut_iou']:.4f}")

    from pcl_tpu_torch import surface
    from pcl_tpu_torch.core.cloud import make_cloud

    vox = make_cloud(out["vox_xyz"], attrs={"normal": out["vox_normal"]})
    device_breakdown("phase 14 (moving_least_squares r=0.03 on the voxels)",
                     lambda: surface.moving_least_squares(vox, L_FULL["mls_radius"]))
    del vox
    lines, csecs = timed(lambda: l_card_vs_cpu(frame, out, expect))
    print(f"phase 14: (e) card against CPU ({csecs:.1f} s): " + "; ".join(lines), flush=True)

    # (f) every kernel call of the path against its plain version at its shape
    rows1, rows2 = hold_to_plain(calls, nn1_mod, segsum, expect, "phase 14: (f)", L_PLAIN_ROWS,
                                 card)
    record_b1["path_l"] = rows1
    record_b2["path_l"] = rows2
    check(not failed, "path L: " + "; ".join(failed))
    return {"total_s": total, "peak_gib": peak, "secs": secs, "parts": parts}


# ---------------------------------------------------------------- path M

M_FULL = dict(
    leaf=LEAF, depth=10,            # 0.2 m leaves, 1024 a side: 204.8 m
    queries=4096,                   # (c), (e): query points drawn from each scan
    rays=4096,                      # (f): rays from the sensor to a subsample of each scan
    box=10.0,                       # (c): side of the box about the sensor (m)
    voxel_cap=32, min_ray_steps=600,   # (f): >= 60 m at half-leaf steps of 0.1 m
    angular_deg=0.5, width=720, height=360,   # (i): the JAX defaults
    planar_focal=G_INTR[0],          # (i): path G's VGA frame at fx 525
    narf=dict(n_beams=36, rotation_invariant=True),
    seed=11)
M_CPU_POINTS = 8192                 # card against CPU: this many points of scans 0 and 1
M_PLAIN_ROWS = 1 << 15              # B1's plain version on the first rows of a call
M_EDGE = 1e-4                       # pixels: a point this near a pixel edge is left out
M_CENTROID_TOL = 1e-5               # m: centroids against float64 means


def path_m_inputs(scans, golden, n_scans=None, n_points=None):
    """Path C's scans in their own frames and in scan 0's frame (each moved
    by its golden pose, float32), the sensors' positions in scan 0's frame,
    and the shared tree origin: the least coordinate of every scan."""
    n_scans = len(scans) if n_scans is None else n_scans
    own = [np.asarray(s[:n_points], np.float32) for s in scans[:n_scans]]
    world = [(s.astype(np.float64) @ g[:3, :3].T + g[:3, 3]).astype(np.float32)
             for s, g in zip(own, golden)]
    sensors = np.stack([g[:3, 3] for g in golden[:n_scans]]).astype(np.float32)
    origin = np.min(np.concatenate(world), 0).astype(np.float32)
    return dict(own=own, world=world, sensors=sensors, origin=origin)


def _m_queries(world, M):
    """(c)'s query points of each scan: points drawn from it, and the same
    moved by up to 1 m on each axis (some in empty voxels), seeded."""
    rng = np.random.default_rng(M["seed"])
    out = []
    for w in world:
        q = w[rng.choice(len(w), M["queries"], replace=False)]
        jit = (q + rng.uniform(-1, 1, q.shape)).astype(np.float32)
        rays = w[rng.choice(len(w), M["rays"], replace=False)]
        out.append((q, jit, rays))
    return out


def m_rays(sensor: np.ndarray, ends: np.ndarray, M):
    """Rays from the sensor to ``ends``: every direction is ``(end - sensor) /
    L`` for the longest ray's length ``L`` and ``max_range`` is ``L``, so the
    samples of each ray clamp at its own end, at steps of at most half a
    leaf. Returns ``(origins, directions, max_range, max_steps)``."""
    d = (ends - sensor).astype(np.float32)
    L = float(np.sqrt((d.astype(np.float64) ** 2).sum(1)).max())
    steps = max(M["min_ray_steps"], int(math.ceil(L / (0.5 * M["leaf"]))) + 2)
    direction = (d / np.float32(L)).astype(np.float32)
    return np.broadcast_to(sensor, d.shape).astype(np.float32), direction, L, steps


def path_m_chain(inp, frame_xyz, M, dev, on_stage=None):
    """Path M on the port, on ``dev``: PCL's octree tutorials on the scans in
    scan 0's frame, one shared origin ((a)-(h)), and PCL's range-image and
    NARF tutorials on each scan in its own frame and on path G's frame
    ((i), (j)). Returns ``(out, seconds)``: host arrays and each call's host
    time (``"(a) build 0"`` and so on). ``on_stage(name)`` is told each
    call's name before it runs."""
    from pcl_tpu_torch import features, octree
    from pcl_tpu_torch.core import range_image
    from pcl_tpu_torch.core.cloud import make_cloud
    from pcl_tpu_torch.octree import iterators
    from pcl_tpu_torch.octree.containers import leaf_keys
    from pcl_tpu_torch.octree.double_buffer import DoubleBufferedOctree
    from pcl_tpu_torch.search import bruteforce

    out, secs = {}, {}

    def run(name, fn):
        if on_stage is not None:
            on_stage(name)
        t0 = _stamp(dev)
        r = fn()
        secs[name] = _stamp(dev) - t0
        return r

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    def h(x):
        return x.cpu().numpy()

    world = [t(w) for w in inp["world"]]
    masks = [torch.ones(len(w), dtype=torch.bool, device=dev) for w in world]
    origin = t(inp["origin"])
    S = len(world)
    qs = _m_queries(inp["world"], M)
    leaf, depth = M["leaf"], M["depth"]
    trees = []
    for k in range(S):
        tree = run(f"(a) build {k}", lambda: octree.build(world[k], masks[k], leaf, origin=origin,
                                                            depth=depth))
        trees.append(tree)
        out[f"keys {k}"], out[f"order {k}"], out[f"mask {k}"] = \
            h(tree.keys), h(tree.order), h(tree.mask)
    for k in range(S - 1):
        out[f"change {k + 1}"] = h(run(f"(b) change_detection {k + 1}",
                                       lambda: octree.change_detection(trees[k + 1], trees[k])))
    dbo = DoubleBufferedOctree(resolution=leaf, depth=depth, origin=inp["origin"],
                               device=str(dev))

    def buffer(k):
        if k:
            dbo.switch_buffers()
        dbo.set_cloud(world[k], masks[k])
        return (dbo.new_leaf_keys(), dbo.removed_leaf_keys(), dbo.new_point_indices(),
                dbo.xor_serialize())

    for k in range(S):
        (out[f"new leaves {k}"], out[f"removed leaves {k}"], out[f"new points {k}"],
         out[f"xor {k}"]) = run(f"(b) double buffer {k}", lambda: buffer(k))
    for k in range(S):
        q, jit, _ = (t(a) for a in qs[k])
        sensor = inp["sensors"][k]
        idx, valid = run(f"(c) voxel_search {k}",
                         lambda: octree.voxel_search(trees[k], q, cap=M["voxel_cap"]))
        out[f"voxel idx {k}"], out[f"voxel valid {k}"] = h(idx), h(valid)
        lo, hi = t(sensor - M["box"] / 2), t(sensor + M["box"] / 2)
        bidx, bvalid, bcount = run(f"(c) box_search {k}", lambda: octree.box_search(
            trees[k], lo, hi, world[k], cap=len(inp["world"][k])))
        out[f"box idx {k}"], out[f"box valid {k}"], out[f"box count {k}"] = \
            h(bidx), h(bvalid), int(bcount)
        out[f"occupied {k}"] = h(run(f"(c) is_voxel_occupied {k}",
                                     lambda: octree.is_voxel_occupied(trees[k], jit)))
    for k in range(S):
        c, n, nl = run(f"(d) leaf_centroids {k}", lambda: octree.leaf_centroids(trees[k],
                                                                                 world[k]))
        out[f"centroids {k}"], out[f"counts {k}"], out[f"leaves {k}"] = h(c), h(n), int(nl)

        def levels():
            return [int(octree.at_depth(trees[k], lv)[1].sum()) for lv in range(depth + 1)]
        out[f"at_depth {k}"] = run(f"(d) at_depth (every level) {k}", levels)
    for k in range(S):
        keys, nbr, nl = run(f"(e) adjacency {k}", lambda: octree.adjacency(trees[k]))
        out[f"adjacency keys {k}"], out[f"adjacency {k}"] = h(keys), h(nbr)
        grid = run(f"(e) occupancy_from_tree {k}", lambda: octree.occupancy_from_tree(trees[k]))
        nxt = (k + 1) % S
        grid2 = run(f"(e) set_occupied {k}",
                    lambda: octree.set_occupied(grid, world[nxt], masks[nxt]))
        out[f"grid {k}"], out[f"grid2 {k}"], out[f"grid2 n {k}"] = \
            h(grid.keys), h(grid2.keys), int(grid2.n_occupied)
        out[f"is_occupied {k}"] = h(run(f"(e) is_occupied {k}",
                                        lambda: octree.is_occupied(grid2, t(qs[k][1]))))
    for k in range(S):
        o, d, L, steps = m_rays(inp["sensors"][k], qs[k][2], M)
        rk, rv = run(f"(f) ray_intersected_voxels {k}", lambda: octree.ray_intersected_voxels(
            trees[k], t(o), t(d), L, max_steps=steps))
        out[f"ray keys {k}"], out[f"ray valid {k}"] = h(rk), h(rv)
        out[f"ray setup {k}"] = (o, d, L, steps)
    for k in range(S - 1):
        xs = world[k][trees[k].order.long()]
        ai, ad = run(f"(g) approx_nearest_search {k + 1}",
                     lambda: octree.approx_nearest_search(trees[k], xs, world[k + 1]))
        ei, ed = run(f"(g) exact nn1 (B1) {k + 1}",
                     lambda: bruteforce.nn1(xs, trees[k].mask, world[k + 1]))
        out[f"approx {k + 1}"], out[f"exact {k + 1}"] = (h(ai), h(ad)), (h(ei), h(ed))
    out["node counts"] = run("(h) node_counts_per_depth 0",
                             lambda: iterators.node_counts_per_depth(trees[0]))
    out["preorder"] = run("(h) depth_first_iterator 0",
                          lambda: sum(1 for _ in iterators.depth_first_iterator(trees[0])))
    out["leaf keys 0"] = h(leaf_keys(trees[0])[0])
    res = math.radians(M["angular_deg"])
    for k in range(S):
        cloud = make_cloud(t(inp["own"][k]), device=dev)
        ri = run(f"(i) create_from_cloud {k}", lambda: range_image.create_from_cloud(
            cloud, res, M["width"], M["height"]))
        back = run(f"(i) to_cloud {k}", lambda: range_image.to_cloud(ri))
        out[f"image {k}"], out[f"back {k}"], out[f"back mask {k}"] = \
            h(ri.ranges), h(back.xyz), h(back.mask)
        b = run(f"(j) extract_borders {k}", lambda: features.extract_borders(ri))
        out[f"borders {k}"], out[f"border score {k}"] = h(b.border_type), h(b.border_score)
        rc, val, ok = run(f"(j) narf_keypoints {k}", lambda: features.narf_keypoints(ri))
        out[f"keypoints {k}"] = (h(rc), h(val), h(ok))
        out[f"descriptors {k}"] = h(run(f"(j) narf_descriptors {k}", lambda: features.
                                        narf_descriptors(ri, rc, **M["narf"])))
    Hh, Ww = frame_xyz.shape[:2]
    fc = make_cloud(t(frame_xyz.reshape(-1, 3)), t((frame_xyz[..., 2] > 0).reshape(-1)),
                    device=dev)
    pri = run("(i) create_planar_from_cloud", lambda: range_image.create_planar_from_cloud(
        fc, M["planar_focal"], Ww, Hh))
    out["planar"] = h(pri.ranges)
    return out, secs


def _np_spread3(v):
    v = v & 0x3FF
    for s, m in ((16, 0x30000FF), (8, 0x300F00F), (4, 0x30C30C3), (2, 0x9249249)):
        v = (v | (v << s)) & m
    return v


def np_morton(cells: np.ndarray) -> np.ndarray:
    c = cells.astype(np.int64)
    return (_np_spread3(c[..., 0]) | (_np_spread3(c[..., 1]) << 1)
            | (_np_spread3(c[..., 2]) << 2)).astype(np.int32)


def np_keys(p: np.ndarray, origin: np.ndarray, M, truncate: bool = False) -> np.ndarray:
    """Morton keys of float32 points as the port casts them: ``floor`` (or,
    with ``truncate``, truncation) of the float32 cell, clipped."""
    f = (p - origin) / np.float32(M["leaf"])
    c = np.trunc(f) if truncate else np.floor(f)
    return np_morton(np.clip(c, 0, (1 << M["depth"]) - 1).astype(np.int64))


def pixel_coords(p: np.ndarray, M, planar: bool):
    """float64 pixel coordinates ``(a, b)`` of points in the sensor frame and
    their ranges."""
    p = p.astype(np.float64)
    r = np.sqrt((p ** 2).sum(1))
    with np.errstate(all="ignore"):
        if planar:
            f = M["planar_focal"]
            a, b = f * p[:, 0] / p[:, 2], f * p[:, 1] / p[:, 2]
        else:
            res = math.radians(M["angular_deg"])
            a, b = np.arctan2(p[:, 0], p[:, 2]) / res, np.arcsin(p[:, 1] / r) / res
    return a, b, r


def _pixels(p: np.ndarray, M, planar: bool, H: int, W: int):
    """``(a, b, r, ok, near)``: float64 pixel coordinates and ranges of the
    points, which of them project, and which lie within ``M_EDGE`` of a
    pixel edge."""
    a, b, r = pixel_coords(p, M, planar)
    a, b = a + W / 2.0, b + H / 2.0
    ok = np.isfinite(a) & np.isfinite(b) & (r > 0) & ((p[:, 2] > 0) if planar else True)
    near = ok & ((np.abs(a - np.round(a)) < M_EDGE) | (np.abs(b - np.round(b)) < M_EDGE))
    return a, b, r, ok, near


def edge_free_pixels(p: np.ndarray, M, planar: bool, H: int, W: int):
    """``[H W]`` bool: the pixels no point within ``M_EDGE`` of a pixel edge
    can reach, and the number of such points."""
    a, b, _, _, near = _pixels(p, M, planar, H, W)
    check = np.ones(H * W, bool)
    for da in (-M_EDGE, M_EDGE):
        for db in (-M_EDGE, M_EDGE):
            u, v = np.floor(a[near] + da), np.floor(b[near] + db)
            inb = (u >= 0) & (u < W) & (v >= 0) & (v < H)
            check[(v[inb] * W + u[inb]).astype(np.int64)] = False
    return check, int(near.sum())


def zbuffer_check(p: np.ndarray, img: np.ndarray, M, planar: bool):
    """The image against a float64 z-buffer of ``p``: pixels that a point
    within ``M_EDGE`` of a pixel edge can reach are left out. Returns
    ``(n_bad, n_near_points, n_checked, argmin point per checked pixel,
    checked pixels)``."""
    H, W = img.shape
    a, b, r, ok, near = _pixels(p, M, planar, H, W)
    check, _ = edge_free_pixels(p, M, planar, H, W)
    u, v = np.floor(a), np.floor(b)
    land = ok & ~near & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    flat = (v[land] * W + u[land]).astype(np.int64)
    rr = r[land]
    ref = np.full(H * W, np.inf)
    np.minimum.at(ref, flat, rr)
    got = img.reshape(-1).astype(np.float64)
    seen = np.isfinite(ref) & check
    bad = int((np.abs(got[seen] - ref[seen]) > 2.5e-7 * ref[seen]).sum())
    bad += int(((got > -np.inf) & ~np.isfinite(ref) & check).sum())   # a pixel no point reached
    order = np.lexsort((rr, flat))
    first = np.ones(len(order), bool)
    first[1:] = flat[order][1:] != flat[order][:-1]
    pix, who = flat[order][first], np.flatnonzero(land)[order][first]
    keep = check[pix]
    return bad, int(near.sum()), int(seen.sum()), who[keep], pix[keep]


def path_m_checks(inp, frame_xyz, out, M):
    """(a)-(j) against numpy on the same inputs. Returns ``(failed, metrics)``."""
    failed, met = [], {}

    def expect(cond, what):
        if not cond:
            failed.append(what)

    S, origin, depth = len(inp["world"]), inp["origin"], M["depth"]
    PAD = 2 ** 31 - 1
    qs = _m_queries(inp["world"], M)
    uniq = []
    for k in range(S):
        w = inp["world"][k]
        keys, order, mask = out[f"keys {k}"], out[f"order {k}"], out[f"mask {k}"]
        # (a)
        expect(bool((np.diff(keys.astype(np.int64)) >= 0).all()), f"(a) scan {k}: keys not sorted")
        kn = np_keys(w, origin, M)
        cells = np.clip(np.floor((w - origin) / np.float32(M["leaf"])), 0, (1 << depth) - 1)
        u = np.unique(kn)
        uniq.append(u)
        expect(len(np.unique(cells, axis=0)) == len(u) == len(np.unique(keys[mask])),
               f"(a) scan {k}: leaf count differs from numpy's unique cells")
        expect(np.array_equal(keys, kn[order]) and mask.all(), f"(a) scan {k}: keys differ")
        met[f"leaves {k}"] = len(u)
        # (b)
        if k:
            ch = ~np.isin(kn, uniq[k - 1])
            expect(np.array_equal(out[f"change {k}"], ch), f"(b) scan {k}: change mask")
            expect(np.array_equal(np.sort(out[f"new points {k}"]), np.flatnonzero(ch)),
                   f"(b) scan {k}: new_point_indices is not the change mask's nonzero")
            expect(np.array_equal(out[f"new leaves {k}"], np.setdiff1d(u, uniq[k - 1])) and
                   np.array_equal(out[f"removed leaves {k}"], np.setdiff1d(uniq[k - 1], u)),
                   f"(b) scan {k}: new or removed leaves")
            met[f"new points {k}"] = int(ch.sum())
        # (c)
        q, jit, _ = qs[k]
        qk = np_keys(q, origin, M)
        lo, hi = np.searchsorted(keys, qk, "left"), np.searchsorted(keys, qk, "right")
        pos = lo[:, None] + np.arange(M["voxel_cap"])[None, :]
        valid = pos < hi[:, None]
        idx = order[np.clip(pos, 0, len(keys) - 1)]
        expect(np.array_equal(out[f"voxel valid {k}"], valid) and
               np.array_equal(out[f"voxel idx {k}"][valid], idx[valid]),
               f"(c) scan {k}: voxel_search")
        s = inp["sensors"][k]
        blo, bhi = s - np.float32(M["box"] / 2), s + np.float32(M["box"] / 2)
        ws = w[order]
        inside = np.all((ws >= blo) & (ws <= bhi), 1)
        cnt = out[f"box count {k}"]
        expect(cnt == int(inside.sum()) and np.array_equal(out[f"box idx {k}"][:cnt],
                                                           order[inside]),
               f"(c) scan {k}: box_search")
        expect(np.array_equal(out[f"occupied {k}"], np.isin(np_keys(jit, origin, M), u)),
               f"(c) scan {k}: is_voxel_occupied")
        met[f"box {k}"] = cnt
        # (d)
        L = out[f"leaves {k}"]
        counts = np.unique(kn, return_counts=True)[1]
        expect(L == len(u) and np.array_equal(out[f"counts {k}"][:L], counts) and
               (out[f"counts {k}"][L:] == 0).all(), f"(d) scan {k}: leaf counts")
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        means = np.add.reduceat(ws.astype(np.float64), starts, axis=0) / counts[:, None]
        cerr = float(np.abs(out[f"centroids {k}"][:L] - means).max())
        expect(cerr <= M_CENTROID_TOL, f"(d) scan {k}: centroids {cerr:.3e} m from float64")
        met[f"centroid err {k}"] = cerr
        expect(out[f"at_depth {k}"] == [len(np.unique(u >> (3 * (depth - lv))))
                                        for lv in range(depth + 1)], f"(d) scan {k}: at_depth")
        # (e)
        cl = np.stack([_np_compact3(u), _np_compact3(u >> 1), _np_compact3(u >> 2)], 1)
        offs = np.array([(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)
                         if (a, b, c) != (0, 0, 0)])
        nc = cl[:, None, :] + offs[None]
        inb = np.all((nc >= 0) & (nc < (1 << depth)), -1)
        nk = np_morton(np.clip(nc, 0, (1 << depth) - 1))
        p = np.clip(np.searchsorted(u, nk), 0, len(u) - 1)
        nbr = np.where(inb & (u[p] == nk), p, -1)
        adj = out[f"adjacency {k}"]
        expect(np.array_equal(adj[:len(u)], nbr) and (adj[len(u):] == -1).all() and
               np.array_equal(out[f"adjacency keys {k}"][:len(u)], u), f"(e) scan {k}: adjacency")
        met[f"mean degree {k}"] = float((nbr >= 0).sum(1).mean())
        g = out[f"grid {k}"]
        expect(np.array_equal(g[:len(u)], u) and (g[len(u):] == PAD).all(),
               f"(e) scan {k}: occupancy grid")
        un = np.union1d(u, np_keys(inp["world"][(k + 1) % S], origin, M))
        g2 = out[f"grid2 {k}"]
        expect(out[f"grid2 n {k}"] == len(un) and np.array_equal(g2[:len(un)], un) and
               (g2[len(un):] == PAD).all() and len(g2) == len(w) + len(inp["world"][(k + 1) % S]),
               f"(e) scan {k}: set_occupied")
        expect(np.array_equal(out[f"is_occupied {k}"], np.isin(np_keys(jit, origin, M), un)),
               f"(e) scan {k}: is_occupied")
        # (f)
        o, d, Lr, steps = out[f"ray setup {k}"]
        end = o + d * np.float32(Lr)
        end_key = np_keys(end, origin, M, truncate=True)
        own_key = np_keys(qs[k][2], origin, M)
        rv, rk = out[f"ray valid {k}"], out[f"ray keys {k}"]
        has = rv.any(1)
        last = np.where(has, rk[np.arange(len(rk)), rv.shape[1] - 1 - np.argmax(rv[:, ::-1], 1)],
                        -1)
        same = end_key == own_key
        expect(bool((last[same] == own_key[same]).all()),
               f"(f) scan {k}: a ray's last hit is not its point's voxel")
        met[f"rays ending off their voxel {k}"] = int((~same).sum())
        met[f"occluded share {k}"] = float((rv.sum(1) > 1).mean())
        met[f"ray steps {k}"] = steps
    # (g)
    for k in range(1, S):
        xs = inp["world"][k - 1][out[f"order {k - 1}"]].astype(np.float64)
        q = inp["world"][k].astype(np.float64)
        (ai, ad), (ei, ed) = out[f"approx {k}"], out[f"exact {k}"]
        da = ((q - xs[ai]) ** 2).sum(1)
        de = ((q - xs[ei]) ** 2).sum(1)
        slack = 2.0 ** -20 * ((q ** 2).sum(1) + (xs[ei] ** 2).sum(1))
        expect(bool((da >= de - slack).all()), f"(g) scan {k}: an approximate d2 below the exact")
        expect(bool((np.abs(ad - da) <= 1e-6 * np.maximum(da, 1e-6)).all()
                    and (np.abs(ed - de) <= 1e-6 * np.maximum(de, 1e-6)).all()),
               f"(g) scan {k}: a reported d2 is not its points' distance")
        met[f"exact share {k}"] = float((da <= de).mean())
        met[f"near-tie queries {k}"] = int(((da < de) & (da >= de - slack)).sum())
    # (h)
    nodes = [len(np.unique(uniq[0] >> (3 * (depth - d_)))) for d_ in range(depth + 1)]
    expect(out["node counts"] == nodes and out["preorder"] == sum(nodes),
           "(h) node counts or the preorder's length")
    met["nodes per depth"] = nodes
    # (i), (j)
    res = math.radians(M["angular_deg"])
    for k in range(S):
        img = out[f"image {k}"]
        bad, near, n_chk, who, pix = zbuffer_check(inp["own"][k], img, M, False)
        expect(bad == 0, f"(i) scan {k}: {bad} pixels are not their points' least range")
        back = out[f"back {k}"][pix]
        pts = inp["own"][k][who].astype(np.float64)
        r = np.sqrt((pts ** 2).sum(1))
        off = np.sqrt(((back - pts) ** 2).sum(1))
        expect(bool((off <= r * res + 1e-5).all()), f"(i) scan {k}: to_cloud off its pixel")
        expect(np.array_equal(out[f"back mask {k}"], np.isfinite(img.reshape(-1))),
               f"(i) scan {k}: to_cloud's mask")
        met[f"image {k}"] = (int(np.isfinite(img).sum()), near, n_chk)
        rc, val, ok = out[f"keypoints {k}"]
        desc = out[f"descriptors {k}"]
        expect(bool(np.isfinite(out[f"border score {k}"]).all() and np.isfinite(val).all()
                    and np.isfinite(desc).all() and ok.sum() <= len(ok) == 128
                    and desc.shape == (128, M["narf"]["n_beams"])), f"(j) scan {k}: NARF")
        met[f"keypoints {k}"] = int(ok.sum())
        met[f"obstacle borders {k}"] = int((out[f"borders {k}"] == 1).sum())
    p = frame_xyz.reshape(-1, 3)
    bad, near, n_chk, _, _ = zbuffer_check(p[p[:, 2] > 0], out["planar"], M, True)
    expect(bad == 0, f"(i) planar: {bad} pixels are not their points' least range")
    met["planar"] = (int(np.isfinite(out["planar"]).sum()), near, n_chk)
    return failed, met


def _np_compact3(v):
    v = v.astype(np.int64) & 0x9249249
    for s, m in ((2, 0x30C30C3), (4, 0x300F00F), (8, 0x30000FF), (16, 0x3FF)):
        v = (v | (v >> s)) & m
    return v


def m_card_vs_cpu(inp, frame_xyz, M, expect):
    """Path M's chain on the card and in the port's CPU run on the same
    small inputs: trees, keys, masks, searches, adjacency, occupancy, rays,
    iterator counts and the range images (leaving out the pixels a point
    within ``M_EDGE`` of an edge can reach: the devices' ``atan2`` may round
    apart) equal; centroids and ``to_cloud`` within 1e-6 of their scale;
    NARF on the CPU's images on both devices: borders, interest and
    keypoints equal, descriptors within 1e-6. Returns printable lines."""
    from pcl_tpu_torch import features
    from pcl_tpu_torch.core.range_image import RangeImage

    card, _ = path_m_chain(inp, frame_xyz, M, torch.device("cuda"))
    cpu, _ = path_m_chain(inp, frame_xyz, M, torch.device("cpu"))
    lines, skip = [], ("centroids", "back", "image", "planar", "borders", "border score",
                       "keypoints", "descriptors", "ray setup")
    for key in cpu:
        if key.startswith(skip):
            continue
        a, b = card[key], cpu[key]
        same = (all(np.array_equal(x, y) for x, y in zip(a, b)) if isinstance(a, tuple)
                else np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b)
        expect(same, f"card against CPU: {key} differs")
    S = len(inp["world"])
    for k in range(S):
        scale = float(np.abs(inp["world"][k]).max())
        err = float(np.abs(card[f"centroids {k}"] - cpu[f"centroids {k}"]).max())
        expect(err <= 1e-6 * scale, f"card against CPU: centroids {k} by {err:.3e}")
        lines.append(f"centroids {k} within {err:.2e} m")
    res = math.radians(M["angular_deg"])
    for key, p, planar in [(f"image {k}", inp["own"][k], False) for k in range(S)] + [
            ("planar", frame_xyz.reshape(-1, 3)[frame_xyz.reshape(-1, 3)[:, 2] > 0], True)]:
        a, b = card[key], cpu[key]
        check_px, n_near = edge_free_pixels(p, M, planar, *b.shape)
        diff = ~((a == b) | (np.isneginf(a) & np.isneginf(b))).reshape(-1)
        expect(not (diff & check_px).any(),
               f"card against CPU: {key}: {int((diff & check_px).sum())} pixels differ")
        lines.append(f"{key}: {int(diff.sum())} pixels differ, all within rounding of an edge "
                     f"({n_near} points)")
        if key == "planar":
            continue
        k = int(key.split()[1])
        both = (np.isfinite(a) & np.isfinite(b) & (a == b)).reshape(-1)
        r = a.reshape(-1)[both]
        e = np.abs(card[f"back {k}"][both] - cpu[f"back {k}"][both]).max(1)
        expect(bool((e <= 1e-6 * r).all()), f"card against CPU: to_cloud {k}")
        ri = dict(ranges=b, angular_res=np.float32(res), center=np.float32(
            [M["width"] / 2.0, M["height"] / 2.0]), sensor_pose=np.eye(4, dtype=np.float32))
        outs = []
        for dev in ("cuda", "cpu"):
            img = RangeImage(**{n: torch.as_tensor(v, device=dev) for n, v in ri.items()},
                             planar=False)
            bd = features.extract_borders(img)
            it = features.narf_interest_image(img)
            rc, val, ok = features.narf_keypoints(img)
            dsc = features.narf_descriptors(img, rc, **M["narf"])
            outs.append([x.cpu().numpy() for x in (bd.border_type, bd.border_score, it, rc, val,
                                                    ok, dsc)])
        for name, x, y in zip(("borders", "border score", "interest", "keypoints",
                               "keypoint interest", "keypoint valid"), outs[0], outs[1]):
            expect(np.array_equal(x, y), f"card against CPU: NARF {name} of image {k}")
        derr = float(np.abs(outs[0][-1] - outs[1][-1]).max())
        expect(derr <= 1e-6, f"card against CPU: NARF descriptors of image {k} by {derr:.3e}")
        lines.append(f"NARF {k}: descriptors within {derr:.2e}")
    return lines


def phase15_path_m(segsum, nn1_mod, scans, golden, record_b1, record_b2):
    """Path M: PCL's octree, range-image and NARF tutorials on path C's six
    scans at full width (0.2 m leaves, depth 10, one shared origin)."""
    from pcl_tpu_torch.search import bruteforce

    failed = []

    def expect(cond: bool, what: str) -> None:
        if not cond:
            print(f"phase 15: CHECK FAILED: {what}", flush=True)
            failed.append(what)

    dev = torch.device("cuda")
    inp = path_m_inputs(scans, golden)
    frame_xyz = path_l_frame(L_FULL)["xyz"]
    small = path_m_inputs(scans, golden, n_scans=2, n_points=M_CPU_POINTS)
    M_small = dict(M_FULL, queries=1024, rays=1024)
    _, wsecs = timed(lambda: path_m_chain(small, frame_xyz, M_small, dev))
    print(f"phase 15: warm-up on {M_CPU_POINTS} points of two scans in {wsecs:.1f} s", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trace.reset()
    with kernel_calls(bruteforce, segsum) as calls:
        (out, secs), total = timed(lambda: path_m_chain(
            inp, frame_xyz, M_FULL, dev, on_stage=lambda n: calls.__setitem__("stage", n)))
    b1, b2 = launch_count("nn1"), launch_count("segsum")
    record_b1["launches_by_path"]["M"] = b1
    record_b2["launches_by_path"]["M"] = b2
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    card = card_line()
    S = len(scans)
    print(f"phase 15: path M on {S} scans of {[len(w) for w in inp['world']]} points in "
          f"{total:.2f} s, peak memory {peak:.2f} GiB, launches nn1 {b1}, segsum {b2} [{card}]",
          flush=True)
    by_call = {}
    for name, v in secs.items():
        base = name.rsplit(" ", 1)[0] if name[-1].isdigit() else name
        by_call.setdefault(base, []).append(v)
    for name, v in by_call.items():
        print(f"phase 15: {name}: {np.mean(v) * 1e3:.3f} ms a call ({len(v)} calls, "
              f"{min(v) * 1e3:.3f}-{max(v) * 1e3:.3f}) [{card}]", flush=True)
    per_scan = [sum(v for n, v in secs.items() if n.endswith(f" {k}") and n[1] in "acdefij")
                for k in range(S)]
    print("phase 15: per scan (a), (c)-(f), (i), (j): "
          + ", ".join(f"{v * 1e3:.1f}" for v in per_scan) + f" ms [{card}]", flush=True)
    expect(b1 == S - 1 and b2 == S, f"path M launched B1 {b1} times (one a pair expected) and "
                                    f"B2 {b2} times (one a scan)")
    expect(len(calls["nn1"]) == b1 and len(calls["segsum"]) == b2,
           "the kept kernel calls do not match the launch counts")
    fails, met = path_m_checks(inp, frame_xyz, out, M_FULL)
    for f in fails:
        expect(False, f)
    print("phase 15: metrics " + json.dumps(met, default=float), flush=True)
    lines, csecs = timed(lambda: m_card_vs_cpu(small, frame_xyz, M_small, expect))
    print(f"phase 15: card against CPU ({csecs:.1f} s): " + "; ".join(lines), flush=True)
    rows1, rows2 = hold_to_plain(calls, nn1_mod, segsum, expect, "phase 15:", M_PLAIN_ROWS, card)
    record_b1["path_m"] = rows1
    record_b2["path_m"] = rows2
    check(not failed, "path M: " + "; ".join(failed))
    return {"total_s": total, "peak_gib": peak, "per_scan_s": per_scan}


# ---------------------------------------------------------------- path N

N_MODEL_SEED = 11           # the models' render (range noise, dropped pixels)
N_SURFACE_SEED = 12         # the global database's surface samples
N_TURN = 25.0               # deg: the models' camera turned about each object's vertical
N_FRAME_G = 20              # path G's handheld frame that LINEMOD and the forest search
N_OBJECTS = {3: "box", 4: "sphere", 5: "cylinder"}
N_FULL = dict(
    L=L_FULL, leaf=0.01, normal_k=16,
    # PCL's correspondence_grouping.cpp parameters x 3 (its 1 m Kinect to this 1 cm grid)
    key_leaf=0.03, shot_radius=0.06, match_d2=0.25, rf_radius=0.045, cg_size=0.03,
    cg_thresh=5, hough_bin=0.03, hough_thresh=5.0, sac_threshold=0.03, sac_hypotheses=4096,
    max_instances=4,
    # global_hypothesis_verification.cpp: inlier 5 mm x 3, clutter radius 3 cm x 3
    hv_points=2048, hv=dict(inlier_threshold=0.015), hv_global=dict(clutter_radius=0.09),
    wrong_shift=0.3, tricp=dict(trim_fraction=0.7, max_iterations=30),
    orr=dict(pair_dist=0.2, n_hypotheses=256), hash_bins=16, hash_pairs=2048,
    lm_features=63, lm_threshold=0.8, gp_views=8,
    gp_recognize=dict(n_candidates=3, refine_iterations=30),    # recognize_clusters' defaults
    seg=dict(plane_threshold=0.02, cluster_tolerance=0.05, min_cluster_size=50, max_clusters=8),
    ism_sampling=0.03, ism_clusters=184, fpfh_k=16,
    face=dict(patch=24, n_pos=80, n_neg=160, stride=4, threshold=0.6),
    surface_points=20_000)
# 80 x 60 for the CPU tests (tests/test_torch_path_n.py) and the card-against-CPU run:
# path L's small frame, lengths grown with the pixels
N_SMALL = dict(
    N_FULL, L=L_SMALL, leaf=0.04, key_leaf=0.08, shot_radius=0.24, rf_radius=0.18,
    cg_size=0.12, cg_thresh=4, hough_bin=0.12, hough_thresh=4.0, sac_threshold=0.12,
    sac_hypotheses=128, max_instances=2, hv_points=256, hv=dict(inlier_threshold=0.06),
    hv_global=dict(clutter_radius=0.3), orr=dict(pair_dist=0.4, n_hypotheses=16,
                                                 dist_tol=0.1, inlier_dist=0.1),
    hash_bins=8, hash_pairs=256, lm_features=31, lm_threshold=0.6, gp_views=1,
    seg=dict(plane_threshold=0.08, cluster_tolerance=0.2,
                                  min_cluster_size=5, max_clusters=8),
    ism_sampling=0.12, ism_clusters=24, fpfh_k=8,
    face=dict(patch=8, n_pos=20, n_neg=40, stride=2, threshold=0.6), surface_points=2000,
    gp_recognize=dict(n_candidates=2, refine_iterations=10))


def _turned_about(pose: np.ndarray, centre, deg: float) -> np.ndarray:
    """``pose`` turned by ``deg`` about the world's vertical (y) through
    ``centre``."""
    from scipy.spatial.transform import Rotation

    R = np.eye(4)
    R[:3, :3] = Rotation.from_euler("y", deg, degrees=True).as_matrix()
    c = np.eye(4)
    c[:3, 3] = centre
    return c @ R @ np.linalg.inv(c) @ pose


def object_surface(i: int, n: int, rng) -> np.ndarray:
    """``n`` points on object ``i``'s whole surface (box, sphere, cylinder
    with its top cap), uniform by area, centred on the object (float32)."""
    if i == 3:
        lo, hi = (np.array(b) for b in G_BOX)
        ext = hi - lo
        areas = np.array([ext[1] * ext[2], ext[0] * ext[2], ext[0] * ext[1]]).repeat(2)
        face = rng.choice(6, n, p=areas / areas.sum())
        p = lo + rng.random((n, 3)) * ext
        ax = face // 2
        p[np.arange(n), ax] = np.where(face % 2 == 0, lo[ax], hi[ax])
        return (p - (lo + hi) / 2).astype(np.float32)
    if i == 4:
        v = rng.normal(size=(n, 3))
        return (G_SPHERE[1] * v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    (_, _), r, (y0, y1) = G_CYLINDER
    side, cap = 2 * np.pi * r * (y1 - y0), np.pi * r * r
    on_cap = rng.random(n) < cap / (side + cap)
    th = rng.uniform(0, 2 * np.pi, n)
    rho = np.where(on_cap, r * np.sqrt(rng.random(n)), r)
    y = np.where(on_cap, y0, rng.uniform(y0, y1, n)) - 0.5 * (y0 + y1)
    return np.stack([rho * np.cos(th), y, rho * np.sin(th)], 1).astype(np.float32)


def path_n_inputs(N):
    """Path N's host inputs: frame 0 of the room, each object's model (the
    pixels of its part in a render from path G's start turned ``N_TURN``
    about the object, in that camera's frame), path G's frame ``N_FRAME_G``
    with the same colours, and each object's whole surface for the global
    database."""
    from pcl_tpu_torch.fusion import Intrinsics

    L = N["L"]
    frame = path_l_frame(L)
    intr = Intrinsics(*L["intr"])
    H, W = L["shape"]
    rng = np.random.default_rng(N_MODEL_SEED)
    models = {}
    for i in N_OBJECTS:
        pose = _turned_about(frame["pose"], L_CENTERS[i], N_TURN)
        depth, _ = render_depth(pose, intr, H, W, rng)
        v, u = np.mgrid[0:H, 0:W]
        xyz = np.stack([(u - intr.cx) / intr.fx * depth, (v - intr.cy) / intr.fy * depth,
                        depth], -1).reshape(-1, 3).astype(np.float32)
        ok = depth.reshape(-1) > 0
        part = np.argmin(room_parts(to_world(xyz, pose)), 0)
        models[i] = dict(xyz=xyz[ok & (part == i)], pose=pose)
    g_pose = handheld(np.random.default_rng(G_SEED), N_FRAME_G + 1)[N_FRAME_G]
    frame_g = room_frame(L, g_pose, L_SEED)
    srng = np.random.default_rng(N_SURFACE_SEED)
    surfaces = {N_OBJECTS[i]: object_surface(i, N["surface_points"], srng) for i in N_OBJECTS}
    return dict(frame=frame, models=models, frame_g=frame_g, surfaces=surfaces)


def _bbox(mask: np.ndarray):
    """``(y0, x0, h, w)`` of a mask's True pixels."""
    ys, xs = np.nonzero(mask)
    return int(ys.min()), int(xs.min()), int(ys.max() - ys.min() + 1), int(xs.max() - xs.min() + 1)


def face_patches(frame, N, rng):
    """Depth patches of a frame for the forest: positives centred on sphere
    pixels, negatives on other valid pixels, every patch inside the image."""
    p = N["face"]["patch"]
    h = p // 2
    depth, part = frame["depth"], frame["part"]
    H, W = depth.shape
    inner = np.zeros((H, W), bool)
    inner[h:H - h, h:W - h] = True

    def take(mask, n):
        ys, xs = np.nonzero(mask & inner)
        pick = rng.choice(len(ys), size=min(n, len(ys)), replace=False)
        return [depth[y - h:y - h + p, x - h:x - h + p].copy() for y, x in zip(ys[pick], xs[pick])]

    return take(part == 4, N["face"]["n_pos"]), take((part != 4) & frame["valid"],
                                                     N["face"]["n_neg"])


def n_voxels(pts: np.ndarray, N, dev):
    """1 cm voxels (B2) of host points, with k-NN normals (k = 16)."""
    from pcl_tpu_torch import features, filters
    from pcl_tpu_torch.core.cloud import make_cloud

    c = make_cloud(pts, device=dev)
    vox = live_rows(filters.voxel_downsample(c, N["leaf"]))
    return features.estimate_normals(vox, k=N["normal_k"])


def _correspondences(model, scene, N, dev):
    """PCL's correspondence_grouping.cpp front end: model keypoints are every
    model voxel, scene keypoints ``uniform_sample``; SHOT at the keypoints on
    the voxels; each scene keypoint's nearest model descriptor, kept under
    the squared-distance cut; BOARD frames. Returns the valid correspondences
    only (host arrays): model and scene points, frames, and the model's
    centroid."""
    from pcl_tpu_torch import features, filters
    from pcl_tpu_torch.registration.ia import feature_knn

    skp = live_rows(filters.uniform_sample(scene, N["key_leaf"]))
    md = features.estimate_shot(model, N["shot_radius"], surface=model)
    sd = features.estimate_shot(skp, N["shot_radius"], surface=scene)
    nn = feature_knn(sd, skp.mask, md, model.mask, 1)[:, 0].long()
    d2 = torch.sum((sd - md[nn]) ** 2, dim=1)
    ok = skp.mask & (d2 < N["match_d2"]) & (torch.sum(sd, dim=1) > 0)
    mrf, mok = features.board_lrf(model, N["rf_radius"], surface=model)
    srf, sok = features.board_lrf(skp, N["rf_radius"], surface=scene)
    ok = ok & sok & mok[nn]
    keep = torch.nonzero(ok)[:, 0]
    mi = nn[keep]
    return dict(model_pts=model.xyz[mi].cpu().numpy(), scene_pts=skp.xyz[keep].cpu().numpy(),
                model_rf=mrf[mi].cpu().numpy(), scene_rf=srf[keep].cpu().numpy(),
                centroid=model.xyz[model.mask].mean(0).cpu().numpy(),
                n_keypoints=int(skp.mask.sum()))


def path_n_front(inp, N, dev, run=None):
    """Path N's front end on the port: the scene's and each model's voxels
    with normals, and the SHOT correspondences of the box and of the
    cylinder (host arrays)."""
    run = run or (lambda name, fn: fn())
    frame = inp["frame"]
    scene = run("voxels + normals (scene)", lambda: n_voxels(
        frame["xyz"].reshape(-1, 3)[frame["valid"].reshape(-1)], N, dev))
    models = {i: run(f"voxels + normals ({N_OBJECTS[i]})",
                     lambda i=i: n_voxels(inp["models"][i]["xyz"], N, dev)) for i in N_OBJECTS}
    cor = {i: run(f"SHOT correspondences ({N_OBJECTS[i]})",
                  lambda i=i: _correspondences(models[i], scene, N, dev)) for i in (3, 5)}
    return dict(scene=scene, models=models, cor=cor)


def hv_subsample(xyz: np.ndarray, N) -> np.ndarray:
    """The verifiers' model: ``N["hv_points"]`` rows of ``xyz`` evenly
    spaced by index."""
    return xyz[np.linspace(0, len(xyz) - 1, min(N["hv_points"], len(xyz))).astype(np.int64)]


def wrong_hypotheses(inp, N):
    """(b)'s wrong poses of the box model: its true pose moved to the
    sphere's and the cylinder's centres, and slid along the floor."""
    frame = inp["frame"]
    true = np.linalg.inv(frame["pose"]) @ inp["models"][3]["pose"]
    box_c = to_camera(L_CENTERS[3], frame["pose"])
    out = []
    for where, p in (("at the sphere", L_CENTERS[4]), ("at the cylinder", L_CENTERS[5]),
                     (f"slid {N['wrong_shift']} m", np.add(L_CENTERS[3], (N["wrong_shift"], 0, 0)))):
        W = true.copy()
        W[:3, 3] += to_camera(p, frame["pose"]) - box_c
        out.append((f"wrong: {where}", W.astype(np.float32)))
    return out


def path_n_chain(inp, N, dev, gen_dev=None, draws=None, on_stage=None, front=None):
    """Path N's main path on the port, on ``dev``: the front end (voxels,
    normals, SHOT correspondences), then (a) correspondence grouping, (b)
    hypothesis verification, (c) ObjRecRANSAC, (d) LINEMOD, (e) the global
    pipeline, (f) ISM, (g) the depth-patch forest. Random draws come from
    generators seeded per step on ``gen_dev`` (default ``dev``; a CPU
    generator draws the same on either device), or from ``draws`` (the JAX
    package's, keyed by step). ``front`` is :func:`path_n_front`'s result
    when it has run already. Returns ``(out, seconds)``."""
    from pcl_tpu_torch import features
    from pcl_tpu_torch import recognition as rec
    from pcl_tpu_torch.core.cloud import make_cloud
    from pcl_tpu_torch.recognition import face_detection, grouping, ism, linemod, orr
    from pcl_tpu_torch.recognition import verification

    draws = draws or {}
    gen_dev = torch.device(dev if gen_dev is None else gen_dev)
    out, secs = {}, {}
    part = ["(front)"]

    def gen(seed):
        g = torch.Generator(device=gen_dev)
        g.manual_seed(seed)
        return g

    def run(name, fn):
        if on_stage is not None:
            on_stage(name)
        t0 = _stamp(dev)
        r = fn()
        secs[f"{part[0]} {name}"] = _stamp(dev) - t0
        return r

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    frame = inp["frame"]
    if front is None:
        front = path_n_front(inp, N, dev, run)
    scene, models = front["scene"], front["models"]
    out["scene_xyz"], out["scene_normal"] = (scene.xyz.cpu().numpy(),
                                             scene.attrs["normal"].cpu().numpy())
    out["models"] = {i: (m.xyz.cpu().numpy(), m.attrs["normal"].cpu().numpy())
                     for i, m in models.items()}

    # (a) correspondence grouping, the box and then the cylinder as the model
    part[0] = "(a)"
    out["groups"] = {}
    for i in (3, 5):
        name = N_OBJECTS[i]
        cor = front["cor"][i]
        mp, sp, ok = t(cor["model_pts"]), t(cor["scene_pts"]), t(np.ones(len(cor["model_pts"]),
                                                                          bool))
        res = {}
        res["gc"] = run(f"geometric_consistency_grouping ({name})",
                        lambda: rec.geometric_consistency_grouping(
                            mp, sp, ok, gc_size=N["cg_size"], min_cluster_size=N["cg_thresh"],
                            max_instances=N["max_instances"]))
        res["hough"] = run(f"hough3d_grouping ({name})", lambda: rec.hough3d_grouping(
            mp, sp, ok, t(cor["centroid"]), bin_size=N["hough_bin"],
            threshold=N["hough_thresh"], max_instances=N["max_instances"],
            model_rf=t(cor["model_rf"]), scene_rf=t(cor["scene_rf"]), use_interpolation=True))
        for k in ("gc", "hough"):
            key = f"sac {k} {name}"
            smp = draws.get(key)
            if smp is None:
                smp = grouping.draw_grouping_samples(res[k], N["sac_hypotheses"], gen(7))
            res[k + "_sac"] = run(f"refine_grouping_sac ({k}, {name})",
                                  lambda k=k, smp=smp: grouping.refine_grouping_sac_core(
                                      mp, sp, res[k], N["sac_threshold"],
                                      [None if s is None else s.to(dev) for s in smp]))
        out["groups"][i] = dict(
            cor=cor, **{k: tuple(x.cpu().numpy() for x in v) for k, v in res.items()})

    # (c) ObjRecRANSAC of the box, refined by trimmed ICP inside
    part[0] = "(c)"
    box = models[3]
    orr_kw = dict(N["orr"])
    o_draws = draws.get("orr")
    if o_draws is None:
        o_draws = run("draw_orr_samples", lambda: orr.draw_orr_samples(
            scene, box, orr_kw["pair_dist"], orr_kw.get("dist_tol", 0.05),
            orr_kw["n_hypotheses"], gen(3)))
    out["orr"] = run("obj_rec_ransac (box)", lambda: rec.obj_rec_ransac(
        box, scene, draws=[d.to(dev) for d in o_draws], **orr_kw))
    h_draws = draws.get("hash")
    if h_draws is None:
        h_draws = orr.draw_oriented_point_pairs(box, orr_kw["pair_dist"], N["hash_pairs"],
                                                orr_kw.get("dist_tol", 0.05), gen(4))
    out["hash"] = run("pair_feature_hash_table (box)", lambda: rec.pair_feature_hash_table(
        box, orr_kw["pair_dist"], N["hash_pairs"], orr_kw.get("dist_tol", 0.05),
        N["hash_bins"], draws=[d.to(dev) for d in h_draws]))

    # (b) verification of the box's hypotheses on a model subsample
    part[0] = "(b)"
    sub = t(hv_subsample(out["models"][3][0], N))
    hyps, names = [], []
    for k in ("gc_sac", "hough_sac"):
        inst, _, Ts = out["groups"][3][k]
        for j in np.nonzero(inst)[0]:
            r = run(f"trimmed_icp ({k} {j})", lambda T=Ts[j]: orr.trimmed_icp(
                box, scene, init=t(T), **N["tricp"]))
            hyps.append(r.transform.cpu().numpy())
            names.append(f"{k} {j}")
    hyps.append(out["orr"][0])
    names.append("orr")
    for name, W in wrong_hypotheses(inp, N):
        hyps.append(W)
        names.append(name)
    Ts = t(np.stack(hyps).astype(np.float32))
    ok = torch.ones(len(hyps), dtype=torch.bool, device=dev)
    out["hyp_T"], out["hyp_names"] = np.stack(hyps), names
    out["hv"] = {}
    for vname, fn, kw in (("greedy", verification.greedy_hypothesis_verification, N["hv"]),
                          ("global", verification.global_hypothesis_verification,
                           dict(N["hv"], **N["hv_global"])),
                          ("papazov", verification.papazov_hypothesis_verification, N["hv"])):
        out["hv"][vname] = run(f"{vname} verification", lambda fn=fn, kw=kw: fn(
            sub, Ts, ok, scene.xyz, scene.mask, **kw)).cpu().numpy()

    # (d) LINEMOD: a template of frame 0's box region, detected in frame N_FRAME_G
    part[0] = "(d)"
    fg = inp["frame_g"]
    region = _bbox(frame["part"] == 3)
    q0 = run("build_modality_maps (frame 0)", lambda: linemod.build_modality_maps(
        t(frame["rgb"] * 255.0), t(frame["xyz"]), t(frame["valid"])))
    tmpl = run("extract_template", lambda: linemod.extract_template(
        q0, region, n_features=N["lm_features"]))
    out["lm_template"] = tmpl
    out["lm"] = run("line_rgbd_detect (frame g)", lambda: linemod.line_rgbd_detect(
        t(fg["rgb"] * 255.0), t(fg["xyz"]), t(fg["valid"]), [tmpl],
        threshold=N["lm_threshold"]))
    bm = t(frame["part"] == 3)
    out["dmap"] = run("distance_map (box mask)", lambda: orr.distance_map(bm)).cpu().numpy()
    out["eroded"] = run("mask_erode (box mask)", lambda: orr.mask_erode(bm)).cpu().numpy()

    # (e) the global pipeline on the objects' surfaces and the scene's voxels
    part[0] = "(e)"
    db = run("train_global_database (VFH)", lambda: rec.train_global_database(
        inp["surfaces"], "vfh", n_views=N["gp_views"], device=dev))
    clusters = run("segment_scene_clusters", lambda: rec.segment_scene_clusters(
        scene, gen=gen(0), samples=draws.get("plane"), **N["seg"]))
    out["gp_clusters"] = clusters
    out["gp_vfh"] = run("recognize_clusters (VFH)", lambda: rec.recognize_clusters(
        db, clusters, device=dev, **N["gp_recognize"]))
    out["gp_db_views"] = db.views
    eg = gen(5)
    edb = run("train_global_database (ESF)", lambda: rec.train_global_database(
        inp["surfaces"], "esf", n_views=N["gp_views"], device=dev, gen=eg))
    out["gp_esf"] = run("recognize_clusters (ESF)", lambda: rec.recognize_clusters(
        edb, clusters, device=dev, gen=eg, **N["gp_recognize"]))
    out["gp_esf_views"] = edb.views

    # (f) ISM on the three models, votes for the box in the scene
    part[0] = "(f)"

    def fpfh(pts, nrm):
        c = make_cloud(pts, attrs={"normal": nrm}, device=dev)
        return features.estimate_fpfh(c, k=min(N["fpfh_k"], len(pts) - 1))

    mlist = [out["models"][i] for i in N_OBJECTS]
    model = run("train_ism", lambda: ism.train_ism(
        [m[0] for m in mlist], [m[1] for m in mlist], [0, 1, 2], fpfh,
        sampling_size=N["ism_sampling"], n_clusters=N["ism_clusters"], device=dev,
        init_indices=draws.get("ism"), gen=gen(6)))
    out["ism_model"] = model
    votes = run("find_objects (box)", lambda: ism.find_objects(
        model, out["scene_xyz"], out["scene_normal"], 0, fpfh,
        sampling_size=N["ism_sampling"], device=dev))
    sigma = float(model.sigmas[0])
    out["ism_peaks"] = run("find_strongest_peaks", lambda: ism.find_strongest_peaks(
        votes[0], votes[1], 0, 10.0 * sigma, sigma))
    out["ism_votes"] = len(votes[0])

    # (g) the depth-patch forest: trained on frame 0, run on frame N_FRAME_G
    part[0] = "(g)"
    pos, neg = face_patches(frame, N, np.random.default_rng(13))
    det = run("train_face_detector", lambda: face_detection.train_face_detector(
        pos, neg, patch=N["face"]["patch"]))
    out["faces"] = run("detect_faces (frame g)", lambda: face_detection.detect_faces(
        det, fg["depth"], stride=N["face"]["stride"], threshold=N["face"]["threshold"]))
    return out, secs


def _surface_median(pts_cam: np.ndarray, pose: np.ndarray, i: int) -> float:
    """Median distance of camera-frame points to object ``i``'s surface."""
    if len(pts_cam) == 0:
        return math.inf
    return float(np.median(room_parts(to_world(pts_cam, pose))[i]))


def _moved(T, pts):
    T = np.asarray(T, np.float64)
    return np.asarray(pts, np.float64) @ T[:3, :3].T + T[:3, 3]


def path_n_metrics(inp, out, N) -> dict:
    """Path N's measures from host arrays: each grouper's best instance on its
    object, the verifiers' decisions, ObjRecRANSAC's pose, LINEMOD's IoU,
    the global pipeline's labels and poses, ISM's peak and the forest's
    detection."""
    frame, fg = inp["frame"], inp["frame_g"]
    pose = frame["pose"]
    m = {}
    for i, g in out["groups"].items():
        mxyz = out["models"][i][0]
        for k in ("gc", "hough", "gc_sac", "hough_sac"):
            inst, mem, Ts = g[k]
            errs = [_surface_median(_moved(Ts[j], mxyz), pose, i) for j in np.nonzero(inst)[0]]
            m[f"{k} {N_OBJECTS[i]}"] = (min(errs) if errs else math.inf, int(inst.sum()),
                                        [int(x) for x in mem.sum(1)])
        m[f"correspondences {N_OBJECTS[i]}"] = (len(g["cor"]["model_pts"]),
                                                g["cor"]["n_keypoints"])
    bxyz = out["models"][3][0]
    m["orr"] = (_surface_median(_moved(out["orr"][0], bxyz), pose, 3), out["orr"][1])
    m["hash_pairs"] = out["hash"][1]
    m["hyp_err"] = {n: _surface_median(_moved(T, bxyz), pose, 3)
                    for n, T in zip(out["hyp_names"], out["hyp_T"])}
    m["hv"] = {k: [bool(x) for x in v] for k, v in out["hv"].items()}
    tm = out["lm_template"]
    box_g = _bbox(fg["part"] == 3)
    if out["lm"]:
        d = out["lm"][0]
        a = np.zeros(fg["part"].shape, bool)
        a[d.y:d.y + tm.height, d.x:d.x + tm.width] = True
        b = np.zeros_like(a)
        b[box_g[0]:box_g[0] + box_g[2], box_g[1]:box_g[1] + box_g[3]] = True
        m["lm"] = (_iou(a, b), d.score, len(out["lm"]))
    else:
        m["lm"] = (0.0, 0.0, 0)
    m["dmap_max"] = float(out["dmap"].max())
    m["eroded"] = int(out["eroded"].sum())
    for key, views in (("gp_vfh", out["gp_db_views"]), ("gp_esf", out.get("gp_esf_views"))):
        if views is None:
            continue
        rows = []
        for cl, r in zip(out["gp_clusters"], out[key]):
            obj = int(np.bincount(np.argmin(room_parts(to_world(cl, pose)), 0),
                                  minlength=6).argmax())
            if r is None:
                rows.append((L_NAMES[obj], len(cl), None, math.inf))
                continue
            err = _surface_median(_moved(r.transform, views[r.view_index]), pose, obj) \
                if obj in N_OBJECTS else math.inf
            rows.append((L_NAMES[obj], len(cl), r.label, err))
        m[key] = rows
    centre = to_camera(L_CENTERS[3], pose)
    m["ism"] = (float(np.linalg.norm(out["ism_peaks"][0][0] - centre))
                if out["ism_peaks"] else math.inf, len(out["ism_peaks"]), out["ism_votes"])
    if out["faces"]:
        f = out["faces"][0]
        h = f.size // 2
        ys, xs = np.nonzero(fg["part"] == 4)
        m["face"] = (float(np.sqrt(((ys - (f.y + h)) ** 2 + (xs - (f.x + h)) ** 2).min())),
                     f.score, len(out["faces"]))
    else:
        m["face"] = (math.inf, 0.0, 0)
    return m


N_CPU_VOXELS = 2048       # card against CPU: this many scene voxels about the box
N_PLAIN_ROWS = 1 << 18    # B1's plain version on the first rows of a large call
N_ON_OBJECT = 0.075        # m: "on its object", a quarter of the objects' least width (0.3 m)
# limits: 1.5 x the JAX package's CPU rehearsal at full width (tests/rehearse_path_n.py jax
# on the port's CPU front end; the card takes its SAC and ObjRecRANSAC draws): the
# best instance's median distance to its object (m) gc box 0.048919, gc_sac box 0.0039528,
# gc cylinder 0.072680, hough cylinder 0.050655, gc_sac cylinder 0.0051987, hough_sac
# cylinder 0.0057140 (SAC on its draws, tests/path_n_draws.npz); ObjRecRANSAC 0.0066503
# (support 0.9396); the VFH view on the sphere's
# cluster 0.020878; the forest's detection 0 px from the sphere. None: the rehearsal does not
# meet the check (Hough on the box: 0.878 / 0.181 m; global verification accepts the box at
# the sphere's centre; Papazov accepts nothing; LINEMOD's best window misses the box; the
# global pipeline's labels; ISM's peak 0.946 m off), so it is printed (ROADMAP C80)
N_LIMITS = dict(
    groups={"gc box": 0.0734, "gc_sac box": 0.00593, "gc cylinder": 0.109,
            "hough cylinder": 0.0760, "gc_sac cylinder": 0.00780, "hough_sac cylinder": 0.00858,
            "hough box": None, "hough_sac box": None},
    orr=0.00998,
    hv={"greedy": {"orr": True, "wrong: at the sphere": False, "wrong: at the cylinder": False,
                   "wrong: slid 0.3 m": False},
        "global": {"orr": True, "wrong: at the sphere": None, "wrong: at the cylinder": False,
                   "wrong: slid 0.3 m": False},
        "papazov": {"orr": None, "wrong: at the sphere": False, "wrong: at the cylinder": False,
                    "wrong: slid 0.3 m": False}},
    lm=None, gp_labels={}, gp_err={"gp_vfh sphere": 0.0314}, ism=None, face=0.0)
N_DRAWS = "tests/path_n_draws.npz"      # the rehearsal's draws (tests/rehearse_path_n.py draws)


def _front_on(front, dev):
    """``path_n_front``'s result moved to ``dev`` (the same host arrays)."""
    from pcl_tpu_torch.core.cloud import make_cloud

    def move(c):
        return make_cloud(c.xyz.cpu().numpy(), attrs={"normal": c.attrs["normal"].cpu().numpy()},
                          device=dev)
    return dict(scene=move(front["scene"]), models={i: move(m) for i, m in front["models"].items()},
                cor=front["cor"])


def n_card_vs_cpu(inp_small, full_out, expect, card=None):
    """The slice's functions on the card against the port's CPU run: path N's
    chain at 80 x 60 on the CPU's front end with the same CPU-drawn samples,
    and the groupers, trimmed ICP and the verifiers on the ``N_CPU_VOXELS``
    scene voxels nearest the box with the box's correspondences among them.
    Returns lines to print."""
    from pcl_tpu_torch import recognition as rec
    from pcl_tpu_torch.core.cloud import make_cloud
    from pcl_tpu_torch.recognition import orr, verification

    lines = []
    cpu = torch.device("cpu")
    card = torch.device("cuda") if card is None else card
    N = N_SMALL
    front = path_n_front(inp_small, N, cpu)
    a, b = (path_n_chain(inp_small, N, d, gen_dev="cpu", front=_front_on(front, d))[0]
            for d in (card, cpu))
    same = all(np.array_equal(x, y) for i in (3, 5) for k in ("gc", "hough", "gc_sac", "hough_sac")
               for x, y in zip(a["groups"][i][k][:2], b["groups"][i][k][:2]))
    tgap = max(float(np.abs(a["groups"][i][k][2] - b["groups"][i][k][2]).max())
               for i in (3, 5) for k in ("gc", "hough", "gc_sac", "hough_sac"))
    expect(same and tgap <= 1e-5, f"(card vs CPU) grouping differs: members equal {same}, "
                                  f"transforms by {tgap}")
    hgap = float(np.abs(a["hyp_T"] - b["hyp_T"]).max())
    hv_same = all(np.array_equal(a["hv"][k], b["hv"][k]) for k in a["hv"])
    expect(hgap <= 1e-4 and hv_same, f"(card vs CPU) trimmed ICP by {hgap} m or the verifiers' "
                                     f"decisions ({hv_same})")
    ogap = float(np.abs(a["orr"][0] - b["orr"][0]).max())
    expect(ogap <= 1e-3 and abs(a["orr"][1] - b["orr"][1]) <= 2.0 / len(a["models"][3][0])
           and a["hash"][1] == b["hash"][1],
           f"(card vs CPU) ObjRecRANSAC differs: pose by {ogap}, support {a['orr'][1]} against "
           f"{b['orr'][1]}")
    lm_same = [(d.y, d.x, d.score) for d in a["lm"]] == [(d.y, d.x, d.score) for d in b["lm"]]
    expect(lm_same and np.array_equal(a["dmap"], b["dmap"])
           and np.array_equal(a["eroded"], b["eroded"]), "(card vs CPU) LINEMOD or the maps differ")
    gp_same = len(a["gp_clusters"]) == len(b["gp_clusters"]) and all(
        np.array_equal(np.sort(x, 0), np.sort(y, 0)) for x, y in zip(a["gp_clusters"],
                                                                     b["gp_clusters"]))
    labels = ([r and r.label for r in a["gp_vfh"]], [r and r.label for r in b["gp_vfh"]])
    expect(gp_same and labels[0] == labels[1], f"(card vs CPU) the global pipeline differs: "
                                               f"clusters equal {gp_same}, labels {labels}")
    ism_gap = float(np.linalg.norm(a["ism_peaks"][0][0] - b["ism_peaks"][0][0])) \
        if a["ism_peaks"] and b["ism_peaks"] else math.inf
    expect(ism_gap <= N["ism_sampling"] and a["faces"] == b["faces"],
           f"(card vs CPU) ISM's peak moved {ism_gap} m or the forest's detections differ")
    lines.append(f"80 x 60 chain: groupers equal {same} (transforms {tgap:.1e}), trimmed ICP "
                 f"{hgap:.1e} m, verifiers equal {hv_same}, ObjRecRANSAC {ogap:.1e}, LINEMOD "
                 f"equal {lm_same}, clusters equal {gp_same}, labels {labels[0]}, ISM peak "
                 f"{ism_gap:.2e} m, detections equal {a['faces'] == b['faces']}")
    # the full-width scene's voxels about the box
    sx = full_out["scene_xyz"]
    centre = to_camera(L_CENTERS[3], handheld(np.random.default_rng(G_SEED), 1)[0])
    dist = np.linalg.norm(sx - centre, axis=1)
    near = np.argsort(dist, kind="stable")[:N_CPU_VOXELS]
    cor = full_out["groups"][3]["cor"]
    inside = np.linalg.norm(cor["scene_pts"] - centre, axis=1) <= dist[near[-1]]
    out = {}
    for d in (card, cpu):
        def t(x):
            return torch.as_tensor(np.asarray(x), device=d)
        mp, sp = t(cor["model_pts"][inside]), t(cor["scene_pts"][inside])
        ok = torch.ones(len(mp), dtype=torch.bool, device=d)
        gc = rec.geometric_consistency_grouping(mp, sp, ok, gc_size=N_FULL["cg_size"],
                                                min_cluster_size=N_FULL["cg_thresh"])
        hg = rec.hough3d_grouping(mp, sp, ok, t(cor["centroid"]), bin_size=N_FULL["hough_bin"],
                                  threshold=N_FULL["hough_thresh"],
                                  model_rf=t(cor["model_rf"][inside]),
                                  scene_rf=t(cor["scene_rf"][inside]))
        scene = make_cloud(sx[near], device=d)
        box = make_cloud(full_out["models"][3][0], device=d)
        # two iterations: longer runs part by the trimmed set's ties (as path H's (f))
        T = orr.trimmed_icp(box, scene, init=t(full_out["orr"][0]),
                            trim_fraction=N_FULL["tricp"]["trim_fraction"],
                            max_iterations=2).transform
        sub = box.xyz[:: max(1, len(box.xyz) // 512)]
        Ts = t(full_out["hyp_T"].astype(np.float32))
        okh = torch.ones(len(Ts), dtype=torch.bool, device=d)
        hv = [fn(sub, Ts, okh, scene.xyz, scene.mask, **N_FULL["hv"]).cpu().numpy()
              for fn in (verification.greedy_hypothesis_verification,
                         verification.global_hypothesis_verification,
                         verification.papazov_hypothesis_verification)]
        out[d.type] = ([x.cpu().numpy() for x in gc], [x.cpu().numpy() for x in hg],
                       T.cpu().numpy(), hv)
    (ga, ha, Ta, va), (gb, hb, Tb, vb) = out[card.type], out["cpu"]
    same = all(np.array_equal(x, y) for x, y in zip(ga[:2] + ha[:2], gb[:2] + hb[:2]))
    tg = max(float(np.abs(ga[2] - gb[2]).max()), float(np.abs(ha[2] - hb[2]).max()))
    icp_gap = float(np.abs(Ta - Tb).max())
    hv_same = all(np.array_equal(x, y) for x, y in zip(va, vb))
    expect(same and tg <= 1e-5 and icp_gap <= 1e-4 and hv_same,
           f"(card vs CPU) on {N_CPU_VOXELS} voxels: groupers equal {same} ({tg}), trimmed ICP "
           f"{icp_gap}, verifiers equal {hv_same}")
    lines.append(f"{N_CPU_VOXELS} voxels about the box ({int(inside.sum())} correspondences): "
                 f"groupers equal {same} (transforms {tg:.1e}), trimmed ICP (two iterations) "
                 f"{icp_gap:.1e} m, "
                 f"verifiers equal {hv_same}")
    return lines


def n_checks(m, lim, expect):
    """Path N's checks against ``N_LIMITS`` (1.5 x the rehearsal); a check
    the rehearsal did not meet is printed, not made (``lim`` holds None)."""
    printed = []

    def hold(cond, limit, what):
        if limit is None:
            printed.append(what)
        else:
            expect(cond, what)

    for k, L in lim["groups"].items():
        v = m[k][0]
        hold(L is not None and v <= L, L, f"(a) {k}: the best instance lies {v:.5f} m from its "
                                          f"object (limit {L}; on it: within {N_ON_OBJECT} m)")
    hold(lim["orr"] is not None and m["orr"][0] <= lim["orr"], lim["orr"],
         f"(c) ObjRecRANSAC's refined pose lies {m['orr'][0]:.5f} m from the box (limit "
         f"{lim['orr']})")
    names = list(m["hyp_err"])
    for v, accept in m["hv"].items():
        for name, want in lim["hv"][v].items():
            a = accept[names.index(name)]
            hold(a == want, want, f"(b) {v} verification {'accepts' if a else 'rejects'} "
                                  f"{name}" + ("" if want is None else
                                               f" (the rehearsal {'accepts' if want else 'rejects'})"))
    hold(m["lm"][0] >= 0.5, lim["lm"], f"(d) LINEMOD's best window has IoU {m['lm'][0]:.3f} "
                                       f"with the box in frame {N_FRAME_G}")
    for key in ("gp_vfh", "gp_esf"):
        owners = [row[0] for row in m.get(key, [])]
        for obj in N_OBJECTS.values():
            if obj not in owners:
                hold(False, None, f"(e) {key}: no cluster is the {obj}'s (plane removal and "
                                  f"clusters at the pipeline's settings)")
        for obj, size, label, err in m.get(key, []):
            if obj in N_OBJECTS.values():
                hold(label == obj, lim["gp_labels"].get(f"{key} {obj}"),
                     f"(e) {key} labels the {obj}'s cluster ({size} points) {label}")
                L = lim["gp_err"].get(f"{key} {obj}")
                hold(L is not None and err <= L, L, f"(e) {key}'s refined view of the {obj} lies "
                                                     f"{err:.5f} m from it (limit {L})")
    hold(lim["ism"] is not None and m["ism"][0] <= lim["ism"], lim["ism"],
         f"(f) ISM's strongest peak lies {m['ism'][0]:.4f} m from the box's centre (limit "
         f"{lim['ism']})")
    hold(lim["face"] is not None and m["face"][0] <= lim["face"], lim["face"],
         f"(g) the forest's best detection lies {m['face'][0]:.1f} px from the sphere "
         f"(limit {lim['face']})")
    return printed


def phase16_path_n(segsum, nn1_mod, record_b1, record_b2):
    """Path N: PCL's recognition tutorials on path L's room, frame 0 at VGA
    and 1 cm voxels."""
    from pcl_tpu_torch.search import bruteforce

    failed = []

    def expect(cond: bool, what: str) -> None:
        if not cond:
            print(f"phase 16: CHECK FAILED: {what}", flush=True)
            failed.append(what)

    dev = torch.device("cuda")
    inp, isecs = timed(lambda: path_n_inputs(N_FULL))
    print(f"phase 16: inputs in {isecs:.1f} s: frame 0 {int(inp['frame']['valid'].sum())} valid "
          f"pixels, models " + ", ".join(f"{N_OBJECTS[i]} {len(m['xyz'])} pixels"
                                          for i, m in inp["models"].items())
          + f", frame {N_FRAME_G} {int(inp['frame_g']['valid'].sum())} valid pixels", flush=True)
    small = path_n_inputs(N_SMALL)
    _, wsecs = timed(lambda: path_n_chain(small, N_SMALL, dev))
    print(f"phase 16: warm-up at 80 x 60 in {wsecs:.1f} s", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trace.reset()
    z = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), N_DRAWS))
    draws = {"orr": [torch.from_numpy(z[k].astype(np.int64)) for k in ("i1", "i2", "mp1")]}
    for k in ("gc", "hough"):
        for name in ("box", "cylinder"):
            key = f"sac {k} {name}"
            draws[key] = [torch.from_numpy(z[f"{key} {j}"].astype(np.int64))
                          if f"{key} {j}" in z else None for j in range(N_FULL["max_instances"])]
    with kernel_calls(bruteforce, segsum) as calls:
        (out, secs), total = timed(lambda: path_n_chain(
            inp, N_FULL, dev, draws=draws, on_stage=lambda n: calls.__setitem__("stage", n)))
    expect(len(out["scene_xyz"]) == int(z["n_scene"])
           and len(out["models"][3][0]) == int(z["n_model"]),
           f"the rehearsal's draws index {int(z['n_scene'])} scene and "
           f"{int(z['n_model'])} box voxels, the card has {len(out['scene_xyz'])} and "
           f"{len(out['models'][3][0])}")
    b1, b2 = launch_count("nn1"), launch_count("segsum")
    record_b1["launches_by_path"]["N"] = b1
    record_b2["launches_by_path"]["N"] = b2
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    card = card_line()
    print(f"phase 16: path N in {total:.1f} s on {len(out['scene_xyz'])} scene voxels, peak "
          f"memory {peak:.2f} GiB, launches nn1 {b1}, segsum {b2} [{card}]", flush=True)
    for name, v in secs.items():
        print(f"phase 16: {name}: {v * 1e3:.1f} ms [{card}]", flush=True)
    parts = {p: sum(v for k, v in secs.items() if k.startswith(p))
             for p in ("(front)", "(a)", "(b)", "(c)", "(d)", "(e)", "(f)", "(g)")}
    print("phase 16: by part " + ", ".join(f"{p} {v:.2f} s" for p, v in parts.items())
          + f" [{card}]", flush=True)
    expect(b2 == 1 + len(N_OBJECTS) and b1 >= 5,
           f"path N launched B2 {b2} times (the scene's and the models' voxel grids: 4) and B1 "
           f"{b1} times (the verifiers, trimmed ICP, ObjRecRANSAC, ICP, ESF: at least 5)")
    expect(len(calls["nn1"]) == b1 and len(calls["segsum"]) == b2,
           "the kept kernel calls do not match the launch counts")
    m = path_n_metrics(inp, out, N_FULL)
    print("phase 16: metrics " + json.dumps(m, default=float), flush=True)
    print(f"phase 16: (e) clusters " + ", ".join(
        f"{o} ({n} points): VFH {lv}, ESF {le}" for (o, n, lv, _), (_, _, le, _)
        in zip(m["gp_vfh"], m["gp_esf"])), flush=True)
    for what in n_checks(m, N_LIMITS, expect):
        print(f"phase 16: printed, not checked (the reference does not meet it): {what}",
              flush=True)
    lines, csecs = timed(lambda: n_card_vs_cpu(small, out, expect))
    print(f"phase 16: card against CPU ({csecs:.1f} s): " + "; ".join(lines), flush=True)
    rows1, rows2 = hold_to_plain(calls, nn1_mod, segsum, expect, "phase 16:", N_PLAIN_ROWS, card,
                                 time_once=True)
    record_b1["path_n"] = rows1
    record_b2["path_n"] = rows2
    check(not failed, "path N: " + "; ".join(failed))
    return {"total_s": total, "peak_gib": peak, "parts": parts}


# ---------------------------------------------------------------------------
# path O: PCL's people-detection, dense-CRF and tracking tutorials on an
# RGB-D sequence of a room with two people walking
# ---------------------------------------------------------------------------

O_SEED = 13                 # the sequence's range noise, dropped pixels and colour noise
O_TRAIN_SEED = 14           # the classifier's training renders
O_HZ = 30.0
O_FLOOR_Y = 1.2             # m: the camera above the floor (world y points down)
O_PITCH = 10.0              # deg the camera looks down
O_FAR = 8.0                 # m: the sensor's range
# the room, 6 m wide and 7 m deep, walls 3 m tall: planes (axis, position, bounds of
# the other two axes in axis order, class)
O_PLANES = ((1, O_FLOOR_Y, ((-3.0, 3.0), (0.0, 7.0)), 0),                  # floor
            (2, 7.0, ((-3.0, 3.0), (O_FLOOR_Y - 3.0, O_FLOOR_Y)), 1),     # back wall
            (0, -3.0, ((O_FLOOR_Y - 3.0, O_FLOOR_Y), (0.0, 7.0)), 1),     # left wall
            (0, 3.0, ((O_FLOOR_Y - 3.0, O_FLOOR_Y), (0.0, 7.0)), 1))      # right wall
# posters: (wall plane index, (a0, a1), (y0, y1)) with a the wall's horizontal axis
O_POSTERS = ((1, (-2.2, -1.2), (-0.8, 0.4)), (1, (0.4, 1.4), (-0.9, 0.1)),
             (3, (5.0, 6.0), (-0.7, 0.3)))
# path G's box, sphere and cylinder as clutter on the floor, all under 1.3 m
O_BOX = ((-2.3, O_FLOOR_Y - 0.3, 4.6), (-1.9, O_FLOOR_Y, 5.0))
O_SPHERE = ((2.0, O_FLOOR_Y - 0.2, 5.2), 0.2)
O_CYLINDER = ((-1.2, 5.8), 0.15, (O_FLOOR_Y - 0.5, O_FLOOR_Y))
O_CLASSES = ("floor", "walls", "person 1", "person 2", "box", "sphere", "cylinder", "posters")
O_COLOURS = {0: (0.55, 0.5, 0.45), 4: (0.85, 0.15, 0.1), 5: (0.15, 0.7, 0.2),
             6: (0.15, 0.3, 0.85)}
O_BRICKS = ((0.62, 0.3, 0.22), (0.8, 0.6, 0.45))
O_SKIN = (0.85, 0.65, 0.5)
# the people: height, start (x, z), velocity (m/s along x, z), shirt, trousers
O_PEOPLE = (dict(height=1.75, start=(-1.5, 3.0), velocity=(1.0, 0.0),
                 shirt=(0.7, 0.15, 0.15), trousers=(0.15, 0.2, 0.45)),
            dict(height=1.62, start=(0.9, 2.5),
                 velocity=(0.7 / math.sqrt(5.0), 1.4 / math.sqrt(5.0)),
                 shirt=(0.2, 0.55, 0.25), trousers=(0.25, 0.25, 0.3)))
O_LIGHT = np.array([0.3, -1.0, -0.5]) / np.linalg.norm([0.3, -1.0, -0.5])
O_FULL = dict(
    shape=(480, 640), intr=(525.0, 525.0, 319.5, 239.5), frames=30,
    # (a): both figures at 12 views and 2-5 m, four negatives for each positive; the step
    # 1e-3, not svm_train's 0.02, which diverges on HOG features (ROADMAP C83)
    views=12, neg_per_pos=4, svm=dict(C=1.0, iterations=1000, lr=1e-3), rbf_gamma=1.0 / 3024,
    folds=5,
    # (b): PCL's ground_based_rgbd_people_detector defaults
    det_leaf=0.06, det=dict(min_height=1.3, max_height=2.3, cluster_tolerance=0.2,
                            min_points=30, min_confidence=-1.5),
    # (c): crf_segmentation's flow on 2 cm voxels
    crf_leaf=0.02, crf=dict(confidence=0.8, sxyz=0.05, srgb=0.1, iterations=10, flip=0.2,
                            bilateral_bins=12),
    # (d): PCL's tracking_sample.cpp: 1,000 particles at most, 600 at the start,
    # epsilon 0.2, delta 0.99, bin 0.1, step noise the square roots of its covariances;
    # the reference cut out of frame 0 off the ground within 0.4 m of the detection, the
    # scene each frame's whole 2 cm voxel cloud (openni_tracking.cpp tracks on the whole
    # pass-through cloud, z 0-10 m, which holds the whole room)
    track_leaf=0.02, kld=dict(max=1000, init=600, epsilon=0.2, z_delta=2.326, bin_size=0.1),
    pf=600, step_noise=(0.015, 0.015, 0.015, 0.095, 0.095, 0.095), ref_radius=0.4,
    # (e)
    agast=dict(threshold=10.0, keep=500), klt=dict(levels=3, window_radius=4, iterations=10))
# 80 x 60 and two frames for the CPU tests (tests/test_torch_path_o.py) and the card
# against the CPU: lengths grown with the pixels, particle counts and the bilateral grid
# (6^6 cells, not 12^6) cut
O_SMALL = dict(
    O_FULL, shape=(60, 80), intr=(525.0 / 8, 525.0 / 8, (319.5 + 0.5) / 8 - 0.5,
                                  (239.5 + 0.5) / 8 - 0.5),
    frames=2, views=2, det_leaf=0.08, det=dict(O_FULL["det"], min_points=10),
    crf_leaf=0.08, crf=dict(O_FULL["crf"], iterations=2, bilateral_bins=6), track_leaf=0.08,
    kld=dict(O_FULL["kld"], max=96, init=64), pf=64, agast=dict(threshold=10.0, keep=60),
    klt=dict(levels=2, window_radius=3, iterations=5))


def _o_rotation() -> np.ndarray:
    from scipy.spatial.transform import Rotation

    return Rotation.from_euler("x", -O_PITCH, degrees=True).as_matrix()


def o_person_at(k: int, t: float):
    """Person ``k``'s ground position (x, z) at time ``t``."""
    p = O_PEOPLE[k]
    return (p["start"][0] + p["velocity"][0] * t, p["start"][1] + p["velocity"][1] * t)


def o_person_prims(h: float, x: float, z: float, heading, shirt, trousers, pid: int):
    """A person of height ``h`` standing at ``(x, z)`` facing ``heading``: two
    legs (r 0.07 m), a torso (r 0.17 m), two arms, a neck and a head sphere
    (r 0.11 m). Vertical cylinders are ``("vcyl", x, z, r, y_top, y_bottom,
    cap, colour, pid)``; the sphere ``("sphere", centre, r, colour, pid)``."""
    f = O_FLOOR_Y
    hx, hz = heading
    lx, lz = -hz, hx                    # the shoulders' direction
    hip, chest = f - 0.47 * h, f - 0.82 * h
    out = []
    for s in (-1, 1):
        out.append(("vcyl", x + s * 0.09 * lx, z + s * 0.09 * lz, 0.07, hip, f, False,
                    trousers, pid))
        out.append(("vcyl", x + s * 0.23 * lx, z + s * 0.23 * lz, 0.05, f - 0.80 * h,
                    f - 0.42 * h, True, shirt, pid))
    out.append(("vcyl", x, z, 0.17, chest, hip, True, shirt, pid))
    out.append(("vcyl", x, z, 0.05, f - h + 0.2, chest, False, O_SKIN, pid))
    out.append(("sphere", np.array([x, f - h + 0.11, z]), 0.11, O_SKIN, pid))
    return out


def o_prims(t: float, people=True):
    """Path O's scene at time ``t``: the clutter and, with ``people``, both
    people at their places."""
    prims = [("box", np.array(O_BOX[0]), np.array(O_BOX[1]), O_COLOURS[4], 4),
             ("sphere", np.array(O_SPHERE[0]), O_SPHERE[1], O_COLOURS[5], 5),
             ("vcyl", O_CYLINDER[0][0], O_CYLINDER[0][1], O_CYLINDER[1], O_CYLINDER[2][0],
              O_CYLINDER[2][1], True, O_COLOURS[6], 6)]
    if people:
        for k, p in enumerate(O_PEOPLE):
            x, z = o_person_at(k, t)
            v = np.array(p["velocity"])
            prims += o_person_prims(p["height"], x, z, v / np.linalg.norm(v), p["shirt"],
                                    p["trousers"], 2 + k)
    return prims


def o_cast(o: np.ndarray, d: np.ndarray, prims):
    """Nearest hit of rays ``o + t d`` with the room and ``prims``: ``(t,
    unit world normal, hit index)``; index ``-1 - i`` for the room's plane
    ``i``, ``j`` for ``prims[j]``, and ``t`` inf where nothing is hit."""
    shape = d.shape[:-1]
    best = np.full(shape, np.inf)
    nrm = np.zeros(shape + (3,))
    hit = np.full(shape, -1000, np.int64)
    safe = np.where(np.abs(d) > 1e-12, d, 1e-12)

    def take(t, n, idx):
        nonlocal best
        better = (t > 1e-6) & (t < best)
        best = np.where(better, t, best)
        nrm[better] = np.broadcast_to(n, shape + (3,))[better]
        hit[better] = idx

    for i, (axis, at, bounds, _) in enumerate(O_PLANES):
        t = (at - o[axis]) / safe[..., axis]
        p = o + t[..., None] * d
        inside = np.ones(shape, bool)
        for a, (lo, hi) in zip([a for a in range(3) if a != axis], bounds):
            inside &= (p[..., a] >= lo) & (p[..., a] <= hi)
        n = np.zeros(3)
        n[axis] = -np.sign(at - o[axis])
        take(np.where(inside, t, np.inf), n, -1 - i)
    for j, pr in enumerate(prims):
        if pr[0] == "box":
            lo, hi = pr[1], pr[2]
            t0, t1 = (lo - o) / safe, (hi - o) / safe
            tn, tf = np.minimum(t0, t1), np.maximum(t0, t1)
            t_in = tn.max(-1)
            n = -np.sign(safe) * np.eye(3)[np.argmax(tn, -1)]
            take(np.where(t_in < tf.min(-1), t_in, np.inf), n, j)
        elif pr[0] == "sphere":
            c, r = pr[1], pr[2]
            oc = o - c
            b = np.sum(d * oc, -1)
            dd = np.sum(d * d, -1)
            disc = b * b - dd * (oc @ oc - r * r)
            t = (-b - np.sqrt(np.maximum(disc, 0))) / dd
            take(np.where(disc > 0, t, np.inf), (o + t[..., None] * d - c) / r, j)
        else:
            _, cx, cz, r, y0, y1, cap = pr[:7]
            a = d[..., 0] ** 2 + d[..., 2] ** 2
            bb = d[..., 0] * (o[0] - cx) + d[..., 2] * (o[2] - cz)
            cc = (o[0] - cx) ** 2 + (o[2] - cz) ** 2 - r * r
            disc = bb * bb - a * cc
            t = (-bb - np.sqrt(np.maximum(disc, 0))) / np.maximum(a, 1e-12)
            p = o + t[..., None] * d
            side = (disc > 0) & (p[..., 1] >= y0) & (p[..., 1] <= y1)
            n = np.stack([(p[..., 0] - cx) / r, np.zeros(shape), (p[..., 2] - cz) / r], -1)
            take(np.where(side, t, np.inf), n, j)
            if cap:
                t = (y0 - o[1]) / safe[..., 1]
                p = o + t[..., None] * d
                on = (p[..., 0] - cx) ** 2 + (p[..., 2] - cz) ** 2 <= r * r
                take(np.where(on, t, np.inf), np.array([0.0, -1.0, 0.0]), j)
    return best, nrm, hit


def _o_hash(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a * 7919 + b * 104729 + (a * b) % 13) % 5


def o_shade(p: np.ndarray, n: np.ndarray, hit: np.ndarray, prims):
    """``(rgb [..., 3] in [0, 1], class [...])`` of world hits: the floor's
    tiles, the walls' bricks of two colours and the posters' coloured
    blocks, the objects' and people's colours, lit by ``O_LIGHT``."""
    rgb = np.zeros(hit.shape + (3,))
    cls = np.full(hit.shape, -1, np.int64)
    floor = hit == -1
    tile = (np.floor(p[..., 0] / 0.5) + np.floor(p[..., 2] / 0.5)) % 2
    rgb[floor] = (np.array(O_COLOURS[0]) * np.where(tile, 0.93, 1.0)[..., None])[floor]
    cls[floor] = 0
    for i in (1, 2, 3):
        on = hit == -1 - i
        a = p[..., 0] if O_PLANES[i][0] == 2 else p[..., 2]
        row = np.floor((O_FLOOR_Y - p[..., 1]) / 0.075).astype(np.int64)
        col = np.floor((a + 0.125 * (row % 2)) / 0.25).astype(np.int64)
        which = (_o_hash(row, col) == 0)[..., None]
        rgb[on] = np.where(which, O_BRICKS[1], O_BRICKS[0])[on]
        cls[on] = 1
        for wall, (a0, a1), (y0, y1) in O_POSTERS:
            if wall != i:
                continue
            inside = on & (a >= a0) & (a <= a1) & (p[..., 1] >= y0) & (p[..., 1] <= y1)
            bi = np.floor((a - a0) / (a1 - a0) * 3).astype(np.int64)
            bj = np.floor((p[..., 1] - y0) / (y1 - y0) * 4).astype(np.int64)
            palette = np.array([(0.95, 0.9, 0.2), (0.1, 0.1, 0.12), (0.2, 0.6, 0.9),
                                (0.9, 0.3, 0.6), (0.95, 0.95, 0.95)])
            rgb[inside] = palette[_o_hash(bi + 3 * wall, bj)][inside]
            cls[inside] = 7
    for j, pr in enumerate(prims):
        on = hit == j
        rgb[on] = pr[-2]
        cls[on] = pr[-1]
    shade = 0.6 + 0.4 * np.abs(n @ O_LIGHT)
    return np.clip(rgb * shade[..., None], 0, 1), cls


def o_render(t: float, intr, u: np.ndarray, v: np.ndarray, rng=None, people=True, cam=None):
    """The camera's view at pixels ``(u, v)`` (any shape) at time ``t``:
    ``depth`` (range noise 1.5 mm x z^2 and 0.5% of the pixels dropped when
    ``rng`` is given; 0 where invalid), ``rgb`` (colour noise 0.03; the
    colour camera sees every surface, the depth's dropped pixels too), the
    true ``class`` of each pixel's surface (``O_CLASSES``; -1 where nothing
    is hit), the clean camera-frame points ``xyz`` and ``valid`` depth.
    ``cam`` is the camera's ``(rotation, centre)`` in the world (default
    path O's Kinect: ``_o_rotation()`` at the origin)."""
    R, c = (_o_rotation(), np.zeros(3)) if cam is None else cam
    d_cam = np.stack([(u - intr.cx) / intr.fx, (v - intr.cy) / intr.fy, np.ones(u.shape)], -1)
    prims = o_prims(t, people)
    tt, n, hit = o_cast(np.asarray(c, np.float64), d_cam @ R.T, prims)
    seen = np.isfinite(tt)
    rgb, cls = o_shade(c + (d_cam @ R.T) * np.where(seen, tt, 0)[..., None], n,
                       np.where(seen, hit, -1000), prims)
    ok = seen & (tt < O_FAR)
    depth = np.where(ok, tt, 0.0)
    xyz = d_cam * depth[..., None]
    if rng is not None:
        depth = depth + rng.normal(size=depth.shape) * 0.0015 * depth ** 2
        ok &= rng.random(depth.shape) >= 0.005
        rgb = np.clip(rgb + 0.03 * rng.normal(size=rgb.shape), 0, 1)
    return dict(depth=np.where(ok, depth, 0.0).astype(np.float32),
                rgb=np.where(seen[..., None], rgb, 0).astype(np.float32),
                cls=np.where(seen, cls, -1), xyz=xyz, valid=ok)


def o_camera_velocity(k: int) -> np.ndarray:
    """Person ``k``'s velocity in the camera frame (m/s)."""
    vx, vz = O_PEOPLE[k]["velocity"]
    return _o_rotation().T @ np.array([vx, 0.0, vz])


def o_project(p: np.ndarray, intr) -> np.ndarray:
    """Camera-frame points [..., 3] to pixels (u, v)."""
    return np.stack([p[..., 0] / p[..., 2] * intr.fx + intr.cx,
                     p[..., 1] / p[..., 2] * intr.fy + intr.cy], -1)


def o_in_view(k: int, t: float, O) -> bool:
    """Whether person ``k``'s bounding cylinder (r 0.3 m, feet to head)
    projects wholly inside the image at time ``t``."""
    from pcl_tpu_torch.fusion import Intrinsics

    intr = Intrinsics(*O["intr"])
    H, W = O["shape"]
    x, z = o_person_at(k, t)
    h = O_PEOPLE[k]["height"]
    R = _o_rotation()
    pts = np.array([[x + dx, y, z + dz] for dx in (-0.3, 0.3) for dz in (-0.3, 0.3)
                    for y in (O_FLOOR_Y, O_FLOOR_Y - h)]) @ R
    uv = o_project(pts, intr)
    return bool((uv[:, 0] >= 0).all() and (uv[:, 0] < W).all() and (uv[:, 1] >= 0).all()
                and (uv[:, 1] < H).all())


def o_window_rays(xc: float, yc: float, pixel_height: float, H: int, W: int):
    """The pixel coordinates that ``PersonClassifier.evaluate`` samples for a
    window centred at ``(xc, yc)``: the ``pixel_height / 0.75`` tall, half as
    wide box at the resize's points (dst / scale), and which fall inside
    the image (the classifier pads with black)."""
    height = int(np.floor(pixel_height / 0.75 + 0.5))
    width = int(np.floor(pixel_height * 64 / (0.75 * 128) + 0.5))
    xmin = int(np.floor(xc - width / 2 + 0.5))
    ymin = int(np.floor(yc - height / 2 + 0.5))
    v = ymin + np.arange(128) / (128 / height)
    u = xmin + np.arange(64) / (64 / width)
    uu, vv = np.meshgrid(u, v)
    return uu, vv, (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H)


def o_training_windows(O):
    """(a)'s windows, 128 x 64 RGB each: both figures at ``O["views"]``
    headings, each at a depth drawn from 2-5 m and a place in view, in the
    empty room (positives), and ``O["neg_per_pos"]`` times as many windows
    of the room and its clutter at drawn places and sizes (negatives).
    Seed ``O_TRAIN_SEED``."""
    from pcl_tpu_torch.fusion import Intrinsics

    rng = np.random.default_rng(O_TRAIN_SEED)
    intr = Intrinsics(*O["intr"])
    H, W = O["shape"]
    R = _o_rotation()
    pos, neg = [], []
    for k, p in enumerate(O_PEOPLE):
        for view in range(O["views"]):
            yaw = 2 * np.pi * view / O["views"]
            z = rng.uniform(2.0, 5.0)
            x = rng.uniform(-0.3, 0.3) * z
            h = p["height"]
            prims = o_person_prims(h, x, z, (np.cos(yaw), np.sin(yaw)), p["shirt"],
                                   p["trousers"], 2 + k)
            top, bottom = (np.array([x, y, z]) @ R for y in (O_FLOOR_Y - h, O_FLOOR_Y))
            (ut, vt), (ub, vb) = o_project(top, intr), o_project(bottom, intr)
            centre = o_project(np.array([x, O_FLOOR_Y - h / 2, z]) @ R, intr)
            pos.append(_o_window(centre[0], centre[1], vb - vt, H, W, intr, prims, rng))
    n_neg = O["neg_per_pos"] * len(pos)
    for _ in range(n_neg):
        ph = rng.uniform(0.2, 0.8) * H
        pos_xy = (rng.uniform(0.1, 0.9) * W, rng.uniform(0.3, 0.7) * H)
        neg.append(_o_window(pos_xy[0], pos_xy[1], ph, H, W, intr, o_prims(0.0, False), rng))
    return np.stack(pos), np.stack(neg)


def _o_window(xc, yc, pixel_height, H, W, intr, prims, rng):
    uu, vv, inside = o_window_rays(xc, yc, pixel_height, H, W)
    R = _o_rotation()
    d_cam = np.stack([(uu - intr.cx) / intr.fx, (vv - intr.cy) / intr.fy, np.ones(uu.shape)], -1)
    t, n, hit = o_cast(np.zeros(3), d_cam @ R.T, prims)
    ok = np.isfinite(t) & (t < O_FAR) & inside
    rgb, _ = o_shade((d_cam @ R.T) * np.where(ok, t, 0)[..., None], n, np.where(ok, hit, -1000),
                     prims)
    rgb = np.clip(rgb + 0.03 * rng.normal(size=rgb.shape), 0, 1)
    return np.where(inside[..., None], rgb, 0).astype(np.float32)


def path_o_inputs(O):
    """Path O's host inputs: every frame (depth, RGB, grey, true classes,
    camera-frame points), the true flow from each frame to the next, each
    person's true visible centroid and whether it is wholly in view, and
    (a)'s training windows."""
    from pcl_tpu_torch.fusion import Intrinsics

    intr = Intrinsics(*O["intr"])
    H, W = O["shape"]
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    rng = np.random.default_rng(O_SEED)
    frames = []
    for f in range(O["frames"]):
        t = f / O_HZ
        r = o_render(t, intr, u, v, rng)
        xyz = np.stack([(u - intr.cx) / intr.fx * r["depth"], (v - intr.cy) / intr.fy * r["depth"],
                        r["depth"]], -1).astype(np.float32)
        grey = np.round(255.0 * (r["rgb"] @ np.array([0.299, 0.587, 0.114]))).astype(np.float32)
        flow = np.zeros((H, W, 2), np.float32)
        centroids, in_view = [], []
        for k in range(len(O_PEOPLE)):
            on = r["cls"] == 2 + k
            moved = r["xyz"][on] + o_camera_velocity(k) / O_HZ
            flow[on] = o_project(moved, intr) - np.stack([u[on], v[on]], -1)
            seen = on & r["valid"]
            centroids.append(xyz[seen].mean(0) if seen.any() else np.full(3, np.nan))
            in_view.append(o_in_view(k, t, O))
        frames.append(dict(xyz=xyz, valid=r["depth"] > 0, rgb=r["rgb"], grey=grey, cls=r["cls"],
                           flow=flow, centroids=np.array(centroids), in_view=in_view))
    pos, neg = o_training_windows(O)
    return dict(frames=frames, pos=pos, neg=neg, intr=intr)


def o_frame_cloud(fr, dev, onehot: bool = False):
    """A frame's valid pixels as a cloud with RGB (and the true classes one
    hot, for the CRF's truth)."""
    from pcl_tpu_torch.core.cloud import make_cloud

    ok = fr["valid"].reshape(-1)
    attrs = {"rgb": fr["rgb"].reshape(-1, 3)[ok]}
    if onehot:
        attrs["onehot"] = np.eye(len(O_CLASSES), dtype=np.float32)[fr["cls"].reshape(-1)[ok]]
    return make_cloud(fr["xyz"].reshape(-1, 3)[ok], attrs=attrs, device=dev)


def o_reference_keep(xyz: np.ndarray, c0: np.ndarray, coeffs: np.ndarray, radius: float,
                     top: float = np.inf) -> np.ndarray:
    """Host (float64) mask of the points off the ground (more than 5 cm above
    the plane ``coeffs``, below ``top``) and within ``radius`` of ``c0`` in
    the ground plane: the tracker's reference, cut out of frame 0 as PCL's
    tracking tutorial cuts it (the plane removed once, the cluster about the
    detection)."""
    n, d0 = coeffs[:3], coeffs[3]
    x = np.asarray(xyz, np.float64)
    rel = x - c0
    hgt = x @ n + d0
    return ((np.linalg.norm(rel - np.outer(rel @ n, n), axis=1) < radius) & (hgt > 0.05)
            & (hgt < top))


def o_hog_window(grey: np.ndarray, cand, n: np.ndarray, d0: float, K: np.ndarray) -> np.ndarray:
    """A detection's window of the grey image (the classifier's geometry),
    128 x 64."""
    from pcl_tpu_torch.people.classifier import _resize_rgb

    c = np.asarray(cand.centroid, np.float64)
    h_c = float(c @ n + d0)
    top, bottom = c + (cand.height - h_c) * n, c - h_c * n
    pt, pb, pc = (K @ q for q in (top, bottom, c))
    pt, pb, pc = pt / pt[2], pb / pb[2], pc / pc[2]
    ph = pb[1] - pt[1]
    height = int(np.floor(ph / 0.75 + 0.5))
    width = int(np.floor(ph * 64 / (0.75 * 128) + 0.5))
    xmin, ymin = int(np.floor(pc[0] - width / 2 + 0.5)), int(np.floor(pc[1] - height / 2 + 0.5))
    H, W = grey.shape
    box = np.zeros((max(height, 1), max(width, 1), 1), np.float32)
    y0, y1, x0, x1 = max(ymin, 0), min(ymin + height, H), max(xmin, 0), min(xmin + width, W)
    if y1 > y0 and x1 > x0:
        box[y0 - ymin:y1 - ymin, x0 - xmin:x1 - xmin, 0] = grey[y0:y1, x0:x1]
    return _resize_rgb(box, 64, 128)[..., 0].astype(np.float32)


def _o_svm_parts(x, y, O, dev, run):
    """(a) on the port: the linear and RBF trainers, Platt scaling, the
    cross-validation and the model file's round trip."""
    from pcl_tpu_torch import ml

    xt, yt = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    lin = run("(a) svm_train (linear)", lambda: ml.svm_train(xt, yt, kernel="linear",
                                                             **O["svm"]))
    rbf = run("(a) svm_train_dual (rbf)", lambda: ml.svm_train_dual(
        xt, yt, kernel="rbf", gamma=O["rbf_gamma"], C=O["svm"]["C"]))
    kw = dict(n_folds=O["folds"], seed=0, train_fn=ml.svm_train, classify_fn=ml.svm_classify,
              device=dev, kernel="linear", **O["svm"])
    _, platt = run("(a) svm_train_probability", lambda: ml.svm_train_probability(x, y, **kw))
    cv = run("(a) svm_cross_validation", lambda: ml.svm_cross_validation(x, y, **kw))
    return lin, rbf, platt, cv


def _o_file_round_trip(model, platt, dev):
    """The linear model and its sigmoid written as a libsvm file, read back,
    written again and read again: ``(second and third files equal, reloaded
    arrays equal, probability equal)``."""
    from pcl_tpu_torch import ml

    with tempfile.TemporaryDirectory() as d:
        paths = [os.path.join(d, f"m{i}.model") for i in range(3)]
        ml.save_libsvm_model(paths[0], model, platt)
        first = ml.load_libsvm_model(paths[0], device=dev)
        ml.save_libsvm_model(paths[1], first, ml.load_libsvm_probability(paths[0]))
        second = ml.load_libsvm_model(paths[1], device=dev)
        ml.save_libsvm_model(paths[2], second, ml.load_libsvm_probability(paths[1]))
        with open(paths[1], "rb") as a, open(paths[2], "rb") as b:
            same_file = a.read() == b.read()
        same_arrays = all(torch.equal(getattr(first, k), getattr(second, k))
                          for k in ("w", "b", "support", "gamma", "mean", "scale"))
        same_prob = tuple(ml.load_libsvm_probability(paths[2])) == tuple(platt)
    return same_file, same_arrays, same_prob


def path_o_chain(inp, O, dev, gen_dev=None, draws=None, on_stage=None):
    """Path O's main path on the port, on ``dev``: (a) the person classifier
    trained on HOG windows, (b) people detection in every frame (0.06 m
    voxels, B2), (c) the dense CRF on frame 0's 2 cm voxels (B2) and the CLI,
    (d) both trackers on every frame's 2 cm voxels (B2; B1 once a step in
    each), (e) KLT over the sequence and the 2-D corners. Draws come from
    generators seeded ``O_SEED`` on ``gen_dev`` (default ``dev``) or from
    ``draws`` (the JAX package's: ``ground`` (idx, sub), ``kld`` and ``pf``
    lists of step draws). Returns ``(out, seconds)``."""
    from pcl_tpu_torch import filters, ml
    from pcl_tpu_torch.core.cloud import make_cloud
    from pcl_tpu_torch.keypoints import corners2d
    from pcl_tpu_torch.people import GroundBasedPeopleDetector, classifier, hog
    from pcl_tpu_torch.tools import crf_segmentation
    from pcl_tpu_torch.tracking import kld, particle_filter as pf, pyramidal_klt

    dev = torch.device(dev)
    draws = draws or {}
    gen_dev = torch.device(dev if gen_dev is None else gen_dev)
    out, secs = {}, {}

    def run(name, fn):
        if on_stage is not None:
            on_stage(name)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0
        return r

    def gen():
        g = torch.Generator(device=gen_dev)
        g.manual_seed(O_SEED)
        return g

    frames = inp["frames"]
    intr = inp["intr"]
    K = np.array([[intr.fx, 0, intr.cx], [0, intr.fy, intr.cy], [0, 0, 1.0]])
    # (a) the person classifier
    wins = np.concatenate([inp["pos"], inp["neg"]])
    x = run("(a) dollar_hog", lambda: np.stack([classifier.dollar_hog(w) for w in wins]))
    y = np.concatenate([np.ones(len(inp["pos"])), -np.ones(len(inp["neg"]))]).astype(np.float32)
    lin, rbf, platt, cv = _o_svm_parts(x, y, O, dev, run)
    xt = torch.as_tensor(x, device=dev)
    out["svm"] = dict(cv=cv, platt=tuple(platt),
                      lin_train=float(np.mean(np.sign(ml.svm_classify(lin, xt).cpu().numpy())
                                              == y)),
                      rbf_train=float(np.mean(np.sign(ml.svm_classify_dual(rbf, xt).cpu().numpy())
                                              == y)),
                      lin_w=lin.w.cpu().numpy())
    out["files"] = run("(a) libsvm file round trip", lambda: _o_file_round_trip(lin, platt, dev))
    w_eff = (lin.w * lin.scale).cpu().numpy().astype(np.float32)
    clf = classifier.PersonClassifier({"window_height": 128, "window_width": 64,
                                       "b": float(np.dot(w_eff.astype(np.float64),
                                                         lin.mean.cpu().numpy()) - float(lin.b)),
                                       "weights": w_eff})
    # (b) people detection in every frame
    det = GroundBasedPeopleDetector(intrinsics=K, classifier=clf, **O["det"])
    dets, hogs = [], []
    coeffs = None
    for f, fr in enumerate(frames):
        vox = run("(b) voxel grid 0.06 m", lambda: live_rows(
            filters.voxel_downsample(o_frame_cloud(fr, dev), O["det_leaf"])))
        if f == 0:
            samples = draws.get("ground") or det.draw_ground_samples(vox, gen())
            found = run("(b) detect", lambda: det.detect(vox, samples=samples,
                                                         rgb_image=fr["rgb"]))
            coeffs = det.ground_coeffs = det.last_ground
        else:
            found = run("(b) detect", lambda: det.detect(vox, rgb_image=fr["rgb"]))
        dets.append(found)
        hogs.append(run("(b) hog_features", lambda: [hog.hog_features(torch.as_tensor(
            o_hog_window(fr["grey"], c_, coeffs[:3], coeffs[3], K), device=dev)).cpu().numpy()
            for c_ in found]))
    out["dets"] = [[(np.asarray(c_.centroid), c_.height, c_.n_points, c_.score) for c_ in d]
                   for d in dets]
    out["ground"] = coeffs
    out["hogs"] = hogs
    # (c) the dense CRF on frame 0's 2 cm voxels
    vox2 = run("(c) voxel grid 2 cm", lambda: live_rows(
        filters.voxel_downsample(o_frame_cloud(frames[0], dev, onehot=True), O["crf_leaf"])))
    cx = vox2.xyz.cpu().numpy()
    crgb = vox2.attrs["rgb"].cpu().numpy()
    truth = np.argmax(vox2.attrs["onehot"].cpu().numpy(), 1).astype(np.int32)
    rng = np.random.default_rng(O_SEED)
    n2, C = len(cx), len(O_CLASSES)
    flip = rng.random(n2) < O["crf"]["flip"]
    noisy = np.where(flip, (truth + rng.integers(1, C, n2)) % C, truth).astype(np.int32)
    cf = O["crf"]
    p_other = (1.0 - cf["confidence"]) / (C - 1)
    unary = np.full((n2, C), -np.log(p_other), np.float32)
    unary[np.arange(n2), noisy] = -np.log(cf["confidence"])

    def crf(impl):
        m = ml.DenseCRF(n2, C, device=dev)
        m.set_unary_energy(unary)
        m.add_pairwise_gaussian(cx, cf["sxyz"])
        m.add_pairwise_bilateral(cx, crgb, cf["sxyz"] * 4, cf["srgb"],
                                 n_bins=cf["bilateral_bins"])
        return m.inference(cf["iterations"], filter_impl=impl)

    out["crf"] = {impl: run(f"(c) DenseCRF ({impl})", lambda impl=impl: crf(impl))
                  for impl in ("permutohedral", "grid")}
    out["crf_truth"], out["crf_noisy"] = truth, noisy

    def cli():
        from pcl_tpu_torch import io as tio

        with tempfile.TemporaryDirectory() as d:
            src, dst = os.path.join(d, "in.pcd"), os.path.join(d, "out.pcd")
            tio.save(src, make_cloud(cx, attrs={"rgb": crgb, "label": noisy}, device=dev))
            with contextlib.redirect_stdout(pyio.StringIO()):
                crf_segmentation.main([src, dst, "-iters", str(cf["iterations"]), "-sxyz",
                                       str(cf["sxyz"]), "-srgb", str(cf["srgb"]),
                                       "-unary-confidence", str(cf["confidence"]), "--device",
                                       dev.type])
            return tio.load(dst, device=dev).attrs["label"].cpu().numpy()

    out["crf_cli"] = run("(c) tools.crf_segmentation", cli)
    # (d) tracking person 1 from its detection in frame 0
    truth0 = frames[0]["centroids"][0]
    near = [c_ for c_ in dets[0] if np.linalg.norm(np.asarray(c_.centroid) - truth0) < 0.5]
    c0 = np.asarray(near[0].centroid if near else truth0, np.float64)
    sel = o_reference_keep(cx, c0, coeffs, O["ref_radius"], top=2.4)
    ref = make_cloud((cx[sel] - c0).astype(np.float32), device=dev)
    init = torch.eye(4, dtype=torch.float32, device=dev)
    init[:3, 3] = torch.as_tensor(c0, dtype=torch.float32, device=dev)
    kc = O["kld"]
    sn = torch.tensor(O["step_noise"], dtype=torch.float32, device=dev)
    ks = kld.init_kld_tracker(kc["max"], kc["init"], init_pose=init, device=dev)
    ps = pf.init_tracker(O["pf"], init_pose=init, device=dev)
    g_k, g_p = gen(), gen()
    track = {"kld": [], "pf": []}
    for f, fr in enumerate(frames):
        scene = vox2 if f == 0 else run("(d) voxel grid 2 cm", lambda: live_rows(
            filters.voxel_downsample(o_frame_cloud(fr, dev), O["track_leaf"])))
        dk = draws["kld"][f] if "kld" in draws else kld.draw_kld_step(ks, ref, g_k)
        ks, pose_k = run("(d) step_tracker_kld", lambda: kld.step_tracker_kld_core(
            ks, ref, scene, dk, step_noise=sn, bin_size=kc["bin_size"], epsilon=kc["epsilon"],
            z_delta=kc["z_delta"]))
        dp = draws["pf"][f] if "pf" in draws else pf.draw_tracker_step(ps, ref, g_p)
        ps, pose_p = run("(d) step_tracker", lambda: pf.step_tracker_core(ps, ref, scene, dp,
                                                                          step_noise=sn))
        track["kld"].append((pose_k.cpu().numpy(), int(ks.active.sum())))
        track["pf"].append(pose_p.cpu().numpy())
    out["track"], out["c0"], out["n_ref"] = track, c0, int(sel.sum())
    # (e) KLT over the sequence, and the corners of frame 0
    g0 = frames[0]["grey"]
    ac = O["agast"]
    score = run("(e) agast", lambda: corners2d.agast_score(
        torch.as_tensor(g0, device=dev), ac["threshold"]).cpu().numpy())
    kps = run("(e) agast", lambda: corners2d.agast_keypoints(g0, ac["threshold"], device=dev))
    order = np.argsort(-score[kps[:, 0], kps[:, 1]], kind="stable")[:ac["keep"]]
    kps = kps[order]
    out["agast"] = kps
    pts = kps.astype(np.float32)
    steps = []
    for f in range(len(frames) - 1):
        new, ok = run("(e) pyramidal_klt", lambda: pyramidal_klt(
            frames[f]["grey"], frames[f + 1]["grey"], pts, device=dev, **O["klt"]))
        steps.append((pts, new, ok))
        pts = new[ok]
    out["klt"] = steps
    out["brisk"] = run("(e) brisk_descriptor", lambda: corners2d.brisk_descriptor(
        g0, kps, device=dev))
    out["brisk_kps"] = run("(e) brisk_keypoints", lambda: corners2d.brisk_keypoints(
        g0, ac["threshold"], device=dev))
    out["trajkovic"] = run("(e) trajkovic_keypoints", lambda: corners2d.trajkovic_keypoints(
        g0, device=dev))
    return out, secs


def path_o_metrics(inp, out, O) -> dict:
    """Path O's measures from a chain's host outputs (either package's)."""
    frames = inp["frames"]
    m = {"cv": out["svm"]["cv"], "rbf_train": out["svm"]["rbf_train"],
         "lin_train": out["svm"]["lin_train"], "files": list(out["files"])}
    # (b): per person, the frames wholly in view in which a detection lies within 0.3 m
    found, cerr, herr, clutter, other = [], [], [], 0, 0
    clutter_at = [np.array(L) for L in ((0.5 * (O_BOX[0][0] + O_BOX[1][0]), O_BOX[0][1],
                                         0.5 * (O_BOX[0][2] + O_BOX[1][2])), O_SPHERE[0],
                                        (O_CYLINDER[0][0], O_CYLINDER[2][0], O_CYLINDER[0][1]))]
    R = _o_rotation()
    clutter_cam = [c @ R for c in clutter_at]
    for f, fr in enumerate(frames):
        used = set()
        for k in range(len(O_PEOPLE)):
            if not fr["in_view"][k]:
                continue
            d = [np.linalg.norm(c - fr["centroids"][k]) for c, *_ in out["dets"][f]]
            j = int(np.argmin(d)) if d else -1
            ok = j >= 0 and d[j] < 0.3
            found.append(ok)
            if ok:
                used.add(j)
                cerr.append(d[j])
                herr.append(abs(out["dets"][f][j][1] - O_PEOPLE[k]["height"]))
        for j, (c, *_) in enumerate(out["dets"][f]):
            if j in used:
                continue
            if min(np.linalg.norm(c - q) for q in clutter_cam) < 0.5:
                clutter += 1
            else:
                other += 1
    m.update(found=float(np.mean(found)) if found else 0.0, n_in_view=len(found),
             centroid_err=float(np.max(cerr)) if cerr else math.inf,
             height_err=float(np.max(herr)) if herr else math.inf, clutter=clutter, other=other)
    # (c)
    t, noisy = out["crf_truth"], out["crf_noisy"]
    m["crf_before"] = float(np.mean(noisy == t))
    for impl, q in out["crf"].items():
        m[f"crf_{impl}"] = float(np.mean(np.argmax(q, 1) == t))
    # the CLI reads the labels and 8-bit colours back from a PCD file
    m["crf_cli"] = float(np.mean(out["crf_cli"] == t))
    # (d): the MAP centroid against person 1's true path from the reference's centroid
    v = o_camera_velocity(0)
    true = np.array([out["c0"] + v * f / O_HZ for f in range(len(frames))])
    for name in ("kld", "pf"):
        poses = [p[0] if name == "kld" else p for p in out["track"][name]]
        e = np.linalg.norm(np.array([p[:3, 3] for p in poses]) - true, axis=1)
        m[f"rmse_{name}"] = float(np.sqrt(np.mean(e ** 2)))
    m["kld_live"] = [n for _, n in out["track"]["kld"]]
    # (e): each step's displacement against the rendered flow at the point's pixel
    bg, people = [], []
    H, W = O["shape"]
    for f, (pts, new, ok) in enumerate(out["klt"]):
        iy = np.clip(np.round(pts[:, 0]).astype(int), 0, H - 1)
        ix = np.clip(np.round(pts[:, 1]).astype(int), 0, W - 1)
        flow = frames[f]["flow"][iy, ix][:, ::-1]              # (dy, dx)
        err = np.linalg.norm((new - pts) - flow, axis=1)[ok]
        on_person = (frames[f]["cls"][iy, ix] >= 2)[ok] & (frames[f]["cls"][iy, ix] <= 3)[ok]
        bg.extend(err[~on_person])
        people.extend(err[on_person])
    n0 = len(out["agast"])
    m.update(klt_bg=float(np.median(bg)) if bg else math.inf,
             klt_people=float(np.median(people)) if people else math.inf,
             klt_share=float(out["klt"][-1][2].sum() / max(n0, 1)) if out["klt"] else 0.0,
             n_agast=n0, n_brisk=len(out["brisk_kps"]), n_trajkovic=len(out["trajkovic"]))
    return m


O_PLAIN_ROWS = 1 << 15      # B1's plain version on the first rows of a call (a row depends
                            # on its own query alone)
O_NEAR = 1e-4               # a resampling point this near a cumulative-weight edge may flip
# limits: 1.5 x the JAX package's CPU rehearsal at full width (tests/rehearse_path_o.py jax,
# on this sequence, the trackers against each frame's whole 2 cm voxel cloud): the shares as
# 1.5 x their shortfall. The rehearsal read cross-validation 1.0, both people in all 52
# person-frames wholly in view, centroids 0.075541 m and heights 0.018883 m off at most, no
# detection on the clutter, CRF accuracy 0.80017 -> 0.99960 (lattice), 0.96112 (grid),
# 0.99961 (the CLI), tracker RMSE 0.16594 m (KLD) and 0.041861 m, KLT's median flow error on
# the background 0.12150 px and 0.998 of its points tracked
O_LIMITS = dict(cv=1.0, found=1.0, centroid_err=0.1133, height_err=0.02832, clutter=0,
                crf_permutohedral=0.999405, crf_grid=0.9417, crf_cli=0.999413, rmse_kld=0.2489,
                rmse_pf=0.06279, klt_bg=0.1823, klt_share=0.997)


def o_checks(m, lim, expect):
    """Path O's checks against ``O_LIMITS``; a check whose limit is None is
    printed, not made."""
    printed = []

    def hold(cond, limit, what):
        if limit is None:
            printed.append(what)
        else:
            expect(cond, what)

    L = lim["cv"]
    hold(L is not None and m["cv"] >= L, L, f"(a) cross-validation accuracy {m['cv']:.4f} "
                                            f"(limit {L})")
    expect(all(m["files"]), f"(a) the libsvm model file does not round-trip: {m['files']}")
    L = lim["found"]
    hold(L is not None and m["found"] >= L, L,
         f"(b) each person found in {m['found']:.4f} of the {m['n_in_view']} person-frames "
         f"wholly in view (limit {L})")
    for key, unit in (("centroid_err", "m"), ("height_err", "m")):
        L = lim[key]
        hold(L is not None and m[key] <= L, L, f"(b) largest {key.replace('_', ' ')} "
                                               f"{m[key]:.4f} {unit} (limit {L})")
    hold(m["clutter"] <= (lim["clutter"] or 0), lim["clutter"],
         f"(b) {m['clutter']} detections on the clutter (limit {lim['clutter']})")
    for impl in ("permutohedral", "grid", "cli"):
        acc, L = m[f"crf_{impl}"], lim[f"crf_{impl}"]
        hold(L is not None and acc >= L and acc > m["crf_before"], L,
             f"(c) CRF ({impl}) label accuracy {acc:.5f} from {m['crf_before']:.5f} (limit {L})")
    for name in ("kld", "pf"):
        L = lim[f"rmse_{name}"]
        hold(L is not None and m[f"rmse_{name}"] <= L, L,
             f"(d) {name} tracker's centroid RMSE {m[f'rmse_{name}']:.4f} m (limit {L})")
    L = lim["klt_bg"]
    hold(L is not None and m["klt_bg"] <= L, L, f"(e) KLT's median flow error on the background "
                                                f"{m['klt_bg']:.4f} px (limit {L})")
    L = lim["klt_share"]
    hold(L is not None and m["klt_share"] >= L, L, f"(e) KLT's share of tracked points "
                                                   f"{m['klt_share']:.4f} (limit {L})")
    return printed


def _o_rows_agree(a, b, w, u0, tol=1e-4):
    """Resampled particles row by row: rows off every cumulative-weight edge
    (``O_NEAR``) agree to ``tol``; returns ``(rows apart, rows near an
    edge)``."""
    w = np.asarray(w, np.float64)
    P = len(w)
    cum = np.cumsum(w) / w.sum()
    near = np.abs(float(u0) + np.arange(P)[:, None] / P - cum[None, :]).min(1) <= O_NEAR
    apart = np.abs(a - b).max(1) > tol
    return int(apart.sum()), int(near.sum()), bool((apart & ~near).any())


def o_card_vs_cpu(expect, card=None):
    """Path O's functions on the card against the port's CPU run: the chain
    at 80 x 60 with CPU-drawn samples, and one step of each tracker from one
    state. Returns lines to print."""
    from pcl_tpu_torch import filters
    from pcl_tpu_torch.core.cloud import make_cloud
    from pcl_tpu_torch.people import hog
    from pcl_tpu_torch.tracking import kld, particle_filter as pf

    card = torch.device("cuda") if card is None else card
    cpu = torch.device("cpu")
    O = O_SMALL
    small = path_o_inputs(O)
    a, b = (path_o_chain(small, O, d, gen_dev="cpu")[0] for d in (card, cpu))
    lines = []
    wgap = float(np.abs(a["svm"]["lin_w"] - b["svm"]["lin_w"]).max()
                 / np.abs(b["svm"]["lin_w"]).max())
    expect(wgap <= 1e-4 and a["svm"]["cv"] == b["svm"]["cv"] and all(a["files"]),
           f"(card vs CPU) (a) w by {wgap}, cross-validation {a['svm']['cv']} / {b['svm']['cv']}")
    same_n = [len(x) for x in a["dets"]] == [len(x) for x in b["dets"]]
    dgap = max([float(np.abs(p[0] - q[0]).max()) + abs(p[1] - q[1]) for x, y in
                zip(a["dets"], b["dets"]) for p, q in zip(x, y)] or [0.0])
    npts = all(p[2] == q[2] for x, y in zip(a["dets"], b["dets"]) for p, q in zip(x, y))
    sgap = max([abs(p[3] - q[3]) / max(abs(q[3]), 1.0) for x, y in zip(a["dets"], b["dets"])
                for p, q in zip(x, y)] or [0.0])
    expect(same_n and npts and dgap <= 1e-5 and sgap <= 1e-5,
           f"(card vs CPU) (b) detections: counts equal {same_n}, points {npts}, centroids and "
           f"heights by {dgap}, scores by {sgap}")
    cgap, firm_same = 0.0, True
    for impl in ("permutohedral", "grid"):
        qa, qb = a["crf"][impl], b["crf"][impl]
        cgap = max(cgap, float(np.abs(qa - qb).max()) if len(qb) else 0.0)
        top2 = np.sort(qb, 1)[:, -2:]
        firm = top2[:, 1] - top2[:, 0] > 1e-4
        firm_same &= bool(np.array_equal(qa.argmax(1)[firm], qb.argmax(1)[firm]))
    cli_same = float(np.mean(a["crf_cli"] == b["crf_cli"]))
    expect(cgap <= 1e-4 and firm_same and cli_same >= 0.99,
           f"(card vs CPU) (c) posteriors by {cgap}, firm labels equal {firm_same}, the CLI's "
           f"labels {cli_same:.4f} equal")
    (pa, na, oka), (pb, nb, okb) = a["klt"][0], b["klt"][0]
    kgap = float(np.abs(na - nb)[okb].max()) if okb.any() else 0.0
    same_corners = all(np.array_equal(a[k], b[k])
                       for k in ("agast", "brisk", "brisk_kps", "trajkovic"))
    expect(kgap <= 1e-3 and np.array_equal(oka, okb) and same_corners,
           f"(card vs CPU) (e) KLT by {kgap} px (status equal {np.array_equal(oka, okb)}), "
           f"corners equal {same_corners}")
    # one step of each tracker from one state and one set of CPU draws
    fr = small["frames"][1]
    out = {}
    for d in (card, cpu):
        scene = live_rows(filters.voxel_downsample(o_frame_cloud(fr, d), O["track_leaf"]))
        xyz = scene.xyz.cpu().numpy()
        keep = o_reference_keep(xyz, b["c0"], b["ground"], O["ref_radius"], top=2.4)
        ref = make_cloud(xyz[keep] - b["c0"].astype(np.float32), device=d)
        init = torch.eye(4, device=d)
        init[:3, 3] = torch.as_tensor(b["c0"], dtype=torch.float32, device=d)
        sn = torch.tensor(O["step_noise"], device=d)
        ks = kld.init_kld_tracker(O["kld"]["max"], O["kld"]["init"], init_pose=init, device=d)
        ps = pf.init_tracker(O["pf"], init_pose=init, device=d)
        g = torch.Generator()
        g.manual_seed(O_SEED)
        dk = kld.draw_kld_step(ks, ref, g)
        dp = pf.draw_tracker_step(ps, ref, g)
        kw = dict(bin_size=O["kld"]["bin_size"], epsilon=O["kld"]["epsilon"],
                  z_delta=O["kld"]["z_delta"])
        nk, posek = kld.step_tracker_kld_core(ks, ref, scene, dk, step_noise=sn, **kw)
        npf, posep = pf.step_tracker_core(ps, ref, scene, dp, step_noise=sn)
        wk = kld.weigh_kld(ks, ref, scene, dk, sn)[1]
        out[d.type] = (posek.cpu().numpy(), nk.particles.cpu().numpy(), nk.active.cpu().numpy(),
                       wk.cpu().numpy(), dk.u0.cpu(), posep.cpu().numpy(),
                       npf.particles.cpu().numpy())
    (ka, xa, aa, _, _, pa_, ya), (kb, xb, ab, wb, u0, pb_, yb) = out[card.type], out["cpu"]
    tgap = max(float(np.abs(ka - kb).max()), float(np.abs(pa_ - pb_).max()))
    apart, near, bad = _o_rows_agree(xa, xb, wb, u0)
    expect(tgap <= 1e-4 and np.array_equal(aa, ab) and not bad,
           f"(card vs CPU) (d) tracker poses by {tgap}, live slots equal {np.array_equal(aa, ab)}, "
           f"{apart} KLD particles apart ({near} near an edge)")
    lines.append(f"80 x 60 chain: w {wgap:.1e}, detections {sum(len(x) for x in b['dets'])} equal "
                 f"{same_n and npts} ({dgap:.1e}), CRF {cgap:.1e}, KLT {kgap:.1e} px, corners "
                 f"equal {same_corners}; one tracker step: poses {tgap:.1e}, {apart} KLD "
                 f"particles apart ({near} near an edge)")
    # HOG on the card against the CPU, on one window of frame 0
    img = small["frames"][0]["grey"][:, :48]
    ha, hb = (hog.hog_features(torch.as_tensor(img, device=d)).cpu().numpy() for d in (card, cpu))
    share = float(np.mean(np.abs(ha - hb).max(1) <= 1e-5))
    expect(share >= 0.9, f"(card vs CPU) hog_features: {share:.3f} of the blocks within 1e-5")
    lines.append(f"hog_features: {share:.3f} of the blocks within 1e-5")
    return lines


def phase17_path_o(segsum, nn1_mod, record_b1, record_b2):
    """Path O: PCL's people-detection, CRF and tracking tutorials on a 30-frame
    VGA RGB-D sequence."""
    from pcl_tpu_torch.search import bruteforce

    failed = []

    def expect(cond: bool, what: str) -> None:
        if not cond:
            print(f"phase 17: CHECK FAILED: {what}", flush=True)
            failed.append(what)

    dev = torch.device("cuda")
    O = O_FULL
    inp, isecs = timed(lambda: path_o_inputs(O))
    print(f"phase 17: inputs in {isecs:.1f} s: {O['frames']} frames of "
          f"{int(np.mean([f['valid'].sum() for f in inp['frames']]))} valid pixels on average, "
          f"{len(inp['pos'])} positive and {len(inp['neg'])} negative windows; persons wholly in "
          f"view in {sum(sum(f['in_view']) for f in inp['frames'])} person-frames", flush=True)
    small = path_o_inputs(O_SMALL)
    _, wsecs = timed(lambda: path_o_chain(small, O_SMALL, dev))
    print(f"phase 17: warm-up at 80 x 60 in {wsecs:.1f} s", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trace.reset()
    with kernel_calls(bruteforce, segsum) as calls:
        (out, secs), total = timed(lambda: path_o_chain(
            inp, O, dev, on_stage=lambda n: calls.__setitem__("stage", n)))
    b1, b2 = launch_count("nn1"), launch_count("segsum")
    record_b1["launches_by_path"]["O"] = b1
    record_b2["launches_by_path"]["O"] = b2
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    card = card_line()
    F = O["frames"]
    print(f"phase 17: path O in {total:.1f} s ({total / F * 1e3:.1f} ms a frame), peak memory "
          f"{peak:.2f} GiB, launches nn1 {b1}, segsum {b2} [{card}]", flush=True)
    for name, v in secs.items():
        print(f"phase 17: {name}: {v * 1e3:.1f} ms [{card}]", flush=True)
    parts = {p: sum(v for k, v in secs.items() if k.startswith(p))
             for p in ("(a)", "(b)", "(c)", "(d)", "(e)")}
    print("phase 17: by part " + ", ".join(f"{p} {v:.2f} s" for p, v in parts.items())
          + "; per frame " + ", ".join(f"{p} {parts[p] / F * 1e3:.1f} ms"
                                       for p in ("(b)", "(d)", "(e)")) + f" [{card}]", flush=True)
    expect(b2 == 2 * F and b1 == 2 * F,
           f"path O launched B2 {b2} times (a 0.06 m and a 2 cm voxel grid a frame: {2 * F}) "
           f"and B1 {b1} times (each tracker once a step: {2 * F})")
    expect(len(calls["nn1"]) == b1 and len(calls["segsum"]) == b2,
           "the kept kernel calls do not match the launch counts")
    m = path_o_metrics(inp, out, O)
    print("phase 17: metrics " + json.dumps(m, default=float), flush=True)
    for what in o_checks(m, O_LIMITS, expect):
        print(f"phase 17: printed, not checked (the reference does not meet it): {what}",
              flush=True)
    lines, csecs = timed(lambda: o_card_vs_cpu(expect))
    print(f"phase 17: card against CPU ({csecs:.1f} s): " + "; ".join(lines), flush=True)
    rows1, rows2 = hold_to_plain(calls, nn1_mod, segsum, expect, "phase 17:", O_PLAIN_ROWS, card,
                                 time_once="stage")
    record_b1["path_o"] = rows1
    record_b2["path_o"] = rows2
    check(not failed, "path O: " + "; ".join(failed))
    return {"total_s": total, "peak_gib": peak, "parts": parts, "metrics": m}


# ---------------------------------------------------------------------------
# path P: PCL's stereo, organized-edge, image-extractor, range-likelihood and
# mesh-conversion tools on path O's room at frame 0
# ---------------------------------------------------------------------------

P_SEED = 15                 # the stereo pair's colour noise and the surface samples
P_LEFT = (0.05, 1.0)        # the left camera: m along the Kinect's x, deg about its y
P_BASELINE = 0.12           # m from the left camera to the right along its x (Bumblebee2/ZED)
P_FULL = dict(
    shape=O_FULL["shape"], intr=O_FULL["intr"],
    # (a): block_matching and adaptive_cost_so_matching at 64 disparities, the JAX
    # defaults otherwise; the DEM at its defaults
    max_disparity=64,
    # (b): 2 cm voxels, point-to-point ICP on the brute backend
    leaf=0.02, icp=dict(max_corr_dist=0.1, max_iterations=30),
    # (d): the candidates, 5 x 5 x 5 steps about the true pose
    steps=(0.02, 0.02, 0.5),
    # (e): the icosphere's subdivisions, the cylinder's sides, the tools at their JAX
    # defaults, the scans' voxels and the analytic surface samples
    ico_levels=3, cyl_sides=48, sampling=[], mesh2pcd=[], scanner=[], scan_leaf=0.01,
    surface_samples=200_000)
# 80 x 60 for the CPU tests (tests/test_torch_path_p.py) and the card against the CPU:
# disparities, voxels and the tools' views cut with the pixels
P_SMALL = dict(
    P_FULL, shape=O_SMALL["shape"], intr=O_SMALL["intr"], max_disparity=12, leaf=0.08,
    ico_levels=2, cyl_sides=16, sampling=["-n_samples", "4000"],
    mesh2pcd=["-n_views", "4", "-resolution", "32", "-dense_samples", "6000"],
    scanner=["-n_views", "3", "-resolution", "24", "-dense_samples", "5000"], scan_leaf=0.04,
    surface_samples=6000)
P_OBJECTS = ("box", "sphere", "cylinder")


def _p_rot_y(deg: float) -> np.ndarray:
    a = math.radians(deg)
    return np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0], [-math.sin(a), 0, math.cos(a)]])


def p_left_in_kinect() -> np.ndarray:
    """The left camera's pose in the Kinect's frame (4 x 4, camera to
    Kinect): what (b)'s ICP recovers."""
    T = np.eye(4)
    T[:3, :3] = _p_rot_y(P_LEFT[1])
    T[:3, 3] = (P_LEFT[0], 0.0, 0.0)
    return T


def p_box_mesh():
    (x0, y0, z0), (x1, y1, z1) = O_BOX
    v = np.array([[x, y, z] for x in (x0, x1) for y in (y0, y1) for z in (z0, z1)], np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    return v, np.array([t for a, b, c, d in quads for t in ((a, b, c), (a, c, d))], np.int32)


def p_sphere_mesh(levels: int):
    """Path O's sphere as an icosphere: the icosahedron split ``levels``
    times, its vertices pushed out to the sphere."""
    p = (1 + 5 ** 0.5) / 2
    v = [np.array(x, np.float64) for x in
         [(-1, p, 0), (1, p, 0), (-1, -p, 0), (1, -p, 0), (0, -1, p), (0, 1, p), (0, -1, -p),
          (0, 1, -p), (p, 0, -1), (p, 0, 1), (-p, 0, -1), (-p, 0, 1)]]
    f = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9), (5, 11, 4),
         (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8),
         (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    for _ in range(levels):
        mid, nf = {}, []

        def m(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                mid[key] = len(v)
                v.append((v[a] + v[b]) / 2)
            return mid[key]

        for a, b, c in f:
            ab, bc, ca = m(a, b), m(b, c), m(c, a)
            nf += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        f = nf
    v = np.array(v)
    c, r = O_SPHERE
    v = c + r * v / np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32), np.array(f, np.int32)


def p_cylinder_mesh(sides: int):
    """Path O's capped cylinder: two rings of ``sides`` vertices, the side's
    quads split in two, each cap a fan about its centre."""
    (cx, cz), r, (y0, y1) = O_CYLINDER
    a = 2 * np.pi * np.arange(sides) / sides
    ring = np.stack([cx + r * np.cos(a), np.zeros(sides), cz + r * np.sin(a)], 1)
    v = np.concatenate([ring + [0, y0, 0], ring + [0, y1, 0], [[cx, y0, cz], [cx, y1, cz]]])
    f = []
    for i in range(sides):
        j = (i + 1) % sides
        f += [(i, j, sides + i), (j, sides + j, sides + i), (2 * sides, j, i),
              (2 * sides + 1, sides + i, sides + j)]
    return v.astype(np.float32), np.array(f, np.int32)


def p_surface_samples(n: int, rng) -> np.ndarray:
    """``n`` points on the three objects' true surfaces (the box's faces,
    the sphere, the cylinder's side and caps), each surface drawn in
    proportion to its area."""
    (x0, y0, z0), (x1, y1, z1) = O_BOX
    dx, dy, dz = x1 - x0, y1 - y0, z1 - z0
    (sc, sr), ((ccx, ccz), cr, (cy0, cy1)) = O_SPHERE, O_CYLINDER
    areas = np.array([2 * dy * dz, 2 * dx * dz, 2 * dx * dy, 4 * np.pi * sr ** 2,
                      2 * np.pi * cr * (cy1 - cy0), 2 * np.pi * cr ** 2])
    k = rng.choice(6, size=n, p=areas / areas.sum())
    u, w = rng.random(n), rng.random(n)
    side = rng.integers(0, 2, n)
    out = np.zeros((n, 3))
    lo, hi = np.array(O_BOX[0]), np.array(O_BOX[1])
    for axis in range(3):
        on = k == axis
        a, b = [i for i in range(3) if i != axis]
        out[on, axis] = np.where(side[on] == 1, hi[axis], lo[axis])
        out[on, a] = lo[a] + u[on] * (hi[a] - lo[a])
        out[on, b] = lo[b] + w[on] * (hi[b] - lo[b])
    on = k == 3
    d = rng.normal(size=(on.sum(), 3))
    out[on] = sc + sr * d / np.linalg.norm(d, axis=1, keepdims=True)
    on = k == 4
    out[on] = np.stack([ccx + cr * np.cos(2 * np.pi * u[on]), cy0 + w[on] * (cy1 - cy0),
                        ccz + cr * np.sin(2 * np.pi * u[on])], 1)
    on = k == 5
    rr, th = cr * np.sqrt(u[on]), 2 * np.pi * w[on]
    out[on] = np.stack([ccx + rr * np.cos(th), np.where(side[on] == 1, cy1, cy0),
                        ccz + rr * np.sin(th)], 1)
    return out.astype(np.float32)


def p_clean_sheet(tris: np.ndarray, V: int):
    """The organized mesh's triangles less those at vertices where two
    boundary fans meet (a vertex that starts two boundary half-edges: the
    half-edge builder then chains the holes ambiguously and its boundary
    walk need not end, ROADMAP C94), removed in rounds until none is left.
    Returns ``(kept triangles, rounds)``."""
    tris = np.asarray(tris, np.int64)
    for rounds in range(64):
        e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
        key = e[:, 0] * V + e[:, 1]
        twin = np.isin(e[:, 1] * V + e[:, 0], key)
        # boundary half-edges run dst -> src of a half-edge without twin
        starts = np.bincount(e[~twin, 1], minlength=V)
        bad = starts > 1
        if not bad.any():
            return tris.astype(np.int32), rounds
        tris = tris[~bad[tris].any(1)]
    raise RuntimeError("p_clean_sheet did not settle")


def path_p_inputs(P):
    """Path P's host inputs: path O's frame 0 (the Kinect's noisy depth and
    RGB, its points, the true classes and the clean depth), the rectified
    grey pair (seed ``P_SEED``) with the left camera's true disparity, the
    three objects' meshes and ``P["surface_samples"]`` points on their true
    surfaces."""
    from pcl_tpu_torch.fusion import Intrinsics

    intr = Intrinsics(*P["intr"])
    H, W = P["shape"]
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    k = o_render(0.0, intr, u, v, np.random.default_rng(O_SEED))
    xyz = np.stack([(u - intr.cx) / intr.fx * k["depth"], (v - intr.cy) / intr.fy * k["depth"],
                    k["depth"]], -1).astype(np.float32)
    rng = np.random.default_rng(P_SEED)
    R_o = _o_rotation()
    T = p_left_in_kinect()
    R_l, c_l = R_o @ T[:3, :3], R_o @ T[:3, 3]
    c_r = c_l + R_l @ np.array([P_BASELINE, 0.0, 0.0])
    left = o_render(0.0, intr, u, v, rng, cam=(R_l, c_l))
    right = o_render(0.0, intr, u, v, rng, cam=(R_l, c_r))
    grey = [(255.0 * r["rgb"].mean(-1)).astype(np.float32) for r in (left, right)]
    zl = left["xyz"][..., 2]
    truth = np.where(zl > 0, intr.fx * P_BASELINE / np.where(zl > 0, zl, 1.0), -1.0)
    meshes = {"box": p_box_mesh(), "sphere": p_sphere_mesh(P["ico_levels"]),
              "cylinder": p_cylinder_mesh(P["cyl_sides"])}
    return dict(intr=intr, xyz=xyz, valid=k["depth"] > 0, depth=k["depth"], rgb=k["rgb"],
                grey=(255.0 * k["rgb"].mean(-1)).astype(np.float32), cls=k["cls"],
                clean_z=k["xyz"][..., 2], left=grey[0], right=grey[1], disparity=truth,
                meshes=meshes, surface=p_surface_samples(P["surface_samples"], rng))


class PortP:
    """Path P's calls on the port, on ``dev``: numpy in, numpy out, each
    through the entry point a user calls. ``tests/rehearse_path_p.py`` has
    the JAX package's ``JaxP`` with the same methods."""

    def __init__(self, dev):
        import pcl_tpu_torch.geometry as geometry
        from pcl_tpu_torch.io import formats_extra, png, tiff

        self.dev = torch.device(dev)
        self.geometry, self.png, self.tiff, self.formats = geometry, png, tiff, formats_extra

    def _t(self, a):
        return torch.as_tensor(np.asarray(a), device=self.dev)

    def block_matching(self, left, right, D):
        from pcl_tpu_torch import stereo

        return stereo.block_matching(self._t(left), self._t(right), max_disparity=D).cpu().numpy()

    def adaptive(self, left, right, D):
        from pcl_tpu_torch import stereo

        return stereo.adaptive_cost_so_matching(self._t(left), self._t(right),
                                                max_disparity=D).cpu().numpy()

    def disparity_to_cloud(self, disp, f, b, u0, v0):
        from pcl_tpu_torch import stereo

        c = stereo.disparity_to_cloud(self._t(disp), f, b, u0, v0)
        return c.xyz.cpu().numpy(), c.mask.cpu().numpy()

    def dem(self, disp, grey, f, b, cx, cy):
        from pcl_tpu_torch import stereo

        h, n = stereo.disparity_to_dem(self._t(disp), self._t(grey), f, b, cx, cy)
        return h.cpu().numpy(), n.cpu().numpy()

    def voxel(self, xyz, leaf):
        from pcl_tpu_torch import filters
        from pcl_tpu_torch.core.cloud import make_cloud

        return live_rows(filters.voxel_downsample(make_cloud(xyz, device=self.dev),
                                                  leaf)).xyz.cpu().numpy()

    def icp(self, src, tgt, **kw):
        from pcl_tpu_torch.core.cloud import make_cloud
        from pcl_tpu_torch.registration.icp import icp

        r = icp(make_cloud(src, device=self.dev), make_cloud(tgt, device=self.dev),
                corr_backend="brute", **kw)
        return r.transform.cpu().numpy(), bool(r.converged), int(r.iterations)

    def normals(self, xyz, valid):
        from pcl_tpu_torch import features

        n, c = features.integral_image_normals(self._t(xyz), self._t(valid), mode="gradient")
        return n.cpu().numpy(), c.cpu().numpy()

    def organized(self, xyz, valid, attrs):
        from pcl_tpu_torch.core.cloud import make_cloud

        H, W = valid.shape
        return make_cloud(xyz.reshape(-1, 3), valid.reshape(-1),
                          {k: a.reshape((H * W,) + a.shape[2:]) for k, a in attrs.items()},
                          width=W, height=H, device=self.dev)

    def edges(self, cloud):
        from pcl_tpu_torch import features

        labels = features.organized_edge_detection(cloud, edge_types=31).cpu().numpy()
        return labels, features.edge_label_indices(labels)

    def extract(self, name, cloud, **kw):
        from pcl_tpu_torch import image

        return getattr(image, name)(cloud, **kw)

    def save_cloud(self, path, cloud):
        from pcl_tpu_torch import io

        io.save(path, cloud)

    def tool(self, name, argv):
        import importlib

        with contextlib.redirect_stdout(pyio.StringIO()):
            return importlib.import_module(f"pcl_tpu_torch.tools.{name}").main(
                list(argv) + ["--device", self.dev.type])

    def load_cloud(self, path):
        """``(xyz [N, 3], mask)`` of a file, organized rows kept."""
        from pcl_tpu_torch import io

        c = io.load(path, device=self.dev)
        return c.xyz.cpu().numpy(), c.mask.cpu().numpy()

    def model(self, xyz):
        from pcl_tpu_torch.core.cloud import make_cloud

        return make_cloud(xyz, device=self.dev)

    def render(self, model, pose, intr, H, W):
        from pcl_tpu_torch import simulation

        return simulation.render_depth(model, self._t(pose.astype(np.float32)), intr, H, W)

    def likelihood(self, rendered, observed):
        from pcl_tpu_torch import simulation

        return float(simulation.range_likelihood(rendered, self._t(observed)))

    def fast_mesh(self, cloud):
        from pcl_tpu_torch import surface

        return surface.organized_fast_mesh(cloud)

    def save_mesh_ply(self, path, verts, tris):
        from pcl_tpu_torch import io
        from pcl_tpu_torch.core.cloud import make_cloud

        io.save_ply(path, make_cloud(verts, device=self.dev), faces=tris)

    def nn1(self, queries, targets):
        from pcl_tpu_torch.search import bruteforce

        t = self._t(targets)
        idx, d2 = bruteforce.nn1(t, torch.ones(len(t), dtype=torch.bool, device=self.dev),
                                 self._t(queries))
        return idx.cpu().numpy(), d2.cpu().numpy()


def p_grid_poses(steps):
    """(d)'s 125 candidate poses (camera to Kinect): x and z steps of
    ``steps[0]``, ``steps[1]`` m and yaw steps of ``steps[2]`` deg, five
    each about the true pose (the identity), the true pose at index 62."""
    out = []
    for i in range(-2, 3):
        for j in range(-2, 3):
            for k in range(-2, 3):
                T = np.eye(4)
                T[:3, :3] = _p_rot_y(k * steps[2])
                T[:3, 3] = (i * steps[0], 0.0, j * steps[1])
                out.append(T)
    return out


def path_p_chain(inp, P, dev, lib=None, on_stage=None, normals=None):
    """Path P's main path on ``lib`` (the port's ``PortP`` on ``dev`` by
    default): (a) stereo, (b) the stereo cloud into the Kinect's frame by
    ICP (B2 twice, B1 once an iteration), (c) organized edges, image
    extractors and the image CLIs, (d) range likelihood over 125 candidate
    poses, (e) half-edge meshes, the mesh and format CLIs, scans and their
    surface error (B2, B1). ``normals`` (``(normals, curvature)``) replaces
    (c)'s integral-image normals, so that a test can give both packages the
    same ones (ROADMAP C26). Returns ``(out, seconds)``."""
    dev = torch.device(dev)
    lib = PortP(dev) if lib is None else lib
    out, secs = {}, {}

    def run(name, fn):
        if on_stage is not None:
            on_stage(name)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0
        return r

    intr = inp["intr"]
    H, W = P["shape"]
    f, D = intr.fx, P["max_disparity"]
    # (a) stereo
    out["bm"] = run("(a) block_matching", lambda: lib.block_matching(inp["left"], inp["right"], D))
    out["ad"] = run("(a) adaptive_cost_so_matching", lambda: lib.adaptive(
        inp["left"], inp["right"], D))
    sxyz, smask = run("(a) disparity_to_cloud", lambda: lib.disparity_to_cloud(
        out["bm"], f, P_BASELINE, intr.cx, intr.cy))
    out["dem"] = run("(a) disparity_to_dem", lambda: lib.dem(out["bm"], inp["left"], f,
                                                             P_BASELINE, intr.cx, intr.cy))
    out["stereo_xyz"] = sxyz[smask]
    # (b) the stereo cloud into the Kinect's frame
    out["vox_stereo"] = run("(b) voxel grid (stereo)", lambda: lib.voxel(out["stereo_xyz"],
                                                                         P["leaf"]))
    out["vox_kinect"] = run("(b) voxel grid (Kinect)", lambda: lib.voxel(
        inp["xyz"][inp["valid"]], P["leaf"]))
    out["icp"] = run("(b) icp", lambda: lib.icp(out["vox_stereo"], out["vox_kinect"], **P["icp"]))
    # (c) organized edges, the extractors and the image CLIs
    nrm, curv = normals or run("(c) integral_image_normals",
                               lambda: lib.normals(inp["xyz"], inp["valid"]))
    out["normals"] = (nrm, curv)
    attrs = dict(rgb=inp["rgb"], normal=nrm, curvature=curv, intensity=inp["grey"],
                 label=inp["cls"].astype(np.int32))
    cloud = lib.organized(inp["xyz"], inp["valid"], attrs)
    out["labels"], out["label_idx"] = run("(c) organized_edge_detection",
                                          lambda: lib.edges(cloud))
    kinds = [("extract_normal_image", {}), ("extract_rgb_image", {}),
             ("extract_label_image", {"color_mode": "mono"}),
             ("extract_label_image", {"color_mode": "rgb_random"}),
             ("extract_label_image", {"color_mode": "rgb_glasbey"}), ("extract_z_image", {}),
             ("extract_curvature_image", {}), ("extract_intensity_image", {}),
             ("bearing_angle_image", {})]
    images = {f"{n}{kw.get('color_mode', '')}": run(f"(c) {n}", lambda n=n, kw=kw: lib.extract(
        n, cloud, **kw)) for n, kw in kinds}
    out["images"] = images
    with tempfile.TemporaryDirectory() as tmp:
        back = {}
        for name, img in images.items():
            p_png = os.path.join(tmp, name + ".png")
            run("(c) PNG round trip", lambda: lib.png.save_png(p_png, img))
            back[name + ".png"] = run("(c) PNG round trip", lambda: lib.png.load_png(p_png))
            if img.dtype == np.uint16:
                p_tif = os.path.join(tmp, name + ".tif")
                run("(c) TIFF round trip", lambda: lib.tiff.save_tiff(p_tif, img))
                back[name + ".tif"] = run("(c) TIFF round trip", lambda: lib.tiff.load_tiff(p_tif))
        out["images_back"] = {k: bool(np.array_equal(v, images[k.rsplit(".", 1)[0]]))
                              for k, v in back.items()}
        pcd = os.path.join(tmp, "frame0.pcd")
        lib.save_cloud(pcd, cloud)
        for field in ("z", "rgb"):
            run("(c) tools.pcd2png", lambda: lib.tool("pcd2png", [
                pcd, os.path.join(tmp, f"cli_{field}.png"), "-field", field]))
        out["cli_png_z"] = lib.png.load_png(os.path.join(tmp, "cli_z.png"))
        out["cli_png_rgb"] = lib.png.load_png(os.path.join(tmp, "cli_rgb.png"))
        run("(c) tools.png2pcd", lambda: lib.tool("png2pcd", [
            os.path.join(tmp, "cli_z.png"), os.path.join(tmp, "png.pcd"), "-fx", str(intr.fx),
            "-fy", str(intr.fy), "-cx", str(intr.cx), "-cy", str(intr.cy)]))
        out["png2pcd"] = lib.load_cloud(os.path.join(tmp, "png.pcd"))
        for sub, name in (("depth", "extract_z_image"), ("rgb", "extract_rgb_image")):
            os.makedirs(os.path.join(tmp, sub))
            lib.tiff.save_tiff(os.path.join(tmp, sub, "f0.tif"), images[name])
        run("(c) tools.tiff2pcd", lambda: lib.tool("tiff2pcd", [
            os.path.join(tmp, "depth"), os.path.join(tmp, "tiff_out"), "-rgb_dir",
            os.path.join(tmp, "rgb"), "-focal", str(intr.fx), "-scale", "10000"]))
        out["tiff2pcd"] = lib.load_cloud(os.path.join(tmp, "tiff_out", "frame_000000.pcd"))
    # (d) range likelihood over 125 candidate poses
    model = lib.model(inp["xyz"][inp["valid"]])
    ll = []
    for T in p_grid_poses(P["steps"]):
        r = run("(d) render_depth", lambda: lib.render(model, T, intr, H, W))
        ll.append(run("(d) range_likelihood", lambda: lib.likelihood(r, inp["depth"])))
    out["ll"] = np.array(ll)
    # (e) half-edge meshes, the mesh and format CLIs, scans
    geo = lib.geometry
    sheet_v, sheet_t = run("(e) organized_fast_mesh", lambda: lib.fast_mesh(cloud))
    kept, rounds = run("(e) clean sheet (numpy)", lambda: p_clean_sheet(sheet_t, len(sheet_v)))
    meshes = dict(inp["meshes"], sheet=(np.asarray(sheet_v, np.float32), kept))
    out["sheet_faces"], out["sheet_rounds"] = (len(sheet_t), len(kept)), rounds
    out["sheet_tris"] = kept
    he = {}
    for name, (v, t) in meshes.items():
        m = run("(e) build_halfedge_mesh", lambda: geo.build_halfedge_mesh(v, t))
        loops = run("(e) boundary_loops", lambda: geo.boundary_loops(m))
        sample = np.unique(t[:: max(1, len(t) // 500)].reshape(-1))
        rings = run("(e) vertex_one_ring", lambda: [geo.vertex_one_ring(m, int(i)) for i in sample])
        fv = geo.to_face_vertex(m)
        he[name] = dict(euler=int(geo.euler_characteristic(m)),
                        manifold=bool(run("(e) is_manifold", lambda: geo.is_manifold(m))),
                        loops=[np.asarray(x) for x in loops], ring_vertices=sample,
                        rings=[np.asarray(x) for x in rings], faces_back=bool(
                            np.array_equal(fv[1], t) and np.array_equal(fv[0], v)),
                        n=(m.n_vertices, m.n_edges, m.n_faces), he_next=m.he_next)
    out["he"] = he
    with tempfile.TemporaryDirectory() as tmp:
        trips = {}
        for name in P_OBJECTS:
            v, t = inp["meshes"][name]
            ply = os.path.join(tmp, f"{name}.ply")
            obj = os.path.join(tmp, f"{name}.obj")
            lib.save_mesh_ply(ply, v, t)
            run("(e) tools.ply2obj", lambda: lib.tool("ply2obj", [ply, obj]))
            for tool, src, dst in (("obj2pcd", obj, f"{name}.pcd"), ("convert", obj, f"{name}_c.pcd"),
                                   ("obj2vtk", obj, f"{name}.vtk"),
                                   ("vtk2ply", f"{name}.vtk", f"{name}_v.ply"),
                                   ("convert", ply, f"{name}.ifs")):
                run(f"(e) tools.{tool}", lambda: lib.tool(tool, [os.path.join(tmp, src),
                                                                os.path.join(tmp, dst)]))
                trips[f"{tool} {dst}"] = lib.load_cloud(os.path.join(tmp, dst))[0]
            ifs = os.path.join(tmp, f"{name}_mesh.ifs")
            lib.formats.save_ifs(ifs, v, t)
            iv, it = lib.formats.load_ifs(ifs)
            trips[f"ifs {name}"] = (iv, it)
            run("(e) tools.mesh_sampling", lambda: lib.tool("mesh_sampling", [
                obj, os.path.join(tmp, f"{name}_s.pcd"), *P["sampling"]]))
            run("(e) tools.mesh2pcd", lambda: lib.tool("mesh2pcd", [
                obj, os.path.join(tmp, f"{name}_m.pcd"), *P["mesh2pcd"]]))
            run("(e) tools.virtual_scanner", lambda: lib.tool("virtual_scanner", [
                obj, os.path.join(tmp, f"{name}_vs.pcd"), *P["scanner"]]))
            for k in ("s", "m", "vs"):
                trips[f"{k} {name}"] = lib.load_cloud(os.path.join(tmp, f"{name}_{k}.pcd"))[0]
        out["trips"] = trips
    scans = np.concatenate([out["trips"][f"m {n}"] for n in P_OBJECTS])
    out["scan_vox"] = run("(e) voxel grid (scans)", lambda: lib.voxel(scans, P["scan_leaf"]))
    out["scan_nn"] = run("(e) nn1 to the surfaces", lambda: lib.nn1(out["scan_vox"],
                                                                    inp["surface"]))
    return out, secs


def p_silhouettes(z: np.ndarray, th: float = 0.02) -> np.ndarray:
    """The clean depth's discontinuities: pixels with a valid 8-neighbour
    whose depth differs by more than ``th`` times theirs (the edge
    detector's test)."""
    H, W = z.shape
    ok = z > 0
    out = np.zeros((H, W), bool)
    pad = np.pad(z, 1)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx or dy:
                nz = pad[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                out |= ok & (nz > 0) & (np.abs(z - nz) > th * z)
    return out


def _p_dilate(m: np.ndarray) -> np.ndarray:
    pad = np.pad(m, 1)
    H, W = m.shape
    return np.any([pad[1 + dy:1 + dy + H, 1 + dx:1 + dx + W] for dy in (-1, 0, 1)
                   for dx in (-1, 0, 1)], 0)


def path_p_metrics(inp, out, P) -> dict:
    """Path P's measures: the matchers' shares within 1 px of the true
    disparity and left invalid, ICP's error against the rig's offset, the
    edges against the clean silhouettes, the round trips, the likelihood's
    winner and margin, the half-edge checks and the scans' surface error."""
    H, W = P["shape"]
    m = {}
    truth = inp["disparity"]
    has = truth > 0
    for key in ("bm", "ad"):
        d = out[key]
        ok = has & (d >= 0)
        m[f"{key}_within1"] = float(np.mean(np.abs(d[ok] - truth[ok]) <= 1.0)) if ok.any() else 0.0
        m[f"{key}_invalid"] = float(np.mean(d[has] < 0))
    m["stereo_points"] = len(out["stereo_xyz"])
    m["dem_cells"] = int((out["dem"][1] > 0).sum())
    m["voxels"] = [len(out["vox_stereo"]), len(out["vox_kinect"])]
    T, conv, iters = out["icp"]
    t_err, r_err = residual_motion(torch.as_tensor(np.array(T)), np.linalg.inv(p_left_in_kinect()))
    m.update(icp_t_err=t_err, icp_r_err=r_err, icp_converged=conv, icp_iterations=iters)
    lab = out["labels"].reshape(H, W)
    occ = (lab & 6) > 0
    sil = p_silhouettes(inp["clean_z"])
    m["edge_recall"] = float(np.mean(_p_dilate(occ)[sil])) if sil.any() else 0.0
    m["edge_false"] = float(np.mean(~_p_dilate(sil)[occ])) if occ.any() else 0.0
    m["edge_counts"] = [int(((lab >> t) & 1).sum()) for t in range(5)]
    m["label_idx_ok"] = all(np.array_equal(ix, np.flatnonzero((out["labels"] >> t) & 1))
                            for t, ix in enumerate(out["label_idx"]))
    m["images_back"] = all(out["images_back"].values()) and len(out["images_back"]) == 13
    # the CLIs: the depth PNG in mm back through png2pcd, the 0.1 mm TIFF (which
    # clips at 6.5535 m) through tiff2pcd; an organized PCD holds its invalid
    # pixels as zeros, so a pixel is valid where its depth is above 0
    z = inp["xyz"][..., 2].reshape(-1)
    for key, top in (("png2pcd", 65.0), ("tiff2pcd", 6.5)):
        xyz, mask = out[key]
        ok = inp["valid"].reshape(-1) & (z < top)
        m[f"{key}_z_err"] = float(np.abs(xyz[ok, 2] - z[ok]).max())
        m[f"{key}_same_mask"] = bool(np.array_equal(mask & (xyz[:, 2] > 0),
                                                    inp["valid"].reshape(-1)))
    m["cli_png_z"] = bool(np.array_equal(out["cli_png_z"].reshape(-1), np.clip(
        z * 1000.0, 0, 65535).astype(np.uint16)))
    ll = out["ll"]
    order = np.argsort(-ll, kind="stable")
    m.update(ll_best=int(order[0]), ll_margin=float(ll[order[0]] - ll[order[1]]),
             ll_runner_up=int(order[1]))
    checks = {}
    for name, h in out["he"].items():
        t = out["sheet_tris"] if name == "sheet" else inp["meshes"][name][1]
        e = np.sort(np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]]), 1)
        _, cnt = np.unique(e, axis=0, return_counts=True)
        deg = np.bincount(np.unique(e, axis=0).reshape(-1), minlength=h["n"][0])
        checks[name] = dict(euler=h["euler"], manifold=h["manifold"], loops=len(h["loops"]),
                            loop_edges=int(sum(len(x) for x in h["loops"])),
                            boundary_edges=int((cnt == 1).sum()), faces_back=h["faces_back"],
                            rings=bool(all(len(r) == deg[i] for i, r in zip(h["ring_vertices"],
                                                                            h["rings"]))),
                            n=list(h["n"]))
    m["he"] = checks
    m["sheet_faces"], m["sheet_rounds"] = list(out["sheet_faces"]), out["sheet_rounds"]
    trips_ok = {}
    for name in P_OBJECTS:
        v, t = inp["meshes"][name]
        for key, got in out["trips"].items():
            tool = key.split()[0]
            if tool in ("obj2pcd", "convert", "obj2vtk", "vtk2ply") and name in key:
                # OBJ and VTK text hold 6 significant digits
                trips_ok[key] = bool(got.shape == v.shape and np.allclose(
                    got, v, rtol=0, atol=1e-5 * float(np.abs(v).max())))
        iv, it = out["trips"][f"ifs {name}"]
        trips_ok[f"ifs {name}"] = bool(np.array_equal(iv, v) and np.array_equal(it, t))
    m["trips"] = trips_ok
    m["samples"] = {k: len(x) for k, x in out["trips"].items() if k.split()[0] in ("s", "m", "vs")}
    d = np.sqrt(np.maximum(out["scan_nn"][1], 0.0))
    m["scan_voxels"] = len(d)
    m["scan_p99"] = float(np.percentile(d, 99)) if len(d) else math.inf
    m["scan_median"] = float(np.median(d)) if len(d) else math.inf
    return m


P_PLAIN_ROWS = 1 << 15      # B1's plain version on the first rows of a call
# limits: 1.5 x the JAX package's CPU rehearsal at full width (tests/rehearse_path_p.py jax,
# on this frame and pair): errors as 1.5 x the rehearsal's, shares as 1.5 x their shortfall.
# The rehearsal read block matching 0.37579 within 1 px and 0.55458 invalid, the adaptive
# matcher 0.67937 and 0.091784, ICP 0.16890 m and 2.0759 deg off the rig's offset (integer
# disparities do not register to the 0.05 m offset, ROADMAP C95), silhouette recall 1.0 with
# 0.92311 of the occluding/occluded labels off every silhouette (range noise against the
# 2% threshold; 1.5 x that share exceeds 1, so it is printed, not checked), the scans' p99
# surface error 0.0043673 m
P_LIMITS = dict(bm_within1=0.06368, bm_invalid=0.8319, ad_within1=0.5190, ad_invalid=0.1377,
                icp_t_err=0.2534, icp_r_err=3.114, edge_recall=1.0, edge_false=None,
                scan_p99=0.006551)


def p_checks(m, lim, expect):
    """Path P's checks: the exact ones always, the measured ones against
    ``lim`` (a limit of None is printed, not checked)."""
    printed = []

    def hold(ok, limit, what):
        if limit is None:
            printed.append(what)
        else:
            expect(ok, what)

    for key in ("bm", "ad"):
        L = lim[f"{key}_within1"]
        hold(L is not None and m[f"{key}_within1"] >= L, L,
             f"(a) {key}: {m[f'{key}_within1']:.5f} of the valid pixels within 1 px of the true "
             f"disparity (limit {L})")
        L = lim[f"{key}_invalid"]
        hold(L is not None and m[f"{key}_invalid"] <= L, L,
             f"(a) {key}: {m[f'{key}_invalid']:.5f} of the pixels left invalid (limit {L})")
    expect(m["dem_cells"] > 0, "(a) the DEM holds no cell")
    expect(m["icp_converged"], f"(b) ICP did not converge in {m['icp_iterations']} iterations")
    for key, unit in (("icp_t_err", "m"), ("icp_r_err", "deg")):
        L = lim[key]
        hold(L is not None and m[key] <= L, L,
             f"(b) ICP's {key[4]} error against the rig's offset {m[key]:.5f} {unit} (limit {L})")
    L = lim["edge_recall"]
    hold(L is not None and m["edge_recall"] >= L, L,
         f"(c) {m['edge_recall']:.5f} of the true silhouette pixels labelled occluding or "
         f"occluded within 1 px (limit {L})")
    L = lim["edge_false"]
    hold(L is not None and m["edge_false"] <= L, L,
         f"(c) {m['edge_false']:.5f} of the occluding/occluded pixels off every silhouette "
         f"(limit {L})")
    expect(m["label_idx_ok"], "(c) edge_label_indices differ from the labels")
    expect(m["images_back"], "(c) an extractor's image does not read back bit for bit")
    expect(m["cli_png_z"], "(c) tools.pcd2png's depth PNG is not the depth in mm")
    expect(m["png2pcd_same_mask"] and m["png2pcd_z_err"] <= 0.001,
           f"(c) tools.png2pcd: depth off by {m['png2pcd_z_err']} m (the PNG holds mm)")
    expect(m["tiff2pcd_same_mask"] and m["tiff2pcd_z_err"] <= 0.0001,
           f"(c) tools.tiff2pcd: depth off by {m['tiff2pcd_z_err']} m (the TIFF holds 0.1 mm)")
    expect(m["ll_best"] == 62, f"(d) the likelihood's best pose is candidate {m['ll_best']}, "
                               f"not the true pose (62)")
    for name, c in m["he"].items():
        closed = name != "sheet"
        expect(c["faces_back"] and c["rings"] and c["manifold"]
               and c["loop_edges"] == c["boundary_edges"]
               and (not closed or (c["euler"] == 2 and c["loops"] == 0)),
               f"(e) half-edge mesh of the {name}: {c}")
    expect(all(m["trips"].values()), f"(e) round trips: {m['trips']}")
    L = lim["scan_p99"]
    hold(L is not None and m["scan_p99"] <= L, L,
         f"(e) the scans' p99 surface error {m['scan_p99']:.5f} m (limit {L})")
    return printed


def p_card_vs_cpu(expect, card=None):
    """Path P's chain on the card against the port's CPU run at 80 x 60.
    Returns lines to print."""
    card = torch.device("cuda") if card is None else card
    P = P_SMALL
    small = path_p_inputs(P)
    a, b = (path_p_chain(small, P, d)[0] for d in (card, torch.device("cpu")))
    lines = []
    same = {k: float(np.mean(a[k] == b[k])) for k in ("bm", "ad")}
    dem_same = bool(np.array_equal(a["dem"][1], b["dem"][1]))
    dem_gap = float(np.abs(a["dem"][0] - b["dem"][0]).max())
    expect(min(same.values()) >= 0.99 and dem_same and dem_gap <= 1e-5,
           f"(card vs CPU) (a) disparities equal on {same}, DEM counts equal {dem_same}, "
           f"heights by {dem_gap}")
    tgap = float(np.abs(a["icp"][0] - b["icp"][0]).max())
    expect(tgap <= 1e-4 and len(a["vox_stereo"]) == len(b["vox_stereo"]),
           f"(card vs CPU) (b) ICP by {tgap}, voxels {len(a['vox_stereo'])} / "
           f"{len(b['vox_stereo'])}")
    lab = float(np.mean(a["labels"] == b["labels"]))
    img = {k: int(np.abs(a["images"][k].astype(int) - b["images"][k].astype(int)).max())
           for k in a["images"]}
    expect(lab >= 0.99 and max(img.values()) <= 1 and all(
        v == 0 for k, v in img.items() if "normal" not in k and "bearing" not in k),
           f"(card vs CPU) (c) labels equal on {lab:.4f}, images apart by {img}")
    scale = float(np.abs(b["ll"]).max())
    lgap = float(np.abs(a["ll"] - b["ll"]).max())
    expect(lgap <= 1e-5 * scale and int(np.argmax(a["ll"])) == int(np.argmax(b["ll"])),
           f"(card vs CPU) (d) likelihoods by {lgap} of {scale}, best {int(np.argmax(a['ll']))} / "
           f"{int(np.argmax(b['ll']))}")
    he_same = all(np.array_equal(a["he"][k]["he_next"], b["he"][k]["he_next"]) for k in b["he"])
    n_scan = [len(a["scan_vox"]), len(b["scan_vox"])]
    expect(he_same and abs(n_scan[0] - n_scan[1]) <= 0.02 * n_scan[1],
           f"(card vs CPU) (e) half-edge meshes equal {he_same}, scan voxels {n_scan}")
    lines.append(f"80 x 60 chain: disparities equal {same}, ICP {tgap:.1e}, labels {lab:.4f}, "
                 f"images within {max(img.values())}, likelihood {lgap:.1e}, half-edge equal "
                 f"{he_same}, scan voxels {n_scan}")
    return lines


def phase18_path_p(segsum, nn1_mod, record_b1, record_b2):
    """Path P: PCL's stereo, organized-edge, image-extractor, range-likelihood
    and mesh-conversion tools on path O's room at frame 0, at VGA."""
    from pcl_tpu_torch.search import bruteforce

    failed = []

    def expect(cond: bool, what: str) -> None:
        if not cond:
            print(f"phase 18: CHECK FAILED: {what}", flush=True)
            failed.append(what)

    dev = torch.device("cuda")
    P = P_FULL
    inp, isecs = timed(lambda: path_p_inputs(P))
    print(f"phase 18: inputs in {isecs:.1f} s: {int(inp['valid'].sum())} valid Kinect pixels, "
          f"{int((inp['disparity'] > 0).sum())} pixels of true disparity "
          f"{inp['disparity'][inp['disparity'] > 0].min():.2f}-"
          f"{inp['disparity'].max():.2f} px, meshes "
          + ", ".join(f"{k} {len(v[1])} faces" for k, v in inp["meshes"].items()), flush=True)
    _, wsecs = timed(lambda: path_p_chain(path_p_inputs(P_SMALL), P_SMALL, dev))
    print(f"phase 18: warm-up at 80 x 60 in {wsecs:.1f} s", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trace.reset()
    with kernel_calls(bruteforce, segsum) as calls:
        (out, secs), total = timed(lambda: path_p_chain(
            inp, P, dev, on_stage=lambda n: calls.__setitem__("stage", n)))
    b1, b2 = launch_count("nn1"), launch_count("segsum")
    record_b1["launches_by_path"]["P"] = b1
    record_b2["launches_by_path"]["P"] = b2
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    card = card_line()
    print(f"phase 18: path P in {total:.1f} s, peak memory {peak:.2f} GiB, launches nn1 {b1}, "
          f"segsum {b2} [{card}]", flush=True)
    for name, v in secs.items():
        print(f"phase 18: {name}: {v * 1e3:.1f} ms [{card}]", flush=True)
    parts = {p: sum(v for k, v in secs.items() if k.startswith(p))
             for p in ("(a)", "(b)", "(c)", "(d)", "(e)")}
    print("phase 18: by part " + ", ".join(f"{p} {v:.2f} s" for p, v in parts.items())
          + f" [{card}]", flush=True)
    iters = out["icp"][2]
    expect(b2 == 3 and b1 == iters + 1,
           f"path P launched B2 {b2} times (the stereo, Kinect and scan voxel grids: 3) and B1 "
           f"{b1} times (ICP once an iteration, {iters}, and the scans' 1-NN once: {iters + 1})")
    expect(len(calls["nn1"]) == b1 and len(calls["segsum"]) == b2,
           "the kept kernel calls do not match the launch counts")
    m = path_p_metrics(inp, out, P)
    print("phase 18: metrics " + json.dumps(m, default=float), flush=True)
    for what in p_checks(m, P_LIMITS, expect):
        print(f"phase 18: printed, not checked: {what}", flush=True)
    lines, csecs = timed(lambda: p_card_vs_cpu(expect))
    print(f"phase 18: card against CPU ({csecs:.1f} s): " + "; ".join(lines), flush=True)
    rows1, rows2 = hold_to_plain(calls, nn1_mod, segsum, expect, "phase 18:", P_PLAIN_ROWS, card,
                                 time_once="stage")
    record_b1["path_p"] = rows1
    record_b2["path_p"] = rows2
    check(not failed, "path P: " + "; ".join(failed))
    return {"total_s": total, "peak_gib": peak, "parts": parts, "metrics": m}


# ---------------------------------------------------------------------------
# path Q: an HDL-32E drive through path C's street, replayed from a pcap into
# the front end, stored out of core, compressed and shown
Q_SEED = 16                 # the drive's yaws, range noise and intensities, the depth frames' noise
Q_SENSOR_H = 1.9            # m: the Velodyne above the ground
Q_RANGE_NOISE = 0.02        # m: path C's range noise (sd)
# the street's frame (y up, z along the street) to path Q's world (x across, y along
# the street, z up): a rotation, so that the sensors' frames are right-handed with z up
Q_M = np.array([[-1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, 1.0, 0.0]])
Q_FULL = dict(
    # (a): the captures, model -> (sweeps, blocks a revolution). HDL-32E at 10 Hz: a
    # block every 0.16 deg, 72,000 rays a revolution (~695,000 points/s); VLP-16: a
    # block every 0.4 deg, two firings of 16 lasers at the block's azimuth (the
    # decoder's simplification), 28,800 rays
    captures={"HDL32E": (40, 2250), "VLP16": (10, 900)}, drive="HDL32E",
    start=60.0, step=1.0, yaw_deg=0.5,      # m along the street, m a sweep (36 km/h), sd deg
    max_range=100.0,                        # m: the sensors' data-sheet range
    # (d): the map's stores (PCL outofcore's defaults but the cell), the 0.2 m voxels and
    # the street's dense samples for the surface error
    # the flat store takes the drive four sweeps a call (each call rewrites every node
    # it touches with its LODs), the tree twenty
    ooc=dict(cell_size=0.5, split_depth=4, lod_levels=3), ooc_batch=4, hier_depth=6,
    hier_batch=20, map_leaf=LEAF,
    surface_points=SCENE_POINTS,
    # (e): octree compression at 1 cm; 30 VGA depth frames of path G's room from a fixed
    # camera, 5% dropouts, window 5; path H (i)'s planar scans as a TiM571 sends them
    comp_res=0.01, frames=30, shape=G_SHAPE, intr=G_INTR, window=5, dropout=0.05,
    tim_scans=H_PLANAR_SCANS,
    # (f): registration_visualizer's iterations and stages, the live viewer's voxels
    viewer=("-iters", "20", "-stages", "5"))
# 3 VLP-16 sweeps of a street cut to 10 m of range, 80 x 60 frames: the CPU tests
# (tests/test_torch_path_q.py) and the card against the CPU
Q_SMALL = dict(Q_FULL, captures={"VLP16": (3, 900)}, drive="VLP16", max_range=10.0,
               surface_points=20_000, frames=6, shape=(60, 80),
               intr=(65.625, 65.625, 39.5, 29.5), tim_scans=2,
               viewer=("-iters", "6", "-stages", "3"))
Q_TIM_BLOCKS = 811          # TiM571: 811 samples over 270 deg
Q_TIM_RANGE = 25.0          # m: the TiM571's range
Q_TIM_HEIGHT = 0.8          # m above the ground: inside path H (i)'s band
Q_TIM_HEADER = ("sRA LMDscandata 1 1 1291B11 0 0 AED5 AED7 FDB36397 FDB3779F 0 0 1 0 0 5DC "
                "A2 0 1 DIST1 3F800000 00000000 FFF92230 D05")
Q_BOX = ((-6.0, 10.0, -2.5), (6.0, 40.0, 4.0))          # m, in sweep 0's frame
# a wedge ahead of sweep 0: |x| <= 0.4 y, 5 <= y <= 60, z <= 3 (inward planes n.x + d >= 0)
Q_FRUSTUM = np.array([[1.0, 0.4, 0.0, 0.0], [-1.0, 0.4, 0.0, 0.0], [0.0, 1.0, 0.0, -5.0],
                      [0.0, -1.0, 0.0, 60.0], [0.0, 0.0, -1.0, 3.0]])


def q_sensor_poses(Q, n: int, rng) -> np.ndarray:
    """``n`` sensor-to-world poses of the drive: along the street's centre
    line from ``Q["start"]`` m, ``Q["step"]`` m apart, the sensor
    ``Q_SENSOR_H`` above the ground, each yawed by a seeded N(0,
    ``Q["yaw_deg"]``) deg."""
    out = []
    for k in range(n):
        a = math.radians(rng.normal(0.0, Q["yaw_deg"]))
        T = np.eye(4)
        T[:3, :3] = [[math.cos(a), -math.sin(a), 0], [math.sin(a), math.cos(a), 0], [0, 0, 1]]
        T[:3, 3] = (0.0, Q["start"] + Q["step"] * k, -1.7 + Q_SENSOR_H)
        out.append(T)
    return np.stack(out)


def q_render_sweep(model: str, blocks: int, T: np.ndarray, max_range: float, rng, dev):
    """One revolution of ``model`` at sensor pose ``T``: ``(distances [B, 32],
    intensities [B, 32], azimuths [B] deg)``, distance 0 where a ray hits
    nothing within ``max_range``, with ``Q_RANGE_NOISE`` on each range. The
    rays are the decoder's (``velodyne.decode_packet``): laser l of block b
    at azimuth ``360 b / blocks`` and the model's vertical angle."""
    from pcl_tpu_torch.io import velodyne

    az = np.arange(blocks) * (360.0 / blocks)
    vert = (velodyne.HDL32_VERT_ANGLES if model == "HDL32E"
            else np.tile(velodyne.VLP16_VERT_ANGLES, 2)).astype(np.float64)
    a, v = np.radians(az)[:, None], np.radians(vert)[None, :]
    d_s = np.stack(np.broadcast_arrays(np.cos(v) * np.sin(a), np.cos(v) * np.cos(a),
                                       np.sin(v)), -1).reshape(-1, 3)
    # sensor -> world -> the street's frame
    t, part = street_hits(Q_M.T @ T[:3, 3], d_s @ (Q_M.T @ T[:3, :3]).T, dev=dev)
    dist = t + rng.normal(0.0, Q_RANGE_NOISE, t.shape)
    dist = np.where(np.isfinite(t) & (t <= max_range) & (dist > 0), dist, 0.0)
    # intensity by surface: ground, facades, cars, poles
    inten = np.array([0, 20, 60, 120, 200])[part + 1] + rng.integers(0, 20, t.shape)
    return dist.reshape(blocks, 32), inten.reshape(blocks, 32), az


def q_capture(model: str, n_sweeps: int, blocks: int, poses: np.ndarray, max_range: float,
              rng, dev):
    """Packets of ``n_sweeps`` revolutions and each sweep's returns as the
    decoder yields them (sensor frame, float64, block-major, the 2 mm unit's
    non-zero distances). Each revolution starts a new packet; its last packet
    is padded with empty blocks (distance 0), which the decoder drops, since
    the grabber splits sweeps only between packets."""
    from pcl_tpu_torch.io import velodyne

    vert = np.radians((velodyne.HDL32_VERT_ANGLES if model == "HDL32E"
                       else np.tile(velodyne.VLP16_VERT_ANGLES, 2)).astype(np.float64))
    packets, returns, rays = [], [], 0
    for k in range(n_sweeps):
        dist, inten, az = q_render_sweep(model, blocks, poses[k], max_range, rng, dev)
        pad = -blocks % 12
        dist = np.concatenate([dist, np.zeros((pad, 32))])
        inten = np.concatenate([inten, np.zeros((pad, 32))])
        az = np.arange(blocks + pad) * (360.0 / blocks)
        # encode_packet rounds each distance with round(): Python floats (an
        # object array) take it some ten times faster than numpy scalars, to
        # the same bytes
        obj_d, obj_i = dist.astype(object), inten.astype(object)
        for p in range(len(az) // 12):
            sl = slice(12 * p, 12 * p + 12)
            packets.append(velodyne.encode_packet(az[sl], obj_d[sl], obj_i[sl]))
        keep = np.round(dist / 0.002) > 0
        a, v = np.radians(az)[:, None], vert[None, :]
        pts = np.stack(np.broadcast_arrays(dist * np.cos(v) * np.sin(a),
                                           dist * np.cos(v) * np.cos(a), dist * np.sin(v)), -1)
        returns.append(pts[keep])
        rays += blocks * 32
    return packets, returns, rays


def q_tim_log(n: int, dev):
    """Path H (i)'s planar scans of the street with alleys as a TiM571 sends
    them: scanner k at ``pose_matrix(H_PLANAR_STEP[0] k, H_PLANAR_STEP[1] k)``,
    ``Q_TIM_HEIGHT`` above the ground, 811 beams over 270 deg from -45 deg
    (the angles ``tim.parse_tim_packet`` gives them), each range rounded to
    the mm (0: no return within ``Q_TIM_RANGE``). Returns the STX/ETX-framed
    log and each scan's true returns ``[811, 3]`` (the scanner's frame: x
    ahead, y across, z 0; NaN where nothing returns)."""
    from pcl_tpu_torch.io import tim

    ang = (tim.ANGLE_START + np.arange(Q_TIM_BLOCKS) * (tim.ANGLE_RANGE / Q_TIM_BLOCKS)
           ).astype(np.float32).astype(np.float64)
    d_cam = np.stack([np.sin(ang), np.zeros_like(ang), np.cos(ang)], 1)    # camera: z ahead
    frames, truth = [], []
    for k in range(n):
        P = pose_matrix(H_PLANAR_STEP[0] * k, H_PLANAR_STEP[1] * k)
        o = P[:3, :3] @ np.array([0.0, Q_TIM_HEIGHT - 1.7, 0.0]) + P[:3, 3]
        t, _ = street_hits(o, d_cam @ P[:3, :3].T, alleys=True, dev=dev)
        mm = np.where(t <= Q_TIM_RANGE, np.round(t * 1000.0), 0).astype(np.int64)
        frames.append(Q_TIM_HEADER + f" {Q_TIM_BLOCKS:X} " + " ".join(f"{m:X}" for m in mm))
        r = np.where(mm > 0, t, np.nan)
        truth.append(np.stack([r * np.cos(ang), r * np.sin(ang), np.zeros_like(r)], 1))
    return "\x02" + "\x03\x02".join(frames) + "\x03", truth


def q_depth_frames(Q, rng):
    """``Q["frames"]`` depth frames of path G's room from its first camera pose,
    held still (the setting of a depth buffer): the clean render plus path G's
    range noise, ``Q["dropout"]`` of the pixels dropped, each depth at the
    centre of its mm (a Kinect reports mm). NaN where invalid."""
    from pcl_tpu_torch.fusion import Intrinsics

    H, W = Q["shape"]
    clean, _ = render_depth(handheld(rng, 1)[0], Intrinsics(*Q["intr"]), H, W)
    out = []
    for _ in range(Q["frames"]):
        d = clean + rng.normal(size=clean.shape) * G_NOISE * clean.astype(np.float64) ** 2
        ok = (clean > 0) & (rng.random(clean.shape) >= Q["dropout"]) & (d > 0)
        out.append(np.where(ok, (np.floor(d * 1000.0) + 0.5) / 1000.0, np.nan).astype(np.float32))
    return out


def path_q_inputs(Q, workdir: str, dev="cpu"):
    """Path Q's host inputs, written under ``workdir``: each capture's pcap
    with its true returns and sensor poses, the drive's golden poses (sweep
    k into sweep 0's frame), the street's dense samples in sweep 0's frame,
    the depth frames, and the TiM log with its true returns. The rays are
    cast on ``dev``, in float64."""
    rng = np.random.default_rng(Q_SEED)
    inp = dict(captures={}, workdir=workdir)
    for model, (n, blocks) in Q["captures"].items():
        poses = q_sensor_poses(Q, n, rng)
        packets, returns, rays = q_capture(model, n, blocks, poses, Q["max_range"], rng, dev)
        path = os.path.join(workdir, f"{model}.pcap")
        from pcl_tpu_torch.io import velodyne
        velodyne.write_pcap(path, packets)
        inp["captures"][model] = dict(pcap=path, returns=returns, poses=poses, rays=rays,
                                      packets=len(packets))
    poses = inp["captures"][Q["drive"]]["poses"]
    inv0 = np.linalg.inv(poses[0])
    inp["golden"] = np.stack([inv0 @ T for T in poses])
    street = make_street(0, n=Q["surface_points"]) @ Q_M.T
    inp["surface"] = (street @ inv0[:3, :3].T + inv0[:3, 3]).astype(np.float32)
    inp["frames"] = q_depth_frames(Q, rng)
    log, inp["tim_truth"] = q_tim_log(Q["tim_scans"], dev)
    inp["tim_log"] = os.path.join(workdir, "tim.log")
    with open(inp["tim_log"], "w") as f:
        f.write(log)
    return inp


class PortQ:
    """Path Q's calls on the port, on ``dev``: each through the entry point a
    user calls, host arrays in and out where the call makes a cloud.
    ``tests/rehearse_path_q.py`` has the JAX package's ``JaxQ`` with the same
    methods."""

    def __init__(self, dev):
        from pcl_tpu_torch import visualization
        from pcl_tpu_torch.io import (buffers, compression, organized_compression,
                                      range_coder, velodyne)

        self.dev = torch.device(dev)
        self.vis, self.velodyne, self.buffers = visualization, velodyne, buffers
        self.compression, self.range_coder = compression, range_coder
        self.organized = organized_compression

    def _t(self, a):
        return torch.as_tensor(np.asarray(a), device=self.dev)

    def cloud(self, xyz, attrs=None):
        from pcl_tpu_torch.core.cloud import from_numpy

        return from_numpy(np.asarray(xyz, np.float32), attrs, device=self.dev)

    @staticmethod
    def rows(c):
        """``(xyz, intensity or None, device type)`` of a cloud's valid rows."""
        m = c.mask
        inten = c.attrs.get("intensity")
        return (c.xyz[m].cpu().numpy(), None if inten is None else inten[m].cpu().numpy(),
                c.xyz.device.type)

    def grab(self, pcap, model, how):
        """The capture's sweeps, pumped by ``CloudIterator`` (``how="iterator"``,
        the pump thread joined after) or pulled by ``frames()``."""
        from pcl_tpu_torch.io.grabber import CloudIterator

        g = self.velodyne.PcapVelodyneGrabber(pcap, model=model, device=self.dev)
        if how == "frames":
            return list(g.frames())
        out = list(CloudIterator(g))
        thread = g._thread
        g.stop()
        check(thread is None or not thread.is_alive(), "the grabber's pump thread is alive")
        return out

    def front_end(self, sweeps):
        """Path C's front end (``front_end``) on the sweeps: ``(voxels [list of
        host arrays], poses, iterations, converged, truncated)``."""
        clouds, poses, results = front_end(sweeps)
        return ([live_rows(c).xyz.cpu().numpy() for c in clouds], poses,
                [int(r.iterations) for r, _ in results], [bool(r.converged) for r, _ in results],
                [bool(r.truncated) for r, _ in results])

    def voxel(self, xyz, leaf):
        from pcl_tpu_torch import filters

        return live_rows(filters.voxel_downsample(self.cloud(xyz), leaf)).xyz.cpu().numpy()

    def nn1(self, queries, targets):
        from pcl_tpu_torch.search import bruteforce

        t = self._t(targets)
        idx, d2 = bruteforce.nn1(t, torch.ones(len(t), dtype=torch.bool, device=self.dev),
                                 self._t(queries))
        return idx.cpu().numpy(), d2.cpu().numpy()

    def store(self, root, **kw):
        from pcl_tpu_torch.outofcore import OutofcoreOctree

        return OutofcoreOctree.create(root, device=self.dev, **kw)

    def tree(self, root, bb_min, bb_max, max_depth):
        from pcl_tpu_torch.outofcore import HierarchicalOutofcoreOctree

        return HierarchicalOutofcoreOctree.create(root, bb_min, bb_max, max_depth=max_depth,
                                                  device=self.dev)

    def decompress(self, blob):
        return self.compression.decompress_cloud(blob, device=self.dev).xyz.cpu().numpy()

    def voxel_centres(self, sweep, res):
        """The occupied voxels' centres as ``compress_cloud`` defines them (cells
        from the sweep's least corner, the header's float32 resolution),
        computed on the device in float64."""
        xyz = sweep.xyz[sweep.mask]
        origin = xyz.amin(0)
        # a tensor divisor: CUDA divides by a host scalar as a product with
        # its reciprocal, which rounds apart from numpy's quotient
        res_t = torch.tensor(res, dtype=torch.float32, device=xyz.device)
        cells = torch.unique(torch.floor((xyz - origin) / res_t).to(torch.int64), dim=0)
        res32 = float(np.float32(res))
        return ((cells.double() + 0.5) * res32 + origin.double()).float().cpu().numpy()

    def save_cloud(self, path, sweep, data="binary_compressed"):
        from pcl_tpu_torch.io import pcd

        pcd.save(path, sweep, data=data)

    def load_rows(self, path):
        from pcl_tpu_torch import io

        return self.rows(io.load(path, device=self.dev))

    def image_grabber(self, folder, focal):
        from pcl_tpu_torch.io.grabber import ImageGrabber

        return [(c.xyz.cpu().numpy(), c.mask.cpu().numpy(), c.width, c.height,
                 c.xyz.device.type) for c in ImageGrabber(folder, focal, device=self.dev).frames()]

    def tim_frames(self, log):
        """The log's scans through ``TimGrabber``'s pump: ``(scans, device types,
        thread joined)``."""
        from pcl_tpu_torch.io.tim import TimGrabber

        g = TimGrabber(log, device=self.dev)
        got = []
        g.register_callback(got.append)
        g.start()
        t0 = time.perf_counter()
        while g.is_running() and time.perf_counter() - t0 < 60.0:
            time.sleep(0.005)
        thread = g._thread
        g.stop()
        return ([c.xyz[c.mask].cpu().numpy() for c in got], [c.xyz.device.type for c in got],
                thread is not None and not thread.is_alive())

    def organized_mesh(self, xyz_img, valid):
        from pcl_tpu_torch import surface
        from pcl_tpu_torch.core.cloud import make_cloud

        H, W = valid.shape
        v, t = surface.organized_fast_mesh(make_cloud(xyz_img.reshape(-1, 3), valid.reshape(-1),
                                                      width=W, height=H, device=self.dev))
        return np.asarray(v, np.float32), np.asarray(t)

    def range_image(self, sweep):
        """A sweep's spherical range image (720 x 360 at 0.5 deg) seen from a
        sensor frame with z ahead (the sweep's y) and y up (its z)."""
        from pcl_tpu_torch.core import range_image

        pose = torch.tensor([[-1.0, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                            device=self.dev)
        return range_image.create_from_cloud(sweep, sensor_pose=pose).ranges.cpu().numpy()

    def tool(self, name, argv):
        import importlib

        with contextlib.redirect_stdout(pyio.StringIO()) as out:
            rc = importlib.import_module(f"pcl_tpu_torch.tools.{name}").main(
                list(argv) + ["--device", self.dev.type])
        return rc, out.getvalue()


def _sha(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _tree_digest(root) -> dict:
    return {os.path.relpath(os.path.join(d, f), root): _sha(os.path.join(d, f))
            for d, _, files in os.walk(root) for f in files}


def _row_set(a: np.ndarray) -> np.ndarray:
    """Rows in lexicographic order (a set's canonical form)."""
    a = np.asarray(a, np.float32).reshape(-1, 3)
    return a[np.lexsort(a.T[::-1])]


def path_q_chain(inp, Q, dev, lib=None, on_stage=None, poses=None):
    """Path Q's main path on ``lib`` (the port's ``PortQ`` on ``dev`` by
    default): (b) the captures replayed through the Velodyne grabber, both
    ways, pcap_to_pcd and hdl_grabber_example; (c) path C's front end on the
    drive's sweeps (B2 once a sweep); (d) the sweeps moved by their poses
    (``poses`` replaces the front end's, so that two runs can be given the
    same map) into the flat and the hierarchical out-of-core octree, their
    queries and LODs, the map's voxels (B2) and their 1-NN to the street
    (B1); (e) octree compression of each sweep, the range coder, organized
    compression, the depth buffers, the image and TiM grabbers and the image
    CLIs; (f) the HTML, ASCII, SVG and PGM views, the Visualizer and the
    live viewer, and the viewer CLIs (B2 twice, B1 once an ICP iteration).
    Returns ``(out, seconds)``."""
    dev = torch.device(dev)
    lib = PortQ(dev) if lib is None else lib
    out, secs = {}, {}

    def run(name, fn):
        if on_stage is not None:
            on_stage(name)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0
        return r

    # one path for every run, so that the files' titles (a viewer's title names
    # its inputs) are the same in two runs
    work = os.path.join(inp["workdir"], "chain")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    # (b) replay
    sweeps = {}
    for model, cap in inp["captures"].items():
        it = run(f"(b) CloudIterator {model}", lambda: lib.grab(cap["pcap"], model, "iterator"))
        fr = run(f"(b) frames {model}", lambda: lib.grab(cap["pcap"], model, "frames"))
        rows_it = [lib.rows(c) for c in it]
        rows_fr = [lib.rows(c) for c in fr]
        out[f"sweeps {model}"] = [r[0] for r in rows_it]
        out[f"intensity {model}"] = [r[1] for r in rows_it]
        out[f"devices {model}"] = sorted({r[2] for r in rows_it + rows_fr})
        out[f"both ways {model}"] = (len(it), len(fr), all(
            np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
            for a, b in zip(rows_it, rows_fr)))
        sweeps[model] = it
    drive = Q["drive"]
    pcap = inp["captures"][drive]["pcap"]
    pre_p, pre_g = os.path.join(work, "p"), os.path.join(work, "g")
    run("(b) tools.pcap_to_pcd", lambda: lib.tool("pcap_to_pcd", [pcap, pre_p, "-model", drive]))
    run("(b) tools.hdl_grabber_example", lambda: lib.tool("hdl_grabber_example", [
        pcap, "-model", drive, "-save", pre_g, "-timeout", "120"]))
    n = len(sweeps[drive])
    cli = [(lib.load_rows(f"{pre_p}_{k:03d}.pcd"), lib.load_rows(f"{pre_g}_{k:03d}.pcd"))
           for k in range(n)]
    out["cli sweeps"] = [a[0] for a, _ in cli]
    out["cli same"] = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                          and np.array_equal(a[0], out[f"sweeps {drive}"][k])
                          for k, (a, b) in enumerate(cli))
    out["files"] = {f"sweep {k}": _sha(f"{pre_p}_{k:03d}.pcd") for k in range(n)}
    # (c) odometry
    vox, est, iters, conv, trunc = run("(c) front_end", lambda: lib.front_end(sweeps[drive]))
    out["front voxels"], out["poses"] = vox, est
    out["icp"] = dict(iterations=iters, converged=conv, truncated=trunc)
    # (d) the map
    use = est if poses is None else poses
    # on the host in float64, so that two runs given the same poses store the
    # same map bit for bit
    moved = [run("(d) sweeps into the world", lambda: (
        xyz.astype(np.float64) @ use[k][:3, :3].T + use[k][:3, 3]).astype(np.float32))
        for k, xyz in enumerate(out[f"sweeps {drive}"])]
    world = np.concatenate(moved)
    out["map points"] = len(world)
    lo = tuple(float(x) for x in np.floor(world.min(0)) - 1.0)
    hi = tuple(float(x) for x in np.ceil(world.max(0)) + 1.0)
    store = lib.store(os.path.join(work, "ooc"), origin=lo, **Q["ooc"])
    ob = Q["ooc_batch"]
    for k in range(0, len(moved), ob):
        run("(d) OutofcoreOctree.add_cloud", lambda: store.add_cloud(lib.cloud(
            np.concatenate(moved[k:k + ob]))))
    keys = store.node_keys()
    stored = lod_ok = 0
    for key in keys:
        rows = lib.rows(store.read_node(key))[0]
        stored += len(rows)
        for lv in range(Q["ooc"]["lod_levels"]):
            got = len(lib.rows(store.read_node(key, lv))[0])
            lod_ok += got == max(1, min(len(rows), store.meta["lod_points"] >> lv))
    out["store"] = dict(nodes=len(keys), stored=stored, n_points=store.meta["n_points"],
                        lod_ok=lod_ok, lod_files=len(keys) * Q["ooc"]["lod_levels"])
    box = run("(d) query_box", lambda: lib.rows(store.query_box(*Q_BOX))[0])
    fru = run("(d) query_frustum", lambda: lib.rows(store.query_frustum(Q_FRUSTUM))[0])
    in_box = ((world >= Q_BOX[0]) & (world <= Q_BOX[1])).all(1)
    in_fru = (world @ Q_FRUSTUM[:, :3].T + Q_FRUSTUM[None, :, 3] >= 0).all(1)
    out["query box"] = (len(box), bool(np.array_equal(_row_set(box), _row_set(world[in_box]))))
    out["query frustum"] = (len(fru), bool(np.array_equal(_row_set(fru),
                                                          _row_set(world[in_fru]))))
    tree = lib.tree(os.path.join(work, "hier"), lo, hi, Q["hier_depth"])
    hb = Q["hier_batch"]
    accepted = sum(run("(d) HierarchicalOutofcoreOctree.add_points", lambda: tree.add_points(
        np.concatenate(moved[k:k + hb]))) for k in range(0, len(moved), hb))
    run("(d) build_lod", lambda: tree.build_lod())
    stats = tree.tree_stats()
    lod_bad = 0
    for d, meta in tree.depth_first():
        if any(meta["children"]):
            got = len(lib.load_rows(os.path.join(d, "lod.pcd"))[0])
            lod_bad += got != min(max(1, int(meta["subtree_count"] * 0.125)), 4096)
    bb = run("(d) query_bb_includes", lambda: lib.rows(tree.query_bb_includes(*Q_BOX))[0])
    out["tree"] = dict(stats, accepted=accepted, lod_bad=lod_bad,
                       centres=len(tree.get_occupied_voxel_centers(3)))
    out["query bb"] = (len(bb), bool(np.array_equal(_row_set(bb), _row_set(world[in_box]))))
    out["files"].update({f"ooc/{k}": v for k, v in _tree_digest(store.root).items()})
    out["files"].update({f"hier/{k}": v for k, v in _tree_digest(tree.root).items()})
    mvox = run("(d) voxel grid (map)", lambda: lib.voxel(world, Q["map_leaf"]))
    out["map voxels"] = mvox
    out["surface nn"] = run("(d) nn1 to the street", lambda: lib.nn1(mvox, inp["surface"]))
    # (e) streams and compression
    comp = []
    for k, s in enumerate(sweeps[drive]):
        blob = run("(e) compress_cloud", lambda: lib.compression.compress_cloud(
            s, Q["comp_res"]))
        back = run("(e) decompress_cloud", lambda: lib.decompress(blob))
        ref = run("(e) voxel centres (device)", lambda: lib.voxel_centres(s, Q["comp_res"]))
        binary = os.path.join(work, "binary.pcd")
        lib.save_cloud(binary, lib.cloud(out[f"sweeps {drive}"][k]), data="binary")
        comp.append((len(blob), os.path.getsize(binary), len(back),
                     bool(np.array_equal(_row_set(back), _row_set(ref)))))
        if k == 0:
            out["blob 0"] = hashlib.sha256(blob).hexdigest()
    out["compression"] = comp
    xyz0 = out[f"sweeps {drive}"][0]
    origin = xyz0.min(axis=0)
    cells = np.floor((xyz0 - origin) / Q["comp_res"]).astype(np.uint64)
    depth = max(1, int(np.ceil(np.log2(max(float(cells.max()) + 1, 2)))))
    stream = lib.compression._encode_bitmasks(np.unique(lib.compression._morton_np(cells, depth)),
                                              depth)
    coded = run("(e) range_coder.encode", lambda: lib.range_coder.encode(stream))
    decoded = run("(e) range_coder.decode", lambda: lib.range_coder.decode(coded, len(stream)))
    out["range coder"] = (len(stream), len(coded), decoded == stream,
                          hashlib.sha256(coded).hexdigest())
    frames = inp["frames"]
    H, W = Q["shape"]
    f0 = np.nan_to_num(frames[0], nan=0.0)
    fx = Q["intr"][0]
    u = np.arange(W, dtype=np.float32) - W / 2.0
    v = np.arange(H, dtype=np.float32) - H / 2.0
    img = np.stack([u[None, :] * f0 / fx, v[:, None] * f0 / fx, f0], -1).astype(np.float32)
    blob = run("(e) encode_organized", lambda: lib.organized.encode_organized(img, f0 > 0,
                                                                              focal=fx))
    back, ok, _ = run("(e) decode_organized", lambda: lib.organized.decode_organized(blob))
    out["organized"] = (len(blob), bool(np.array_equal(ok, f0 > 0)), bool(np.array_equal(
        np.rint(back[..., 2].astype(np.float64) * 1000.0), np.floor(f0 * 1000.0))),
        hashlib.sha256(blob).hexdigest())
    med = lib.buffers.MedianBuffer(H * W, Q["window"])
    avg = lib.buffers.AverageBuffer(H * W, Q["window"])
    bufs = []
    for fr in frames:
        run("(e) MedianBuffer.push", lambda: med.push(fr.reshape(-1)))
        run("(e) AverageBuffer.push", lambda: avg.push(fr.reshape(-1)))
        bufs.append((med.data, avg.data))
    out["buffers"] = bufs
    npy = os.path.join(work, "npy")
    os.makedirs(npy)
    for k, fr in enumerate(frames):
        np.save(os.path.join(npy, f"depth_{k:03d}.npy"), np.nan_to_num(fr, nan=0.0))
    out["image grabber"] = run("(e) ImageGrabber", lambda: lib.image_grabber(npy, fx))
    out["tim"] = run("(e) TimGrabber", lambda: lib.tim_frames(inp["tim_log"]))
    pcds = os.path.join(work, "frames")
    run("(e) tools.image_grabber_saver", lambda: lib.tool("image_grabber_saver", [
        npy, pcds, "-focal", str(fx)]))
    html = os.path.join(work, "html")
    os.makedirs(html)
    out["cli image"] = {}
    for name, argv in (("image_grabber_viewer", [npy, "-focal", str(fx), "-html",
                                                 os.path.join(html, "igv.html")]),
                       ("pcd_grabber_viewer", [pcds, "-max_frames", str(len(frames)),
                                               "-html", os.path.join(html, "pgv.html")]),
                       ("image_viewer", [os.path.join(pcds, "frame_000000.pcd"), "-depth",
                                         os.path.join(html, "depth.png")])):
        rc, text = run(f"(e) tools.{name}", lambda: lib.tool(name, argv))
        out["cli image"][name] = (rc, re.sub(r"[0-9.]+ fps", "fps", text.replace(work, "")))
    out["files"].update({f"frames/{f}": _sha(os.path.join(pcds, f))
                         for f in sorted(os.listdir(pcds))})
    # (f) views
    vis = lib.vis
    run("(f) cloud_to_html", lambda: vis.cloud_to_html(os.path.join(html, "map.html"),
                                                       lib.cloud(world)))
    with open(os.path.join(html, "map.html")) as f:
        payload = json.loads(f.read().split("const PTS = ")[1].split(";")[0])
    shown = np.frombuffer(base64.b64decode(payload), np.float32).reshape(-1, 3)
    sel = np.random.default_rng(0).choice(len(world), 500_000, replace=False) \
        if len(world) > 500_000 else np.arange(len(world))
    out["html rows"] = (len(shown), bool(np.array_equal(shown, world[sel])))
    mv, mt = run("(f) organized_fast_mesh", lambda: lib.organized_mesh(img, f0 > 0))
    out["mesh"] = (len(mv), len(mt))
    run("(f) mesh_to_html", lambda: vis.mesh_to_html(os.path.join(html, "mesh.html"), mv, mt))
    out["ascii"] = run("(f) render_ascii", lambda: vis.render_ascii(sweeps[drive][0]))
    traj, gold = use[:, :3, 3], inp["golden"][:, :3, 3]
    run("(f) plot_xy_svg", lambda: vis.plot_xy_svg(os.path.join(html, "traj.svg"), [
        (gold[:, 0], gold[:, 1], "golden"), (traj[:, 0], traj[:, 1], "estimated")],
        title="path Q trajectory"))
    hist = np.histogram(np.linalg.norm(xyz0, axis=1), bins=50, range=(0.0, Q["max_range"]))[0]
    run("(f) plot_histogram_svg", lambda: vis.plot_histogram_svg(
        os.path.join(html, "ranges.svg"), hist, name="sweep 0 ranges"))
    # views of what two devices or packages round apart: B1's and B2's results
    # and the range image's trigonometry
    rounded = os.path.join(work, "rounded")
    os.makedirs(rounded)
    ranges = run("(f) range image", lambda: lib.range_image(sweeps[drive][0]))
    run("(f) range_image_to_pgm", lambda: vis.range_image_to_pgm(
        os.path.join(rounded, "sweep0.pgm"), ranges))
    out["range image"] = int(np.isfinite(ranges).sum())
    viewer = vis.Visualizer("path Q")
    viewer.add_point_cloud(lib.cloud(mvox), "map")
    for k in range(len(traj) - 1):
        viewer.add_line(traj[k], traj[k + 1], f"traj {k}")
    viewer.add_sphere(traj[-1], 1.0, "car")
    picks, keys = [], []
    viewer.register_point_picking_callback(lambda e: picks.append((e.get_point_index(),
                                                                   e.get_point())))
    viewer.register_keyboard_callback(lambda e: keys.append(e.get_key_sym()))
    run("(f) Visualizer.spin_once", lambda: viewer.spin_once(os.path.join(rounded, "vis.html")))
    pick = len(mvox) // 3
    p = mvox[pick]
    n_ev = viewer.dispatch_events([{"type": "pick", "index": pick, "x": float(p[0]),
                                    "y": float(p[1]), "z": float(p[2])}])
    out["pick"] = (n_ev, picks == [(pick, (float(p[0]), float(p[1]), float(p[2])))])
    out["live"] = run("(f) LiveViewer", lambda: q_live(vis, viewer, keys))
    sweep_pcd = f"{pre_p}_000.pcd"
    mvox_pcd = os.path.join(work, "map_voxels.pcd")
    lib.save_cloud(mvox_pcd, lib.cloud(mvox))
    vpcd = [os.path.join(work, f"front_{k}.pcd") for k in (0, 1)]
    for k in (0, 1):
        lib.save_cloud(vpcd[k], lib.cloud(vox[k]))
    out["cli views"] = {}
    for name, argv in (
            ("hdl_viewer_simple", [inp["captures"][drive]["pcap"], "-model", drive, "-max_sweeps",
                                   "3", "-html", os.path.join(html, "hdl.html")]),
            ("vlp_viewer", [inp["captures"]["VLP16"]["pcap"], "-max_sweeps", "3", "-html",
                            os.path.join(html, "vlp.html")]),
            ("pcd_viewer", [sweep_pcd, "-html", os.path.join(html, "pcd.html")]),
            ("octree_viewer", [mvox_pcd, os.path.join(rounded, "octree.html"), "-resolution",
                               "0.5"]),
            ("obj_rec_ransac_orr_octree", [mvox_pcd, "-leaf", "0.5", "-html",
                                           os.path.join(rounded, "orr.html")]),
            ("registration_visualizer", [vpcd[1], vpcd[0], os.path.join(rounded, "reg"),
                                         *Q["viewer"]])):
        rc, text = run(f"(f) tools.{name}", lambda: lib.tool(name, argv))
        out["cli views"][name] = (rc, text.replace(work, ""))
    out["files"].update({f"html/{k}": v for k, v in _tree_digest(html).items()})
    out["rounded files"] = sorted(_tree_digest(rounded))
    out["ranges"] = ranges
    shutil.rmtree(work, ignore_errors=True)
    return out, secs


def q_live(vis, viewer, keys):
    """A ``LiveViewer`` of ``viewer`` on 127.0.0.1: a client thread GETs the
    first frame and POSTs a key event, each with a 10 s timeout; then
    ``close``. Returns ``(frame rows, rows expected, key delivered, server
    thread stopped, client finished)``."""
    import threading
    import urllib.request

    live = vis.LiveViewer(viewer, poll_timeout=2.0)
    got = {}

    def client():
        with urllib.request.urlopen(live.url + "frame?seq=0", timeout=10) as r:
            got["frame"] = json.loads(r.read())
        req = urllib.request.Request(live.url + "events", method="POST",
                                     data=json.dumps([{"type": "key", "key": "k"}]).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            got["events"] = json.loads(r.read())

    t = threading.Thread(target=client)
    t.start()
    t.join(timeout=30)
    thread = live._thread
    live.close()
    return (got.get("frame", {}).get("n"), len(viewer._flatten()[0]),
            got.get("events") == {"dispatched": 1} and keys == ["k"], not thread.is_alive(),
            not t.is_alive())



def q_buffer_reference(frames, window: int, k: int):
    """Frame ``k``'s per-pixel upper median and mean of the valid samples in
    the last ``window`` frames, in plain numpy, and ``np.nanmedian`` with the
    pixels whose valid count is odd (where the upper median is the median)."""
    win = np.stack([f.reshape(-1) for f in frames[max(0, k - window + 1):k + 1]]).astype(
        np.float64)
    n = np.sum(~np.isnan(win), axis=0)
    srt = np.sort(win, axis=0)                        # NaN last
    upper = np.take_along_axis(srt, np.minimum(n // 2, len(win) - 1)[None], 0)[0]
    with np.errstate(invalid="ignore", divide="ignore"):
        mean = np.nansum(win, axis=0) / n
    nanmed = np.full(win.shape[1], np.nan)
    some = n > 0
    nanmed[some] = np.nanmedian(win[:, some], axis=0)
    return (np.where(n > 0, upper, np.nan).astype(np.float32),
            np.where(n > 0, mean, np.nan).astype(np.float32), nanmed, n % 2 == 1)


def path_q_metrics(inp, out, Q) -> dict:
    """Path Q's numbers: the replay against the rendered returns, the
    trajectory, the stores, the surface error, the streams and the views."""
    from pcl_tpu_torch.registration import trajectory

    m = {}
    drive = Q["drive"]
    for model, cap in inp["captures"].items():
        got = out[f"sweeps {model}"]
        n_it, n_fr, same = out[f"both ways {model}"]
        m[f"sweeps {model}"] = [n_it, n_fr, len(cap["returns"])]
        m[f"both ways {model}"] = bool(same)
        m[f"returns {model}"] = [len(x) for x in got]
        m[f"decode err {model}"] = max(
            float(np.abs(a.astype(np.float64) - b).max()) if len(a) == len(b) else math.inf
            for a, b in zip(got, cap["returns"])) if len(got) == len(cap["returns"]) else math.inf
        m[f"devices {model}"] = out[f"devices {model}"]
        m[f"intensity {model}"] = all(i is not None and len(i) == len(x)
                                      for i, x in zip(out[f"intensity {model}"], got))
    m["cli same"] = bool(out["cli same"])
    poses = out["poses"]
    ate = trajectory.trajectory_ate(poses, inp["golden"], align=False)
    rpe = trajectory.trajectory_rpe(poses, inp["golden"])
    m.update(ate=ate.rmse, ate_max=ate.max, rpe_t=rpe.trans_rmse, rpe_r=rpe.rot_rmse,
             icp=out["icp"])
    st, tr = out["store"], out["tree"]
    m["map points"] = out["map points"]
    m["store"] = st
    m["tree"] = tr
    m["queries"] = dict(box=out["query box"], frustum=out["query frustum"], bb=out["query bb"])
    d = np.sqrt(out["surface nn"][1].astype(np.float64))
    m.update(map_voxels=len(out["map voxels"]), surface_p50=float(np.percentile(d, 50)),
             surface_p99=float(np.percentile(d, 99)), surface_max=float(d.max()))
    comp = out["compression"]
    m["compression"] = dict(exact=all(c[3] for c in comp),
                            ratio=float(np.mean([c[0] / c[1] for c in comp])),
                            bytes=int(np.mean([c[0] for c in comp])),
                            voxels=int(np.mean([c[2] for c in comp])))
    n_stream, n_coded, ok, _ = out["range coder"]
    m["range coder"] = dict(stream=n_stream, coded=n_coded, round_trip=bool(ok))
    m["organized"] = dict(bytes=out["organized"][0], mask=out["organized"][1],
                          depth=out["organized"][2])
    med_ok = avg_ok = nanmed_ok = True
    for k, (med, avg) in enumerate(out["buffers"]):
        ref_med, ref_avg, nanmed, odd = q_buffer_reference(inp["frames"], Q["window"], k)
        med_ok &= bool(np.array_equal(med, ref_med, equal_nan=True))
        avg_ok &= bool(np.array_equal(avg, ref_avg, equal_nan=True))
        nanmed_ok &= bool(np.array_equal(med[odd], nanmed[odd].astype(np.float32)))
    m["buffers"] = dict(median=med_ok, mean=avg_ok, nanmedian_odd=nanmed_ok)
    H, W = Q["shape"]
    fx = Q["intr"][0]
    u = np.arange(W, dtype=np.float32) - W / 2.0
    v = np.arange(H, dtype=np.float32) - H / 2.0
    err, masks, devs = 0.0, True, set()
    for (xyz, mask, w, h, dv), fr in zip(out["image grabber"], inp["frames"]):
        z = np.nan_to_num(fr, nan=0.0)
        ref = np.stack(np.broadcast_arrays(u[None, :] * z / fx, v[:, None] * z / fx, z),
                       -1).reshape(-1, 3)
        ok = (z > 0).reshape(-1)
        masks &= bool(np.array_equal(mask, ok)) and (w, h) == (W, H)
        err = max(err, float(np.abs(xyz[ok] - ref[ok]).max()))
        devs.add(dv)
    m["image grabber"] = dict(frames=len(out["image grabber"]), mask=masks, err=err,
                              devices=sorted(devs))
    scans, tdev, joined = out["tim"]
    terr = 0.0
    for got, truth in zip(scans, inp["tim_truth"]):
        ok = np.isfinite(truth[:, 0])
        terr = max(terr, float(np.abs(got[ok] - truth[ok]).max()) if len(got) == len(truth)
                   else math.inf)
    m["tim"] = dict(scans=len(scans), err=terr, devices=sorted(set(tdev)), joined=joined,
                    returns=int(sum(np.isfinite(t[:, 0]).sum() for t in inp["tim_truth"])))
    m["cli"] = {k: v[0] for k, v in {**out["cli image"], **out["cli views"]}.items()}
    m.update(html_rows=out["html rows"], pick=out["pick"], live=out["live"],
             mesh=out["mesh"], range_image=out["range image"])
    return m


Q_PLAIN_ROWS = 1 << 15      # B1's plain version on the first rows of a call
# limits: 1.5 x the JAX package's CPU rehearsal at full width (tests/rehearse_path_q.py jax,
# 59 min on an 8-core CPU, 51 of them the front end): ATE 2.7443 m over the 40 sweeps (the
# front end stops short of each 1 m step along the street), the map's p99 surface error
# 2.9418 m (the drift; p50 0.0537 m)
Q_LIMITS = dict(ate=4.117, surface_p99=4.413)
Q_DECODE_TOL = 1.5e-3       # m: half the 2 mm range unit, and float32 at 100 m
Q_TIM_TOL = 1e-3            # m: half the TiM's 1 mm unit, and float32 at 25 m


def q_checks(m, lim, Q, expect, dev_type="cuda"):
    """Path Q's checks: the exact ones always, the measured ones against
    ``lim`` (a limit of None is printed, not checked); the clouds the
    grabbers make must lie on ``dev_type``."""
    printed = []
    for model, (n, _) in Q["captures"].items():
        expect(m[f"sweeps {model}"] == [n, n, n],
               f"(b) {model}: sweeps (CloudIterator, frames(), revolutions) "
               f"{m[f'sweeps {model}']}")
        expect(m[f"both ways {model}"], f"(b) {model}: CloudIterator and frames() differ")
        expect(m[f"devices {model}"] == [dev_type] and m[f"intensity {model}"],
               f"(b) {model}: sweeps on {m[f'devices {model}']}, intensity "
               f"{m[f'intensity {model}']}")
        expect(m[f"decode err {model}"] <= Q_DECODE_TOL,
               f"(b) {model}: a decoded point lies {m[f'decode err {model}']} m from its "
               f"rendered return (limit {Q_DECODE_TOL})")
    expect(m["cli same"], "(b) tools.pcap_to_pcd and tools.hdl_grabber_example -save differ")
    expect(all(m["icp"]["converged"]) and not any(m["icp"]["truncated"]),
           f"(c) ICP: {m['icp']}")
    for key, what in (("ate", "(c) ATE"), ("surface_p99", "(d) the map's p99 surface error")):
        L = lim[key]
        if L is None:
            printed.append(f"{what} {m[key]:.5f} m")
        else:
            expect(m[key] <= L, f"{what} {m[key]:.5f} m (limit {L})")
    st, tr, n = m["store"], m["tree"], m["map points"]
    expect(st["stored"] == st["n_points"] == n and st["lod_ok"] == st["lod_files"],
           f"(d) OutofcoreOctree: {st}, map {n}")
    expect(tr["points"] == tr["accepted"] == n and tr["lod_bad"] == 0,
           f"(d) HierarchicalOutofcoreOctree: {tr}, map {n}")
    for k, (cnt, same) in m["queries"].items():
        expect(same and cnt > 0, f"(d) query {k}: {cnt} points, same as the mask {same}")
    c = m["compression"]
    expect(c["exact"], "(e) decompress_cloud differs from the voxel centres")
    expect(m["range coder"]["round_trip"], "(e) the range coder's round trip differs")
    expect(m["organized"]["mask"] and m["organized"]["depth"],
           f"(e) organized compression: {m['organized']}")
    expect(all(m["buffers"].values()), f"(e) buffers against numpy: {m['buffers']}")
    ig = m["image grabber"]
    expect(ig["frames"] == Q["frames"] and ig["mask"] and ig["err"] <= 1e-6
           and ig["devices"] == [dev_type],
           f"(e) ImageGrabber: {ig}")
    t = m["tim"]
    expect(t["scans"] == Q["tim_scans"] and t["err"] <= Q_TIM_TOL and t["joined"]
           and t["devices"] == [dev_type], f"(e) TimGrabber: {t}")
    expect(all(v == 0 for v in m["cli"].values()), f"(e), (f) CLI exit codes {m['cli']}")
    expect(m["html_rows"][1], f"(f) cloud_to_html's payload is not default_rng(0)'s rows")
    expect(m["pick"] == (1, True), f"(f) the scripted pick: {m['pick']}")
    n_live, n_want, key, stopped, finished = m["live"]
    expect(n_live == n_want and key and stopped and finished,
           f"(f) LiveViewer: frame {n_live} of {n_want} rows, key {key}, server stopped "
           f"{stopped}, client finished {finished}")
    return printed


def q_card_vs_cpu(expect, card=None):
    """Path Q's chain at ``Q_SMALL`` on the CPU, then on the card with the
    CPU's poses for the map: the poses to 1e-5, every file and stream that
    no kernel computes bit for bit, the rest as numbers. Returns lines to
    print."""
    card = torch.device("cuda") if card is None else card
    Q = Q_SMALL
    with tempfile.TemporaryDirectory() as tmp:
        inp = path_q_inputs(Q, tmp, card)
        b, _ = path_q_chain(inp, Q, torch.device("cpu"))
        a, _ = path_q_chain(inp, Q, card, poses=b["poses"])
    gap = float(np.abs(a["poses"] - b["poses"]).max())
    diff = sorted(k for k in set(a["files"]) | set(b["files"])
                  if a["files"].get(k) != b["files"].get(k))
    same_streams = all(a[k] == b[k] for k in ("range coder", "organized", "compression",
                                              "cli image", "ascii", "blob 0"))
    same_sweeps = all(np.array_equal(x, y) for x, y in zip(a["sweeps VLP16"],
                                                           b["sweeps VLP16"]))
    bufs = all(np.array_equal(x[0], y[0], equal_nan=True) and np.array_equal(
        x[1], y[1], equal_nan=True) for x, y in zip(a["buffers"], b["buffers"]))
    vgap = float(np.abs(a["map voxels"] - b["map voxels"]).max()) \
        if a["map voxels"].shape == b["map voxels"].shape else math.inf
    expect(gap <= 1e-5 and not diff and same_streams and same_sweeps and bufs
           and vgap <= 1e-5, f"(card vs CPU) poses by {gap}, files that differ {diff[:5]}, "
                             f"streams equal {same_streams}, sweeps {same_sweeps}, buffers "
                             f"{bufs}, map voxels by {vgap}")
    return [f"{len(a['files'])} files equal, poses by {gap:.1e}, map voxels by {vgap:.1e}"]


def phase19_path_q(segsum, nn1_mod, record_b1, record_b2):
    """Path Q: an HDL-32E drive through path C's street, replayed from a pcap
    into path C's front end, stored out of core, compressed and shown."""
    from pcl_tpu_torch.search import bruteforce

    failed = []

    def expect(cond: bool, what: str) -> None:
        if not cond:
            print(f"phase 19: CHECK FAILED: {what}", flush=True)
            failed.append(what)

    dev = torch.device("cuda")
    Q = Q_FULL
    card = card_line()
    lines, csecs = timed(lambda: q_card_vs_cpu(expect))
    print(f"phase 19: card against CPU at 3 VLP-16 sweeps (also the warm-up, {csecs:.1f} s): "
          + "; ".join(lines), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        inp, isecs = timed(lambda: path_q_inputs(Q, tmp, dev))
        for model, cap in inp["captures"].items():
            n = [len(r) for r in cap["returns"]]
            print(f"phase 19: {model}: {len(n)} sweeps of {cap['rays'] // len(n)} rays, "
                  f"{cap['packets']} packets, returns per sweep {min(n)}-{max(n)} (mean "
                  f"{np.mean(n):.0f})", flush=True)
        print(f"phase 19: inputs in {isecs:.1f} s", flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trace.reset()
        with kernel_calls(bruteforce, segsum) as calls:
            (out, secs), total = timed(lambda: path_q_chain(
                inp, Q, dev, on_stage=lambda n: calls.__setitem__("stage", n)))
        b1, b2 = launch_count("nn1"), launch_count("segsum")
        record_b1["launches_by_path"]["Q"] = b1
        record_b2["launches_by_path"]["Q"] = b2
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"phase 19: path Q in {total:.1f} s, peak memory {peak:.2f} GiB, launches nn1 "
              f"{b1}, segsum {b2} [{card}]", flush=True)
        for name, v in secs.items():
            print(f"phase 19: {name}: {v * 1e3:.1f} ms [{card}]", flush=True)
        parts = {p: sum(v for k, v in secs.items() if k.startswith(p))
                 for p in ("(b)", "(c)", "(d)", "(e)", "(f)")}
        print("phase 19: by part " + ", ".join(f"{p} {v:.2f} s" for p, v in parts.items())
              + f" [{card}]", flush=True)
        n_sweeps = Q["captures"][Q["drive"]][0]
        iters = int(Q["viewer"][1])
        expect(b2 == n_sweeps + 3 and b1 == iters + 1,
               f"path Q launched B2 {b2} times (the front end once a sweep, {n_sweeps}, the "
               f"map's voxels and the two octree viewers: {n_sweeps + 3}) and B1 {b1} times "
               f"(registration_visualizer's ICP once an iteration, {iters}, and the map's "
               f"surface error once: {iters + 1})")
        expect(len(calls["nn1"]) == b1 and len(calls["segsum"]) == b2,
               "the kept kernel calls do not match the launch counts")
        m = path_q_metrics(inp, out, Q)
        print("phase 19: metrics " + json.dumps(m, default=float), flush=True)
        for what in q_checks(m, Q_LIMITS, Q, expect):
            print(f"phase 19: printed, not checked: {what}", flush=True)
        rows1, rows2 = hold_to_plain(calls, nn1_mod, segsum, expect, "phase 19:", Q_PLAIN_ROWS,
                                     card, time_once="stage")
    record_b1["path_q"] = rows1
    record_b2["path_q"] = rows2
    check(not failed, "path Q: " + "; ".join(failed))
    return {"total_s": total, "peak_gib": peak, "parts": parts, "metrics": m}

# ---------------------------------------------------------------------------
# Path R: the last 25 CLIs in a PCL user's chain, and the native host runtime
# ---------------------------------------------------------------------------

R_SEED = 17                 # the draws of a card-against-CPU comparison, the tools' -seed
R_FULL = dict(points=SCAN_CAPACITY, frame=L_FULL)
R_SMALL = dict(points=SCAN_CAPACITY // 4, frame=L_SMALL)     # the CPU tests: a quarter scan
R_CPU = dict(points=SCAN_CAPACITY // 8, frame=L_SMALL)       # the card against the CPU
# path J's progressive morphological filter (J_PMF) as the CLI's flags
R_PMF = ["-cell_size", "1.0", "-max_window", "20", "-slope", "1.0", "-initial_distance", "0.5",
         "-max_distance", "3.0"]
R_FEATURES = ("normal", "pfh", "fpfh", "vfh", "esf", "shot")
R_VIEWPOINT = ["0.5", "-1", "2", "0.9238795", "0", "0.3826834", "0"]   # 45 deg about y
R_NO_DEVICE = ("plyheader", "pcd_convert_NaN_nan")                    # bytes only, no cloud
R_GROUND_Z = -1.7           # the street's ground in the z-up frame (path J's y = -1.7)
R_NATIVE_K = 16
R_NATIVE_RADIUS = 0.5       # m: ~20 of the raw scan's points within it near the sensor
R_NATIVE_CAP = 64
# shares of rows within tolerance (the CPU tests' measured floors): normals n.n' >= 1 - 1e-5,
# descriptors within 1e-3 of their scale (C9's normals flip C19's bins), labels equal
R_SHARES = dict(normal=0.99, rows=0.9, labels=0.95)


def path_r_inputs(scans, golden, R, workdir):
    """Path R's input files in ``workdir``, written by the port's io on the
    host: path C's scans 0 and 1 (moved into scan 0's frame), every k-th point
    up to ``R["points"]``, turned z-up (``J_UP``) as LiDAR tools take them,
    as binary PCD; path G's frame 0 at ``R["frame"]``'s shape with path L's
    RGB (``path_l_frame``) as an organized PCD; the scan's points in threes as
    a binary PLY mesh; the scan as an ascii PCD with every 50th point NaN,
    spelled ``NaN`` as old writers did."""
    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.cloud import Cloud, from_numpy
    from pcl_tpu_torch.io import pcd as pcd_io

    up = J_UP[:3, :3].astype(np.float64)

    def z_up(s, pose):
        s = np.asarray(s, np.float64)
        s = s[::max(1, len(s) // R["points"])][:R["points"]]
        return ((s @ pose[:3, :3].T + pose[:3, 3]) @ up.T).astype(np.float32)

    raw, raw1 = z_up(scans[0], golden[0]), z_up(scans[1], golden[1])
    inp = {k: os.path.join(workdir, f"{k}.pcd") for k in ("raw", "raw1", "frame", "old_nan")}
    inp["mesh"] = os.path.join(workdir, "mesh.ply")
    io.save(inp["raw"], from_numpy(raw, device="cpu"), data="binary")
    io.save(inp["raw1"], from_numpy(raw1, device="cpu"), data="binary")
    fr = path_l_frame(R["frame"])
    H, W = R["frame"]["shape"]
    io.save(inp["frame"], Cloud(xyz=torch.from_numpy(fr["xyz"].reshape(-1, 3)),
                                mask=torch.ones(H * W, dtype=torch.bool),
                                attrs={"rgb": torch.from_numpy(fr["rgb"].reshape(-1, 3))},
                                width=W, height=H), data="binary")
    n3 = len(raw) // 3 * 3
    io.save_ply(inp["mesh"], from_numpy(raw[:n3], device="cpu"),
                faces=np.arange(n3, dtype=np.int32).reshape(-1, 3))
    nan = raw.copy()
    nan[::50] = np.nan
    pcd_io.save(inp["old_nan"], Cloud(xyz=torch.from_numpy(nan),
                                      mask=torch.from_numpy(np.isfinite(nan).all(1))),
                data="ascii", compact=False)
    with open(inp["old_nan"], "rb") as f:
        text = f.read()
    with open(inp["old_nan"], "wb") as f:
        f.write(text.replace(b"nan", b"NaN"))
    return inp


def path_r_steps(inp, out, src=None):
    """Path R's chain in the order a PCL user runs the tools: ``(name, tool,
    argv, output, kind)``, each output in ``out`` (a file name; the cluster
    files' prefix; None where the tool prints only). A step reads the outputs
    of earlier steps from ``src`` (default ``out``), so that a second run can
    take the first run's files and each step is compared on the same input.
    ``kind`` says how two runs' outputs are compared (``path_r_compare``)."""
    O = lambda f: os.path.join(out, f)                          # noqa: E731
    S = lambda f: os.path.join(src or out, f)                   # noqa: E731
    steps = [
        ("voxel_grid", "voxel_grid", [inp["raw"], O("vox.pcd"), "-leaf", str(LEAF)], "vox.pcd",
         "points"),
        ("uniform_sampling", "uniform_sampling", [inp["raw"], O("uniform.pcd"), "-radius",
                                                  str(LEAF)], "uniform.pcd", "bytes"),
        ("passthrough_filter", "passthrough_filter", [S("vox.pcd"), O("crop.pcd"), "-field", "y",
                                                      "-min", "-40", "-max", "0"],
         "crop.pcd", "bytes"),
        ("outlier_removal statistical", "outlier_removal",
         [S("crop.pcd"), O("sor.pcd"), "-mean_k", "16", "-std_dev_mul", "1.0"], "sor.pcd", "sor"),
        ("outlier_removal radius", "outlier_removal",
         [S("sor.pcd"), O("ror.pcd"), "-method", "radius", "-radius", "0.8", "-min_pts", "2"],
         "ror.pcd", "bytes"),
        ("radius_filter", "radius_filter", [S("ror.pcd"), O("clean.pcd"), "-radius", "0.8",
                                            "-min_neighbors", "2"], "clean.pcd", "bytes"),
        ("grid_min", "grid_min", [S("clean.pcd"), O("grid_min.pcd"), "-resolution", "1.0"],
         "grid_min.pcd", "bytes"),
        ("local_max", "local_max", [S("clean.pcd"), O("local_max.pcd"), "-radius", "1.0"],
         "local_max.pcd", "bytes"),
        ("morph", "morph", [S("clean.pcd"), O("morph.pcd"), "-operator", "open",
                            "-resolution", "1.0"], "morph.pcd", "bytes"),
        ("pmf ground", "progressive_morphological_filter", [S("clean.pcd"), O("ground.pcd"),
                                                            *R_PMF], "ground.pcd", "bytes"),
        ("pmf objects", "progressive_morphological_filter",
         [S("clean.pcd"), O("objects.pcd"), *R_PMF, "--extract_negative"], "objects.pcd",
         "bytes"),
        ("cluster_extraction", "cluster_extraction",
         [S("objects.pcd"), "-tolerance", "0.5", "-min_size", "20", "-prefix", O("cluster_"),
          "--write"], "cluster_", "clusters"),
        ("plane_projection", "plane_projection", [S("ground.pcd"), O("plane.pcd"), "-thresh",
                                                  "0.1"], "plane.pcd", "plane"),
    ]
    for f in R_FEATURES:
        kind = {"normal": "normal", "fpfh": "fpfh", "vfh": "histogram",
                "esf": "histogram"}.get(f, "rows")
        steps.append((f"extract_feature {f}", "extract_feature",
                      [S("clean.pcd"), O(f"{f}.npy"), "-feature", f, "-k", "16", "-radius", "1.0"],
                      f"{f}.npy", kind))
    steps += [
        ("train_unary_classifier", "train_unary_classifier",
         [S("ground.pcd"), S("objects.pcd"), "-o", O("codebook.npz"), "-clusters", "8"],
         "codebook.npz", "codebook"),
        ("voxel_grid scan 1", "voxel_grid", [inp["raw1"], O("vox1.pcd"), "-leaf", str(LEAF)],
         "vox1.pcd", "points"),
        ("unary_classifier_segment", "unary_classifier_segment",
         [S("vox1.pcd"), S("codebook.npz"), O("labels.pcd")], "labels.pcd", "labels"),
        # the file and per-point tools on the whole scan
        ("convert_pcd_ascii_binary 0", "convert_pcd_ascii_binary",
         [inp["raw"], O("raw_ascii.pcd"), "0"], "raw_ascii.pcd", "bytes"),
        ("convert_pcd_ascii_binary 1", "convert_pcd_ascii_binary",
         [S("raw_ascii.pcd"), O("raw_binary.pcd"), "1"], "raw_binary.pcd", "bytes"),
        ("convert_pcd_ascii_binary 2", "convert_pcd_ascii_binary",
         [S("raw_binary.pcd"), O("raw_compressed.pcd"), "2"], "raw_compressed.pcd", "bytes"),
        ("converter pcd to ply", "converter", [inp["raw"], O("raw.ply"), "-f", "binary"],
         "raw.ply", "bytes"),
        ("converter ply to pcd", "converter",
         [S("raw.ply"), O("raw_from_ply.pcd"), "-f", "binary_compressed"], "raw_from_ply.pcd",
         "bytes"),
        ("plyheader", "plyheader", [inp["mesh"]], None, "text"),
        ("ply2raw", "ply2raw", [inp["mesh"], O("mesh.raw")], "mesh.raw", "bytes"),
        ("pcd_introduce_nan", "pcd_introduce_nan",
         [inp["raw"], O("raw_nan.pcd"), "-fraction", "0.05", "-seed", str(R_SEED)],
         "raw_nan.pcd", "bytes"),
        ("pcd_convert_NaN_nan", "pcd_convert_NaN_nan", [inp["old_nan"], O("raw_nan_fixed.pcd")],
         "raw_nan_fixed.pcd", "bytes"),
        ("pcd_change_viewpoint", "pcd_change_viewpoint",
         [inp["raw"], O("raw_vp.pcd"), *R_VIEWPOINT], "raw_vp.pcd", "bytes"),
        ("transform_from_viewpoint", "transform_from_viewpoint",
         [S("raw_vp.pcd"), O("raw_moved.pcd")], "raw_moved.pcd", "bytes"),
        ("transform_from_viewpoint inverse", "transform_from_viewpoint",
         [S("raw_vp.pcd"), O("raw_unmoved.pcd"), "--inverse"], "raw_unmoved.pcd", "bytes"),
        ("demean_cloud", "demean_cloud", [inp["raw"], O("raw_demeaned.pcd")],
         "raw_demeaned.pcd", "points"),
        ("add_gaussian_noise", "add_gaussian_noise",
         [inp["raw"], O("raw_noisy.pcd"), "-sd", "0.02", "-seed", str(R_SEED)],
         "raw_noisy.pcd", "bytes"),
        # path G's frame
        ("fast_bilateral_filter", "fast_bilateral_filter", [inp["frame"], O("frame_fbf.pcd")],
         "frame_fbf.pcd", "smooth"),
        ("bilateral_upsampling", "bilateral_upsampling", [inp["frame"], O("frame_bup.pcd")],
         "frame_bup.pcd", "smooth"),
    ]
    return steps


def port_runner(dev, inject=None):
    """``run(name, tool, argv)`` for ``path_r_chain``: the port's CLI
    ``main`` with ``--device dev`` (but for the two byte tools), given what
    ``inject(name, argv)`` returns as keyword arguments (the draws of the
    tools that draw); returns what the tool printed."""
    import importlib

    def run(name, tool, argv):
        mod = importlib.import_module(f"pcl_tpu_torch.tools.{tool}")
        extra = [] if tool in R_NO_DEVICE else ["--device", str(dev)]
        kw = inject(name, argv) if inject is not None else {}
        buf = pyio.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mod.main([*argv, *extra], **kw)
        check(rc == 0, f"path R: {name} returned {rc}")
        return buf.getvalue()

    return run


def host_draws(name, argv):
    """The draws of the tools that draw, made on the host from generators
    seeded ``R_SEED``: the same for both runs of a card-against-CPU
    comparison (the generators of the card and of the CPU draw apart)."""
    from pcl_tpu_torch import io, sac
    from pcl_tpu_torch.features.global_desc import draw_esf_samples
    from pcl_tpu_torch.ml.kmeans import kmeans_init_indices
    from pcl_tpu_torch.tools.add_gaussian_noise import draw_noise

    gen = torch.Generator().manual_seed(R_SEED)
    if name == "plane_projection":
        mask = io.load(argv[0], device="cpu").mask
        return {"draws": sac.draw_samples(sac.PlaneModel(), mask, 1024, "ransac", 0.1, None, gen)}
    if name == "extract_feature esf":
        return {"esf_draws": draw_esf_samples(io.load(argv[0], device="cpu").mask, 4096, gen)}
    if name == "train_unary_classifier":
        k = int(argv[argv.index("-clusters") + 1])
        counts = [int(io.load(p, device="cpu").count) for p in argv[:argv.index("-o")]]
        return {"init_indices": [kmeans_init_indices(torch.ones(n, dtype=torch.bool), min(k, n),
                                                     gen) for n in counts]}
    if name == "add_gaussian_noise":
        sd = float(argv[argv.index("-sd") + 1])
        return {"noise": draw_noise(io.load(argv[0], device="cpu"), sd, R_SEED)}
    return {}


def path_r_chain(inp, out, run, src=None, on_step=None, only=None):
    """Every step of ``path_r_steps`` (those named in ``only``, where given)
    through ``run(name, tool, argv)``: ``{name: (printed text, seconds)}``."""
    res = {}
    for name, tool, argv, _, _ in path_r_steps(inp, out, src):
        if only is not None and name not in only:
            continue
        if on_step is not None:
            on_step(name)
        res[name] = timed(lambda: run(name, tool, argv))
    return res


def _r_cloud(path):
    from pcl_tpu_torch import io
    return io.load(path, device="cpu")


def _r_bytes(path):
    """A file's bytes; a PLY file's writer comment (``generated by pcl_tpu``
    or ``pcl_tpu_torch``) left out."""
    with open(path, "rb") as f:
        data = f.read()
    return re.sub(rb"comment generated by pcl_tpu(_torch)?\n", b"", data, count=1) \
        if data.startswith(b"ply\n") else data


def _r_rows(path):
    from pcl_tpu_torch.core.cloud import to_numpy
    return to_numpy(_r_cloud(path))[0]


def _r_plane(text):
    m = re.search(r"plane \[([^\]]*)\]", text)
    return np.array([float(v) for v in m.group(1).split()]), text.split("(")[1].split()[0]


def path_r_compare(inp, a_dir, b_dir, a_res, b_res, expect, tag, only=None):
    """Two runs of the chain step by step (those named in ``only``, where
    given), the second on the first's inputs (``src=a_dir``): each step's
    outputs by its kind, and what both printed (the directories aside, and
    but for the steps that print floats). Returns one line a step."""
    lines = []
    scale = float(np.abs(_r_rows(inp["raw"])).max())
    for name, tool, argv, out, kind in path_r_steps(inp, a_dir):
        if only is not None and name not in only:
            continue
        ta, tb = (r[name][0].replace(a_dir + os.sep, "").replace(b_dir + os.sep, "")
                  for r in (a_res, b_res))
        if kind not in ("plane", "labels", "points"):
            expect(ta == tb, f"{tag} {name}: the printed lines differ: {ta!r} against {tb!r}")
        pa, pb = (os.path.join(d, out) if out else None for d in (a_dir, b_dir))
        what = ""
        if kind == "bytes":
            same = _r_bytes(pa) == _r_bytes(pb)
            expect(same, f"{tag} {name}: the files differ")
            what = "bytes equal" if same else "bytes DIFFER"
        elif kind in ("points", "smooth", "plane"):
            ca, cb = _r_cloud(pa), _r_cloud(pb)
            tol = {"points": 1e-6, "smooth": 5e-5, "plane": 1e-5}[kind] * scale
            ok = torch.equal(ca.mask, cb.mask) and (ca.width, ca.height) == (cb.width, cb.height)
            err = float((ca.xyz - cb.xyz).abs().max()) if ok and ca.capacity else 0.0
            expect(ok and err <= tol, f"{tag} {name}: masks differ or points by {err} m")
            what = f"{int(ca.mask.sum())} points, max |diff| {err:.3e} m"
            if kind == "plane":
                (ka, na), (kb, nb) = _r_plane(ta), _r_plane(tb)
                expect(np.abs(ka - kb).max() <= 1e-5 and na == nb,
                       f"{tag} {name}: planes {ka} ({na}) and {kb} ({nb})")
                what += f", plane {ka} ({na} inliers)"
        elif kind == "sor":
            src_cloud = _r_cloud(argv[0])
            margin = sor_margin(src_cloud, mean_k=16, stddev_mult=1.0).numpy()
            live = src_cloud.mask.numpy()
            keep = [np.isin(_row_view(src_cloud.xyz.numpy()), _row_view(_r_rows(p)))
                    for p in (pa, pb)]
            differ = (keep[0] != keep[1]) & live
            expect(not (differ & ~margin).any(), f"{tag} {name}: kept points differ")
            what = (f"{int(keep[0].sum())} kept, {int(differ.sum())} differ at the threshold's "
                    f"rounding or a neighbour tie ({int((margin & live).sum())} such points)")
        elif kind == "clusters":
            n = int(ta.split()[1])
            for i in range(n):
                expect(_r_bytes(f"{pa}{i}.pcd") == _r_bytes(f"{pb}{i}.pcd"),
                       f"{tag} {name}: cluster {i} differs")
            what = f"{n} clusters, files equal"
        elif kind in ("normal", "rows", "histogram", "fpfh"):
            a, b = np.load(pa), np.load(pb)
            expect(a.shape == b.shape, f"{tag} {name}: shapes {a.shape} and {b.shape}")
            if kind == "fpfh":
                # C19: the rows none of whose pairs lies within 1e-5 of a bin
                # edge (float64, the first run's normals), all within 1e-3
                firm = _r_fpfh_firm(argv[0], np.load(os.path.join(a_dir, "normal.npy")))
                err = float(np.abs(a - b)[firm].max()) if firm.any() else 0.0
                expect(firm.mean() >= 0.3 and err <= 1e-3 * np.abs(b).max(),
                       f"{tag} {name}: {firm.mean():.4f} of the rows firm, off by {err}")
                lines.append(f"{name}: {a.shape}, {firm.mean():.4f} of the rows firm (C19), "
                             f"max |diff| {err:.3e} there")
                continue
            if kind == "normal":
                share = float(((a * b).sum(1) >= 1 - 1e-5).mean())
                need = R_SHARES["normal"]
            elif kind == "rows":
                share = float((np.abs(a - b).max(1) <= 1e-3 * np.abs(b).max()).mean())
                need = R_SHARES["rows"]
            else:
                share = 1.0 - float(np.abs(a - b).sum() / max(np.abs(b).sum(), 1e-12))
                need = 0.98
            expect(share >= need, f"{tag} {name}: {share:.4f} agree, under {need}")
            what = f"{a.shape}, agreement {share:.4f}"
        elif kind == "codebook":
            # k-means over FPFH rows whose bins flip with the normals' last bits
            # (C19): the centroids move (printed, C102); the classes must agree,
            # and the next step holds what the codebook labels
            za, zb = np.load(pa), np.load(pb)
            err = float(np.abs(za["centroids"] - zb["centroids"]).max())
            sc = float(np.abs(zb["centroids"]).max())
            expect(np.array_equal(za["class_of"], zb["class_of"]),
                   f"{tag} {name}: the codebooks' classes differ")
            what = (f"{len(za['centroids'])} centroids of the same classes, max |diff| "
                    f"{err:.3e} of {sc:.1f} (printed)")
        elif kind == "labels":
            la, lb = (_r_cloud(p).attrs["label"].numpy() for p in (pa, pb))
            share = float((la == lb).mean())
            expect(share >= R_SHARES["labels"], f"{tag} {name}: {share:.4f} of the labels agree")
            what = f"{share:.4f} of {len(la)} labels agree"
        else:
            what = "printed lines equal"
        lines.append(f"{name}: {what}")
    return lines


def _r_fpfh_firm(cloud_path, normals):
    """FPFH's firm rows of a cloud file's valid points (``float64_cuts``:
    no pair of a point's or its neighbours' 16-NN within 1e-5 of a bin edge
    or of flipping its source)."""
    from pcl_tpu_torch.search import bruteforce

    F = float64_cuts()
    c = _r_cloud(cloud_path)
    xyz = c.xyz.numpy()[c.mask.numpy()]
    t = torch.from_numpy(xyz)
    idx, _, valid = bruteforce.knn(t, torch.ones(len(xyz), dtype=torch.bool), t, 16)
    idx, valid = idx.numpy(), valid.numpy()
    return F.fpfh_firm(F.spfh_firm(xyz, normals, idx, valid), idx, valid)


def _row_view(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a, np.float32).reshape(-1, 3))
    return a.view(np.dtype((np.void, 12))).ravel()


# the file and per-point tools whose files the card and the CPU write alike
# at full size (add_gaussian_noise draws on the device: compared with shared
# draws at the smaller size)
R_FILE_STEPS = ("convert_pcd_ascii_binary 0", "convert_pcd_ascii_binary 1",
                "convert_pcd_ascii_binary 2", "converter pcd to ply", "converter ply to pcd",
                "plyheader", "ply2raw", "pcd_introduce_nan", "pcd_convert_NaN_nan",
                "pcd_change_viewpoint", "transform_from_viewpoint",
                "transform_from_viewpoint inverse")


def path_r_checks(inp, out, expect):
    """Path R's checks on one run's files: ``uniform_sampling`` keeps input
    points, one per occupied cell; the ground of the progressive morphological
    filter keeps >= 0.95 of the street's ground voxels and none of the facade
    voxels 3.5 m up (path J's check); and, printed, the share of scan 1's
    ground voxels that the classifier labels ground (class 0)."""
    raw = _r_rows(inp["raw"])
    uni = _r_rows(os.path.join(out, "uniform.pcd"))
    leaf = np.float32(LEAF)

    def cells(p):
        return np.unique(np.floor(p / leaf).astype(np.int64), axis=0)

    expect(len(cells(uni)) == len(uni) == len(cells(raw)),
           f"uniform_sampling kept {len(uni)} points of {len(cells(raw))} occupied cells")
    expect(bool(np.isin(_row_view(uni), _row_view(raw)).all()),
           "uniform_sampling wrote a point that is not an input point")
    clean = _r_rows(os.path.join(out, "clean.pcd"))
    g = np.isin(_row_view(clean), _row_view(_r_rows(os.path.join(out, "ground.pcd"))))

    def ground_and_facade(p):
        return ((np.abs(p[:, 2] - R_GROUND_Z) <= 0.06) & (np.abs(p[:, 0]) <= 9.5),
                (np.abs(p[:, 0]) >= 9.95) & (p[:, 2] >= R_GROUND_Z + 3.5))

    on_ground, on_facade = ground_and_facade(clean)
    kept, facade = float(g[on_ground].mean()), float(g[on_facade].mean())
    expect(kept >= 0.95, f"the ground keeps {kept} of the street's ground voxels")
    expect(facade == 0.0, f"the ground takes {facade} of the facade voxels 3.5 m up")
    lab = _r_cloud(os.path.join(out, "labels.pcd"))
    xyz1, live = lab.xyz.numpy(), lab.mask.numpy()
    ground1 = ground_and_facade(xyz1)[0] & live
    share = float((lab.attrs["label"].numpy()[ground1] == 0).mean())
    return {"uniform": len(uni), "ground_kept": kept, "ground_voxels": int(on_ground.sum()),
            "facade_in_ground": facade, "facade_voxels": int(on_facade.sum()),
            "classifier_ground_share": share, "scan1_ground_voxels": int(ground1.sum()),
            "clusters": len([f for f in os.listdir(out) if f.startswith("cluster_")])}


def r_cast_line():
    """F8 on the card: torch's own float-to-int32 cast of values out of range
    (printed), and ``xla_int32`` of the same, which must equal the CPU's."""
    from pcl_tpu_torch.core.casts import xla_int32

    x = torch.tensor([3e9, -3e9, float("nan"), 1e20])
    card_raw = x.cuda().to(torch.int32).cpu().tolist()
    cpu_raw = x.to(torch.int32).tolist()
    card, cpu = xla_int32(x.cuda()).cpu().tolist(), xla_int32(x).tolist()
    check(card == cpu == [2147483647, -2147483648, 0, 2147483647],
          f"xla_int32 on the card {card}, on the CPU {cpu}")
    return (f"[3e9, -3e9, nan, 1e20].to(int32): card {card_raw}, CPU {cpu_raw}; xla_int32: "
            f"card {card}, CPU {cpu}")


def path_r_native(q_np, t_np, nn1_mod, expect, card, dev="cuda"):
    """The port's native host runtime on the card machine's host, built from
    ``csrc/pcl_native.cpp`` (a failed build raises): ``KdTree.knn(k=1)`` of
    ``q_np`` against ``t_np`` held to B1 on the card (indices equal off
    near-ties, d2 within 1e-6 of q^2 + t^2); ``knn(k=16)`` and ``radius`` on
    the first 20,000 queries against the port's brute searches on the card
    (sorted distances, counts off the radius' rounding); ``morton_encode``
    and ``voxel_centroids`` against their numpy fallbacks. Returns printed
    lines and each call's seconds."""
    from pcl_tpu_torch import native, search
    from pcl_tpu_torch.core.cloud import from_numpy
    from pcl_tpu_torch.ops import _build

    secs = {}
    lib, secs["build"] = timed(lambda: _build.host_library("pcl_native"))
    check(native.available(), "the native library did not load")
    tree, secs["KdTree"] = timed(lambda: native.KdTree(t_np))
    (d2, ii), secs["knn k=1"] = timed(lambda: tree.knn(q_np, 1))
    t, q = torch.from_numpy(t_np).to(dev), torch.from_numpy(q_np).to(dev)
    m = torch.ones(len(t), dtype=torch.bool, device=dev)
    ik, dk = (x.cpu().numpy() for x in nn1_mod.nn1(t, m, q))
    b1_ms = cuda_ms(lambda: nn1_mod.nn1(t, m, q), reps=5)
    scale = (q_np.astype(np.float64) ** 2).sum(1) + (t_np[ik].astype(np.float64) ** 2).sum(1)
    miss = ii[:, 0] != ik
    derr = np.abs(d2[:, 0].astype(np.float64) - dk)
    tie = np.abs(((q_np[miss] - t_np[ii[miss, 0]]).astype(np.float64) ** 2).sum(1)
                 - ((q_np[miss] - t_np[ik[miss]]).astype(np.float64) ** 2).sum(1))
    expect(bool((tie <= 1e-6 * scale[miss]).all()), "native 1-NN: indices differ off a near-tie")
    expect(bool((derr <= 1e-6 * scale).all()), f"native 1-NN: d2 differs by {derr.max()}")
    lines = [f"KdTree.knn(k=1) {len(q_np)} x {len(t_np)} against B1: {int(miss.sum())} indices "
             f"differ (near-ties), max |d2 diff| {derr.max():.3e} (scale "
             f"{scale.max():.1f}); B1 {b1_ms:.3f} ms [{card}]"]
    sub = q_np[:20000]
    (d16, _), secs["knn k=16"] = timed(lambda: tree.knn(sub, R_NATIVE_K))
    cloud = from_numpy(t_np, device=dev)
    _, s16, v16 = search.knn(cloud, torch.from_numpy(sub).to(dev), R_NATIVE_K, backend="brute")
    s16 = torch.where(v16, s16, torch.inf).cpu().numpy()
    err16 = float(np.abs(np.sort(d16, 1) - np.sort(s16, 1)).max())
    expect(err16 <= 1e-6 * float(scale.max()), f"native k-NN distances differ by {err16}")
    (dr, ir, cr), secs["radius"] = timed(lambda: tree.radius(sub, R_NATIVE_RADIUS,
                                                             cap=R_NATIVE_CAP))
    _, sr, vr, cnt = search.radius_search(cloud, torch.from_numpy(sub).to(dev), R_NATIVE_RADIUS,
                                          R_NATIVE_CAP, backend="brute")
    cnt = cnt.cpu().numpy()
    all_d2 = None
    edge = np.zeros(len(sub), bool)
    if (cnt != cr).any():
        rows = np.nonzero(cnt != cr)[0]
        all_d2 = ((sub[rows, None, :].astype(np.float64) - t_np[None]) ** 2).sum(-1)
        edge[rows] = (np.abs(all_d2 - R_NATIVE_RADIUS ** 2) <= 1e-6 * scale.max()).any(1)
    expect(bool((edge | (cnt == cr)).all()), "native radius counts differ off the radius")
    sr = torch.where(vr, sr, torch.inf).cpu().numpy()
    same = cnt == cr
    errr = float(np.abs(np.where(np.isfinite(dr), dr, 0) - np.where(np.isfinite(sr), sr, 0))[same]
                 .max()) if same.any() else 0.0
    expect(errr <= 1e-6 * float(scale.max()), f"native radius distances differ by {errr}")
    lines.append(f"knn(k={R_NATIVE_K}) and radius({R_NATIVE_RADIUS} m, cap {R_NATIVE_CAP}) of "
                 f"{len(sub)} queries against the port's brute searches on the card: max |d2 "
                 f"diff| {err16:.3e} and {errr:.3e}; counts differ on {int((~same).sum())} "
                 f"queries (a point on the radius), mean count {cr.mean():.1f}")
    codes, secs["morton_encode"] = timed(lambda: native.morton_encode(t_np))
    _, secs["morton_argsort"] = timed(lambda: native.morton_argsort(t_np))
    fb = native._morton_encode_numpy(t_np)

    def axes(c):
        out = np.zeros((len(c), 3), np.int64)
        for b in range(21):
            for a in range(3):
                out[:, a] |= ((c >> np.uint64(3 * b + a)) & np.uint64(1)).astype(np.int64) << b
        return out

    step = int(np.abs(axes(codes) - axes(fb)).max())
    expect(step <= 1, f"morton_encode {step} steps off the fallback")
    vc, secs["voxel_centroids"] = timed(lambda: native.voxel_centroids(t_np, LEAF))
    # the library bins by a float32 product with 1 / leaf, the fallback by a
    # quotient (C100): they are held on the points that no rounding puts in
    # another voxel (each axis 1e-4 of a cell from a boundary, or at the
    # minimum, which keeps the grid's origin)
    u = (t_np.astype(np.float64) - t_np.min(0)) / LEAF
    firm = ((np.abs(u - np.round(u)) > 1e-4) | (u == 0)).all(1)
    va = native.voxel_centroids(t_np[firm], LEAF)
    vf = native._voxel_centroids_numpy(t_np[firm], LEAF)
    # both list the voxels in the order of their keys (x major)
    verr = float(np.abs(va - vf).max()) if va.shape == vf.shape else math.inf
    expect(verr <= 1e-6 * float(np.abs(t_np).max()),
           f"voxel_centroids differ from the fallback by {verr} ({len(va)} and {len(vf)} voxels)")
    lines.append(f"morton_encode: {int((codes == fb).sum())} of {len(fb)} codes equal to the "
                 f"fallback's, the rest one step off on an axis; voxel_centroids: {len(vc)} "
                 f"voxels; on the {int(firm.sum())} points 1e-4 of a cell off its boundaries "
                 f"{len(va)} voxels, max |diff| {verr:.3e} m against the fallback; library "
                 f"{os.path.basename(lib._name)}")
    return lines, secs


def phase20_path_r(segsum, nn1_mod, scans, golden, record_b1, record_b2):
    """Path R: the last 25 CLIs chained as a PCL user chains them on path C's
    scan and path G's frame, and the native host runtime against B1."""
    from pcl_tpu_torch.search import bruteforce

    failed = []

    def expect(cond: bool, what: str) -> None:
        if not cond:
            print(f"phase 20: CHECK FAILED: {what}", flush=True)
            failed.append(what)

    card = card_line()
    dev = torch.device("cuda")
    print(f"phase 20: F8: {r_cast_line()}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        d = {k: os.path.join(tmp, k) for k in ("in", "card", "cpu", "in_small", "card_small",
                                                "cpu_small")}
        for p in d.values():
            os.makedirs(p)
        inp, isecs = timed(lambda: path_r_inputs(scans, golden, R_FULL, d["in"]))
        small = path_r_inputs(scans, golden, R_CPU, d["in_small"])
        print(f"phase 20: inputs in {isecs:.1f} s: {R_FULL['points']} and {R_CPU['points']} "
              f"points, frames {R_FULL['frame']['shape']} and {R_CPU['frame']['shape']}",
              flush=True)
        # the card against the CPU at the smaller size, the same host draws for
        # both, each CPU step on the card's inputs (also the warm-up)
        res_a, asecs = timed(lambda: path_r_chain(small, d["card_small"],
                                                  port_runner(dev, host_draws)))
        res_b, bsecs = timed(lambda: path_r_chain(small, d["cpu_small"],
                                                  port_runner("cpu", host_draws),
                                                  src=d["card_small"]))
        for line in path_r_compare(small, d["card_small"], d["cpu_small"], res_a, res_b, expect,
                                   "card against CPU:"):
            print(f"phase 20: card against CPU at {R_CPU['points']} points: {line}", flush=True)
        print(f"phase 20: the small chain took {asecs:.1f} s on the card, {bsecs:.1f} s on the "
              f"CPU", flush=True)
        # the main path
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trace.reset()
        starts = {}

        def on_step(name):
            calls["stage"] = name
            starts[name] = (launch_count("nn1"), launch_count("segsum"))

        with kernel_calls(bruteforce, segsum) as calls:
            res, total = timed(lambda: path_r_chain(inp, d["card"], port_runner(dev),
                                                    on_step=on_step))
        b1, b2 = launch_count("nn1"), launch_count("segsum")
        record_b1["launches_by_path"]["R"] = b1
        record_b2["launches_by_path"]["R"] = b2
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        names = list(res)
        ends = [starts[n] for n in names[1:]] + [(b1, b2)]
        per = {n: (res[n][1], e[0] - starts[n][0], e[1] - starts[n][1])
               for n, e in zip(names, ends)}
        print(f"phase 20: path R, {len(names)} CLI calls, in {total:.1f} s, peak memory "
              f"{peak:.2f} GiB, launches nn1 {b1}, segsum {b2} [{card}]", flush=True)
        for n, (s, l1, l2) in per.items():
            print(f"phase 20: {n}: {s * 1e3:.1f} ms, B1 {l1}, B2 {l2} [{card}]", flush=True)
        expect(per["voxel_grid"][2] == 1 and per["voxel_grid scan 1"][2] == 1,
               "tools.voxel_grid did not launch B2 once a scan")
        expect(len(calls["nn1"]) == b1 and len(calls["segsum"]) == b2,
               "the kept kernel calls do not match the launch counts")
        m = path_r_checks(inp, d["card"], expect)
        print("phase 20: checks " + json.dumps(m), flush=True)
        # the file tools at full size on the CPU, on the card's inputs
        res_f = path_r_chain(inp, d["cpu"], port_runner("cpu"), src=d["card"],
                             only=R_FILE_STEPS)
        for line in path_r_compare(inp, d["card"], d["cpu"], res, res_f, expect,
                                   "file tools, card against CPU:", only=R_FILE_STEPS):
            print(f"phase 20: file tools at full size, card against CPU: {line}", flush=True)
        rows1, rows2 = hold_to_plain(calls, nn1_mod, segsum, expect, "phase 20:", 1 << 15, card,
                                     time_once="stage")
        raw, raw1 = _r_rows(inp["raw"]), _r_rows(inp["raw1"])
    lines, nsecs = path_r_native(raw1, raw, nn1_mod, expect, card)
    for line in lines:
        print(f"phase 20: native: {line}", flush=True)
    print("phase 20: native seconds " + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in nsecs.items())
          + f" [{card}]", flush=True)
    record_b1["path_r"] = rows1
    record_b2["path_r"] = rows2
    check(not failed, "path R: " + "; ".join(failed))
    return {"total_s": total, "peak_gib": peak, "checks": m, "native": nsecs}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--path-i-rank"]:
        return path_i_rank(int(sys.argv[2]), sys.argv[3])
    import pcl_tpu_torch  # noqa: F401  (sets full-float32 matmuls)
    from pcl_tpu_torch.ops import _build
    from pcl_tpu_torch.ops import nn1 as nn1_mod
    from pcl_tpu_torch.ops import segsum
    from pcl_tpu_torch.registration import trajectory

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"set-up: built {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for lib in libs:
        for line in _build.build_log(lib.name.split("-")[0]).splitlines():
            if "registers" in line or "spill" in line:
                print(f"set-up: {lib.name}: {line.strip()}", flush=True)
    t0 = time.perf_counter()
    street = make_street()
    scans, golden = trajectory.make_virtual_scan_sequence(
        street, N_SCANS, np.random.default_rng(0), **SEQUENCE_KW)
    print(f"set-up: street of {SCENE_POINTS} points, {N_SCANS} scans of "
          f"{[len(s) for s in scans]} points in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    alley_scene = make_street(ALLEY_SEED, alleys=True)
    alley = trajectory.make_virtual_scan_sequence(
        alley_scene, ALLEY_SCANS, np.random.default_rng(ALLEY_SEED), **SEQUENCE_KW)
    print(f"set-up: street with alleys, {ALLEY_SCANS} scans of {[len(a) for a in alley[0]]} "
          f"points in {time.perf_counter() - t0:.1f} s", flush=True)

    src, tgt, M = make_pair(N_POINTS)
    clock = [time.perf_counter()]

    def lap(name):
        clock.append(time.perf_counter())
        print(f"{name} took {clock[-1] - clock[-2]:.1f} s", flush=True)

    record = phase1_nn1(nn1_mod, src, tgt)
    lap("phase 1")
    ms_a = phase2_path_a(nn1_mod, src, tgt, M, record)
    lap("phase 2")
    ms_b = phase3_path_b(src, tgt, M)
    lap("phase 3")
    record_b2 = phase4_segsum(segsum, scans[0])
    lap("phase 4")
    ms_pair, ate = phase5_path_c(segsum, nn1_mod, scans, golden, record, record_b2)
    lap("phase 5")
    ms_gicp, ate_gicp, ms_ndt, ate_ndt = phase6_path_d(segsum, nn1_mod, scans, golden, alley,
                                                       src, tgt, M, record, record_b2)
    lap("phase 6")
    stages_e = phase7_path_e(segsum, nn1_mod, street, record, record_b2)
    lap("phase 7")
    out_f = phase8_path_f(segsum, nn1_mod, street, record, record_b2)
    lap("phase 8")
    out_g = phase9_path_g(segsum, nn1_mod, record, record_b2)
    lap("phase 9")
    parts_h = phase10_path_h(segsum, nn1_mod, street, alley_scene, scans, golden, record,
                             record_b2)
    lap("phase 10")
    table_i = phase11_path_i(segsum, nn1_mod, scans, golden, src, tgt, M, record, record_b2)
    lap("phase 11")
    out_j = phase12_path_j(segsum, nn1_mod, scans, golden, record, record_b2)
    lap("phase 12")
    times_k = phase13_path_k(segsum, nn1_mod, street, record, record_b2)
    lap("phase 13")
    out_l = phase14_path_l(segsum, nn1_mod, record, record_b2)
    lap("phase 14")
    out_m = phase15_path_m(segsum, nn1_mod, scans, golden, record, record_b2)
    lap("phase 15")
    out_n = phase16_path_n(segsum, nn1_mod, record, record_b2)
    lap("phase 16")
    out_o = phase17_path_o(segsum, nn1_mod, record, record_b2)
    lap("phase 17")
    out_p = phase18_path_p(segsum, nn1_mod, record, record_b2)
    lap("phase 18")
    out_q = phase19_path_q(segsum, nn1_mod, record, record_b2)
    lap("phase 19")
    out_r = phase20_path_r(segsum, nn1_mod, scans, golden, record, record_b2)
    lap("phase 20")
    for rec in (record, record_b2):
        # launches on the main paths: A (brute ICP), C (front end), D (GICP,
        # NDT), E (global registration), F (pose graph), G (KinFu: none),
        # H (the rest of registration), I (the sharded functions, one rank),
        # J (the filter front end), K (descriptors, keypoints, clusters),
        # L (surface reconstruction and segmentation), M (the octree, range
        # images and NARF), N (recognition), O (people, CRF and tracking),
        # P (stereo, organized edges, image extractors, meshes), Q (a Velodyne
        # drive stored out of core, compressed and shown), R (the last CLIs)
        rec["launches"] = sum(rec["launches_by_path"].values())
        check(rec["launches"] > 0, f"no main path launched the {rec['name']} kernel")
    print(f"summary: path A {ms_a:.3f} ms/iteration, path B {ms_b:.3f} ms/iteration, "
          f"path C {ms_pair:.3f} ms per ICP pair, ATE {ate:.6f} m; path D GICP {ms_gicp:.3f} ms "
          f"per pair, ATE {ate_gicp:.6f} m, NDT {ms_ndt:.3f} ms per pair, ATE {ate_ndt:.6f} m; "
          f"nn1 {record['ms']:.3f} "
          f"ms/sweep (bound {record['bound_ms']:.3f} ms, plain {record['plain_ms']:.1f} ms); "
          f"segsum {record_b2['ms'] * 1e3:.1f} us (bound {record_b2['bound_ms'] * 1e3:.2f} us, "
          f"plain {record_b2['plain_ms'] * 1e3:.1f} us, library "
          f"{record_b2['library_ms'] * 1e3:.1f} us); path E stages (two scans) "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in stages_e.items())
          + f"; path F ATE {out_f['ate'][0]:.4f} -> {out_f['ate'][1]:.4f} m, KITTI-size graph "
          + ", ".join(f"{n} {ms:.1f} ms/iteration" for n, ms, _ in out_f["kitti"])
          + f"; path G {out_g['ms_frame']:.1f} ms per frame, ATE {out_g['ate']:.5f} m, peak "
          f"{out_g['peak_gib']:.2f} GiB; path H "
          + ", ".join(f"{n} {v['s'] * 1e3:.1f} ms" for n, v in parts_h.items())
          + "; path I ms per unit (one rank / two ranks) "
          + ", ".join(f"{c['call']} {c['ms_one_rank']:.2f} / {c['ms_two_ranks']:.2f}"
                      for c in table_i)
          + f"; path J ATE {out_j['ate']:.6f} m, "
          + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in out_j.items() if k != "ate")
          + "; path K ms per scan "
          + ", ".join(f"{k} {v[0] * 1e3:.1f}/{v[1] * 1e3:.1f}" for k, v in times_k.items())
          + f"; path L {out_l['total_s']:.1f} s, peak {out_l['peak_gib']:.2f} GiB"
          + f"; path M {out_m['total_s']:.2f} s, peak {out_m['peak_gib']:.2f} GiB"
          + f"; path N {out_n['total_s']:.1f} s, peak {out_n['peak_gib']:.2f} GiB"
          + f"; path O {out_o['total_s']:.1f} s, peak {out_o['peak_gib']:.2f} GiB"
          + f"; path P {out_p['total_s']:.1f} s, peak {out_p['peak_gib']:.2f} GiB"
          + f"; path Q {out_q['total_s']:.1f} s, peak {out_q['peak_gib']:.2f} GiB"
          + f"; path R {out_r['total_s']:.1f} s, peak {out_r['peak_gib']:.2f} GiB, native k=1 "
          f"{out_r['native']['knn k=1'] * 1e3:.1f} ms [{card}]",
          flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [record, record_b2]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
