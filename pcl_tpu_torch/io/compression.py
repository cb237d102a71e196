"""Octree point-cloud compression.

Re-design of pcl::io::OctreePointCloudCompression (reference: io/include/
pcl/compression/octree_pointcloud_compression.h:66, entropy coding at
entropy_range_coder.h). The format here:

  header (resolution, origin, depth, point count)
  + breadth-first child-occupancy bitmask stream (1 byte per occupied
    node, exactly the reference's octree serialization idea)
  + LZF over the bitmask stream (replacing the adaptive range coder with
    the codec this library already ships; both are entropy backends over
    the same structural stream)

Decoding reproduces the occupied leaf voxel CENTERS at the chosen
resolution — the same lossy contract as the reference's voxel-grade
profiles (point-detail layers are future work).

Host-side numpy (compression is file/stream IO, like pcd.py).

Counterpart of ``pcl_tpu/io/compression.py``: a copy of its numpy code (the
uint64 Morton keys and ``np.bitwise_or.at`` included) over the port's LZF
codec, so that streams are the JAX package's byte for byte. The decoded
voxel centres are placed on ``device`` (default CUDA).
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from pcl_tpu_torch.core.cloud import Cloud, from_numpy, to_numpy
from pcl_tpu_torch.io import lzf

_MAGIC = b"PTOC1\x00"


def _morton_np(cells: np.ndarray, depth: int) -> np.ndarray:
    """[N,3] uint -> [N] uint64 morton keys (numpy, up to depth 21)."""
    def spread(v):
        v = v.astype(np.uint64) & np.uint64(0x1FFFFF)
        v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
        return v

    return (spread(cells[:, 0]) | (spread(cells[:, 1]) << np.uint64(1))
            | (spread(cells[:, 2]) << np.uint64(2)))


def _demorton_np(keys: np.ndarray) -> np.ndarray:
    def compact(v):
        v = v & np.uint64(0x1249249249249249)
        v = (v | (v >> np.uint64(2))) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v >> np.uint64(4))) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v >> np.uint64(8))) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v >> np.uint64(16))) & np.uint64(0x1F00000000FFFF)
        v = (v | (v >> np.uint64(32))) & np.uint64(0x1FFFFF)
        return v

    return np.stack([
        compact(keys), compact(keys >> np.uint64(1)), compact(keys >> np.uint64(2))
    ], axis=1)


def _encode_bitmasks(leaf_keys: np.ndarray, depth: int) -> bytes:
    """Sorted unique leaf morton keys -> BFS child-bitmask byte stream."""
    out = bytearray()
    level_keys = leaf_keys  # keys at the deepest level
    streams = []
    for level in range(depth, 0, -1):
        parents = level_keys >> np.uint64(3)
        children = (level_keys & np.uint64(7)).astype(np.int64)
        # group by parent (keys sorted => parents sorted)
        uniq, start = np.unique(parents, return_index=True)
        masks = np.zeros(len(uniq), np.uint8)
        # scatter child bits
        pidx = np.searchsorted(uniq, parents)
        np.bitwise_or.at(masks, pidx, (1 << children).astype(np.uint8))
        streams.append(masks.tobytes())
        level_keys = uniq
    # root-first order
    for s in reversed(streams):
        out.extend(s)
    return bytes(out)


def _decode_bitmasks(data: bytes, depth: int) -> np.ndarray:
    """BFS bitmask stream -> sorted leaf morton keys."""
    pos = 0
    keys = np.zeros(1, np.uint64)          # the root
    buf = np.frombuffer(data, np.uint8)
    for level in range(depth):
        masks = buf[pos:pos + len(keys)]
        pos += len(keys)
        # expand each node's set child bits
        bits = np.unpackbits(masks.reshape(-1, 1), axis=1, bitorder="little")  # [P,8]
        pidx, child = np.nonzero(bits)
        keys = (keys[pidx] << np.uint64(3)) | child.astype(np.uint64)
    return keys


def compress_cloud(
    cloud: Cloud,
    resolution: float,
    depth: Optional[int] = None,
) -> bytes:
    """Encode the cloud's occupied voxels at ``resolution``."""
    xyz, _ = to_numpy(cloud, compact=True)
    if len(xyz) == 0:
        raise ValueError("empty cloud")
    origin = xyz.min(axis=0)
    cells = np.floor((xyz - origin) / resolution).astype(np.uint64)
    if depth is None:
        depth = max(1, int(np.ceil(np.log2(max(float(cells.max()) + 1, 2)))))
    if cells.max() >= (1 << depth):
        raise ValueError("depth too small for the cloud extent")
    keys = np.unique(_morton_np(cells, depth))
    stream = _encode_bitmasks(keys, depth)
    comp = lzf.compress(stream)
    if comp is None or len(comp) >= len(stream):
        body = b"\x00" + stream
    else:
        body = b"\x01" + comp
    header = _MAGIC + struct.pack(
        "<fdddiII", resolution, *map(float, origin), depth, len(keys), len(stream)
    )
    return header + body


def decompress_cloud(data: bytes, capacity: Optional[int] = None, device=None) -> Cloud:
    """Decode to voxel centers."""
    if not data.startswith(_MAGIC):
        raise ValueError("not a pcl_tpu compressed cloud")
    off = len(_MAGIC)
    resolution, ox, oy, oz, depth, n_leaves, raw_len = struct.unpack(
        "<fdddiII", data[off:off + struct.calcsize("<fdddiII")]
    )
    off += struct.calcsize("<fdddiII")
    mode = data[off]; off += 1
    body = data[off:]
    stream = body if mode == 0 else lzf.decompress(body, raw_len)
    keys = _decode_bitmasks(stream, depth)
    assert len(keys) == n_leaves, (len(keys), n_leaves)
    cells = _demorton_np(np.sort(keys))
    origin = np.array([ox, oy, oz], np.float64)
    centers = (cells.astype(np.float64) + 0.5) * resolution + origin
    return from_numpy(centers.astype(np.float32), capacity=capacity, device=device)
