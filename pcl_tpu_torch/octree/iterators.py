"""Octree traversal iterators over the linear (sorted-morton) octree.

Counterpart of ``pcl_tpu/octree/iterators.py`` (reference
octree_iterator.h: depth-first, leaf, breadth-first, fixed-depth and
leaf breadth-first iterators). A node at depth d is a distinct key prefix
``key >> 3 (depth - d)``; depth-first preorder is ascending prefixes with
parents first, breadth-first the same set by depth. Host generators: the
leaf keys are read back once a call and walked in numpy.
"""

from __future__ import annotations

from typing import Iterator, List, NamedTuple

import numpy as np

from pcl_tpu_torch.octree.linear import LinearOctree


class OctreeNode(NamedTuple):
    key: int        # morton prefix at this node's depth
    depth: int      # 0 = root
    is_leaf: bool


def _leaf_keys(tree: LinearOctree) -> np.ndarray:
    keys = tree.keys.cpu().numpy()
    mask = tree.mask.cpu().numpy()
    return np.unique(keys[mask])


def _all_nodes(leaves: np.ndarray, max_d: int) -> List[np.ndarray]:
    """Unique node prefixes per depth: ``[depth] -> sorted prefixes``."""
    return [np.unique(leaves >> (3 * (max_d - d))) for d in range(max_d + 1)]


def leaf_iterator(tree: LinearOctree) -> Iterator[OctreeNode]:
    """Leaf-node depth-first iterator: ascending morton order is the
    preorder leaf sequence."""
    for k in _leaf_keys(tree):
        yield OctreeNode(int(k), tree.depth, True)


def depth_first_iterator(tree: LinearOctree) -> Iterator[OctreeNode]:
    """Full preorder traversal: every branch node just before its children,
    children in ascending octant order."""
    leaves = _leaf_keys(tree)
    max_d = tree.depth

    def walk(prefix: int, depth: int, lo: int, hi: int):
        yield OctreeNode(prefix, depth, depth == max_d)
        if depth == max_d:
            return
        shift = 3 * (max_d - depth - 1)
        child = leaves[lo:hi] >> shift
        for oct_ in np.unique(child):
            s = lo + int(np.searchsorted(child, oct_, "left"))
            e = lo + int(np.searchsorted(child, oct_, "right"))
            yield from walk(int(oct_), depth + 1, s, e)

    if len(leaves):
        yield from walk(0, 0, 0, len(leaves))


def breadth_first_iterator(tree: LinearOctree) -> Iterator[OctreeNode]:
    """Depths ascending, ascending prefixes within a depth."""
    leaves = _leaf_keys(tree)
    if len(leaves) == 0:
        return
    for d, prefixes in enumerate(_all_nodes(leaves, tree.depth)):
        for p in prefixes:
            yield OctreeNode(int(p), d, d == tree.depth)


def fixed_depth_iterator(tree: LinearOctree, depth: int) -> Iterator[OctreeNode]:
    """All nodes of one depth."""
    if depth < 0 or depth > tree.depth:
        raise ValueError(f"depth {depth} outside [0, {tree.depth}]")
    leaves = _leaf_keys(tree)
    for p in np.unique(leaves >> (3 * (tree.depth - depth))):
        yield OctreeNode(int(p), depth, depth == tree.depth)


def leaf_breadth_first_iterator(tree: LinearOctree) -> Iterator[OctreeNode]:
    """Leaves in breadth-first order: every leaf is at the tree's depth, so
    this is ascending key order, as the depth-first leaf iterator."""
    yield from leaf_iterator(tree)


def node_counts_per_depth(tree: LinearOctree) -> List[int]:
    """Number of nodes at each depth ``0 .. depth``."""
    return [len(p) for p in _all_nodes(_leaf_keys(tree), tree.depth)]
