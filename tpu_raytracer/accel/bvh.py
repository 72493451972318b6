"""SAH-style BVH construction, numpy-vectorized (host side).

Functional re-implementation of the reference builder
(reference: CudaRaytracer/BVHTree.hpp:59-361) with a flat array output
format:

  * Node boxes are grown from triangle *vertices*; splits partition by
    triangle *centroid* (BVHTree.hpp:203-292).
  * 5 uniform candidate positions per axis at fractions (s+1)/6 of the
    node extent (BVHTree.hpp:294-361, tests_per_axis = 5).
  * cost = half_surface_area * count, empty box = +inf
    (BVHTree.hpp:192-201).
  * Axis selection uses the reference's exact if/elif/else chain
    (BVHTree.hpp:229-243) including its tie behavior.
  * Split accepted only if best_cost < cost(node) (BVHTree.hpp:246-247);
    recursion stops at depth >= max_depth (default and ceiling
    MAX_BVH_DEPTH = 48; the reference call site uses 32,
    MeshPrimitive.cpp:54, but deep grid scenes like the 627k-tri
    colonnade need ~33-40 — every traversal stack is sized from
    MAX_BVH_DEPTH), at <=1 triangle, or on a one-sided partition
    (BVHTree.hpp:279-280).
  * Children are appended depth-first (left subtree first), so node 0 is
    always the root (BVHTree.hpp:283-289).

Unlike the reference's per-leaf cudaMalloc'd index lists
(BVHTree.hpp:103-111), triangles are REORDERED so every leaf owns a
contiguous [start, start+count) range of the triangle array — the flat
arrays below upload to the device as-is and leaves become dense slices.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_INF = np.float32(np.inf)

# Deepest node any builder makes (the root has depth 1). The traversal
# stacks (render/renderer.STACK_SIZE, native/traverse.h kMaxDepth) are
# sized from it, so MeshPrimitive rejects a deeper max_depth.
MAX_BVH_DEPTH = 48


@dataclasses.dataclass
class BVHArrays:
    """Flat SoA BVH. ``order`` maps new triangle index -> original index."""

    node_min: np.ndarray  # [N, 3] f32
    node_max: np.ndarray  # [N, 3] f32
    child_a: np.ndarray  # [N] i32, -1 for leaf
    child_b: np.ndarray  # [N] i32, -1 for leaf
    leaf_start: np.ndarray  # [N] i32 (0 for internal)
    leaf_count: np.ndarray  # [N] i32 (0 for internal)
    order: np.ndarray  # [T] i32 permutation

    @property
    def num_nodes(self) -> int:
        return len(self.child_a)

    def stats(self) -> dict:
        """BVH diagnostics (reference print_stats, BVHTree.hpp:117-172)."""
        is_leaf = self.child_a < 0
        counts = self.leaf_count[is_leaf]
        depth = np.zeros(self.num_nodes, np.int32)
        for i in range(self.num_nodes):  # parents precede children (DFS order)
            if self.child_a[i] >= 0:
                depth[self.child_a[i]] = depth[i] + 1
                depth[self.child_b[i]] = depth[i] + 1
        return {
            "num_nodes": self.num_nodes,
            "num_leaves": int(is_leaf.sum()),
            "max_triangles_per_leaf": int(counts.max()) if len(counts) else 0,
            "min_triangles_per_leaf": int(counts.min()) if len(counts) else 0,
            "max_depth": int(depth.max()),
            "avg_triangles_per_leaf": float(counts.mean()) if len(counts) else 0.0,
        }


def _half_area(mn: np.ndarray, mx: np.ndarray) -> np.ndarray:
    """Half surface area of AABBs; elementwise over leading dims
    (BVHTree.hpp:197-200)."""
    size = mx - mn
    return size[..., 0] * (size[..., 1] + size[..., 2]) + size[..., 1] * size[..., 2]


def _eval_axis(cent_ax, tmin, tmax, node_min_ax, node_max_ax, tests_per_axis):
    """Best (cost, split_pos) over candidate positions on one axis,
    vectorized over all candidates at once (BVHTree.hpp:294-361)."""
    s = np.arange(tests_per_axis, dtype=np.float32)
    pos = node_min_ax + (node_max_ax - node_min_ax) * ((s + 1.0) / (tests_per_axis + 1.0))
    in_left = cent_ax[None, :] <= pos[:, None]  # [S, n]

    def side_cost(mask):
        count = mask.sum(axis=1)
        sel = mask[:, :, None]
        mn = np.min(np.where(sel, tmin[None], _INF), axis=1)
        mx = np.max(np.where(sel, tmax[None], -_INF), axis=1)
        with np.errstate(invalid="ignore"):  # empty side: inf-box * 0
            cost = _half_area(mn, mx) * count
        return np.where(count == 0, _INF, cost)

    cost = side_cost(in_left) + side_cost(~in_left)
    best = int(np.argmin(cost))  # first minimum, like the reference's strict <
    return float(cost[best]), float(pos[best])


def _eval_axis_sweep(cent_ax, tmin, tmax):
    """Exact SAH sweep over one axis: every split position between
    centroid-sorted neighbours is costed via prefix/suffix box areas.

    Beyond-reference quality mode (the reference tests only 5 uniform
    positions per axis, BVHTree.hpp:297-303); returns
    (best_cost, split_after_k, sort_order). Cost model is identical to
    the reference's half_area * count, so the no-gain termination in
    ``fill`` applies unchanged."""
    n = len(cent_ax)
    ordr = np.argsort(cent_ax, kind="stable")
    mn_s = tmin[ordr]
    mx_s = tmax[ordr]
    lmn = np.minimum.accumulate(mn_s, axis=0)
    lmx = np.maximum.accumulate(mx_s, axis=0)
    rmn = np.minimum.accumulate(mn_s[::-1], axis=0)[::-1]
    rmx = np.maximum.accumulate(mx_s[::-1], axis=0)[::-1]
    counts = np.arange(1, n, dtype=np.float32)
    cost = _half_area(lmn[:-1], lmx[:-1]) * counts + _half_area(
        rmn[1:], rmx[1:]
    ) * (np.float32(n) - counts)
    k = int(np.argmin(cost))
    return float(cost[k]), k, ordr


def sah_cost(bvh: BVHArrays, c_trav: float = 1.0, c_isect: float = 1.0) -> float:
    """Standard SAH tree cost: expected work for a random ray,
    sum(A(node)/A(root)) * c_trav over internal nodes plus
    sum(A(leaf)/A(root) * count) * c_isect over leaves. Diagnostic for
    comparing builder modes (lower = fewer expected node visits)."""
    area = _half_area(bvh.node_min, bvh.node_max)
    root = max(float(area[0]), 1e-30)
    is_leaf = bvh.child_a < 0
    return float(
        c_trav * area[~is_leaf].sum() / root
        + c_isect * (area[is_leaf] * bvh.leaf_count[is_leaf]).sum() / root
    )


# Nodes above this size always split (see the forced-split note in fill)
FORCE_SPLIT_ABOVE = 512


def build_bvh(
    v0: np.ndarray,
    v1: np.ndarray,
    v2: np.ndarray,
    max_depth: int = MAX_BVH_DEPTH,
    tests_per_axis: int = 5,
    min_leaf_size: int = 1,
    mode: str = "reference",
    refs=None,
) -> BVHArrays:
    """Build a BVH over triangles given as three [T, 3] vertex arrays.

    ``min_leaf_size``: stop splitting below this count (the reference
    stops at 1, BVHTree.hpp:214; larger values trade node visits for
    triangle tests, a traversal tuning knob).

    ``refs``: optional ``(ref_tri, ref_min, ref_max)`` from
    ``presplit.presplit_refs`` — the build then partitions split
    REFERENCES (box centers as centroids, clipped boxes as bounds) and
    the returned ``order`` maps leaf slots to original triangles WITH
    DUPLICATES. Everything downstream fancy-indexes per-triangle arrays
    by ``order``, so duplicated refs are transparent.

    ``mode``: "reference" reproduces the reference's 5-candidate
    uniform split search exactly (BVHTree.hpp:294-361); "sweep" costs
    EVERY centroid-sorted split position per axis (exact SAH sweep) —
    a beyond-reference quality mode producing cheaper trees (lower SAH
    cost, fewer expected node visits). Same cost model and
    termination rules. A tree change can only affect the image at
    EXACT t-ties (shared mesh edges, where traversal order breaks the
    tie) — sub-pixel-rare on primary rays, but a path tracer amplifies
    one flipped edge hit into downstream bounce differences, so
    goldens are regenerated when the default builder changes."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    if refs is not None:
        ref_tri, tri_min, tri_max = refs
        ref_tri = np.asarray(ref_tri, np.int64)
        tri_min = np.asarray(tri_min, np.float32)
        tri_max = np.asarray(tri_max, np.float32)
        num_tris = len(ref_tri)
        centroids = np.float32(0.5) * (tri_min + tri_max)
    else:
        ref_tri = None
        num_tris = len(v0)
        centroids = (v0 + v1 + v2) / np.float32(3.0)
        tri_min = np.minimum(np.minimum(v0, v1), v2)
        tri_max = np.maximum(np.maximum(v0, v1), v2)

    node_min, node_max = [], []
    child_a, child_b = [], []
    leaf_start, leaf_count = [], []
    order: list[np.ndarray] = []
    order_len = 0

    def new_node(mn, mx):
        node_min.append(mn)
        node_max.append(mx)
        child_a.append(-1)
        child_b.append(-1)
        leaf_start.append(0)
        leaf_count.append(0)
        return len(child_a) - 1

    def make_leaf(node_id, idx):
        nonlocal order_len
        leaf_start[node_id] = order_len
        leaf_count[node_id] = len(idx)
        order.append(idx)
        order_len += len(idx)

    def fill(idx: np.ndarray, depth: int) -> int:
        mn = tri_min[idx].min(axis=0)
        mx = tri_max[idx].max(axis=0)
        node_id = new_node(mn, mx)

        if depth >= max_depth or len(idx) <= max(min_leaf_size, 1):
            make_leaf(node_id, idx)
            return node_id

        cent = centroids[idx]
        if mode == "sweep":
            sevals = [
                _eval_axis_sweep(cent[:, ax], tri_min[idx], tri_max[idx])
                for ax in range(3)
            ]
            axis = int(np.argmin([e[0] for e in sevals]))
            best_cost, split_k, split_ord = sevals[axis]
        else:
            evals = [
                _eval_axis(cent[:, ax], tri_min[idx], tri_max[idx], mn[ax], mx[ax], tests_per_axis)
                for ax in range(3)
            ]
            (cx, px), (cy, py), (cz, pz) = evals
            # Exact axis-selection chain from BVHTree.hpp:229-243 (ties -> z).
            if cx < cy and cx < cz:
                axis, split_pos, best_cost = 0, px, cx
            elif cy < cx and cy < cz:
                axis, split_pos, best_cost = 1, py, cy
            else:
                axis, split_pos, best_cost = 2, pz, cz

        node_cost = float(_half_area(mn, mx) * len(idx))
        # Forced split for oversized nodes: the reference's strict
        # no-gain stop (best_cost < cost(), BVHTree.hpp:246-247) dead-
        # locks on uniform thin slabs — splitting a slab in half gives
        # EXACTLY equal half-area*count — which at Sponza scale (e.g.
        # the 1M-tri colonnade, one z-band spanning every column)
        # produces leaves of many thousands of triangles.
        # Nodes above FORCE_SPLIT_ABOVE split regardless, falling back
        # to a stable median split on the longest axis when the SAH
        # candidate is one-sided.
        oversized = len(idx) > FORCE_SPLIT_ABOVE
        if best_cost >= node_cost and not oversized:
            make_leaf(node_id, idx)
            return node_id

        if mode == "sweep":
            # sorted-order partition: both sides always nonempty
            left_idx = idx[split_ord[: split_k + 1]]
            right_idx = idx[split_ord[split_k + 1:]]
            child_a[node_id] = fill(left_idx, depth + 1)
            child_b[node_id] = fill(right_idx, depth + 1)
            return node_id

        left_mask = cent[:, axis] <= split_pos
        left_idx = idx[left_mask]
        right_idx = idx[~left_mask]
        if len(left_idx) == 0 or len(right_idx) == 0:
            if not oversized:
                make_leaf(node_id, idx)
                return node_id
            ax2 = int(np.argmax(mx - mn))
            med = np.argsort(cent[:, ax2], kind="stable")
            half = len(idx) // 2
            left_idx = idx[med[:half]]
            right_idx = idx[med[half:]]

        child_a[node_id] = fill(left_idx, depth + 1)
        child_b[node_id] = fill(right_idx, depth + 1)
        return node_id

    if num_tris == 0:
        nid = new_node(np.full(3, _INF), np.full(3, -_INF))
        make_leaf(nid, np.arange(0, dtype=np.int64))
    else:
        fill(np.arange(num_tris, dtype=np.int64), 1)

    order_arr = (
        np.concatenate(order).astype(np.int64)
        if order_len
        else np.zeros(0, np.int64)
    )
    if ref_tri is not None:
        order_arr = ref_tri[order_arr]  # ref slot -> original triangle
    return BVHArrays(
        node_min=np.asarray(node_min, np.float32),
        node_max=np.asarray(node_max, np.float32),
        child_a=np.asarray(child_a, np.int32),
        child_b=np.asarray(child_b, np.int32),
        leaf_start=np.asarray(leaf_start, np.int32),
        leaf_count=np.asarray(leaf_count, np.int32),
        order=order_arr.astype(np.int32),
    )
