"""Insertion-based BVH optimization (host-side post-pass).

Beyond-reference tree-quality mode, after Bittner et al. 2013 ("Fast
Insertion-Based Optimization of Bounding Volume Hierarchies"): remove
high-inefficiency internal nodes and re-insert their two child
subtrees at the globally best position found by a branch-and-bound
search over the whole tree. A lower SAH cost means fewer expected node
visits per ray, most of all for incoherent (bounce) rays.

Operates purely on the flat ``BVHArrays``: leaves keep their triangle
sets; only internal topology and boxes change. The output is
re-emitted in DFS preorder with leaf-contiguous triangle ranges, with
``order`` composed accordingly, so the optimized tree is a
drop-in replacement anywhere a built tree is.

The reference has no optimization pass (its builder is the one-shot
5-candidate split, BVHTree.hpp:294-361); this realizes the quality
headroom its fixed candidate grid leaves behind.
"""

from __future__ import annotations

import heapq

import numpy as np

from .bvh import MAX_BVH_DEPTH, BVHArrays, _half_area


def _parents(child_a, child_b):
    n = len(child_a)
    par = np.full(n, -1, np.int32)
    internal = np.nonzero(child_a >= 0)[0]
    par[child_a[internal]] = internal
    par[child_b[internal]] = internal
    return par


def _heights(child_a, child_b):
    """Height (edges to deepest leaf) per node; children have higher
    ids than parents is NOT assumed — walks ids backwards twice."""
    n = len(child_a)
    h = np.zeros(n, np.int32)
    # DFS-preorder input: children follow parents, so a reverse sweep
    # settles in one pass; a second pass covers any non-DFS input.
    for _ in range(2):
        changed = False
        for i in range(n - 1, -1, -1):
            if child_a[i] >= 0:
                v = 1 + max(h[child_a[i]], h[child_b[i]])
                if v != h[i]:
                    h[i] = v
                    changed = True
        if not changed:
            break
    return h


def optimize_bvh(
    bvh: BVHArrays,
    rounds: int = 2,
    frac: float = 1.0,
    max_depth: int = MAX_BVH_DEPTH,
) -> BVHArrays:
    """Reinsertion-optimize a built BVH; returns a new BVHArrays.

    ``rounds``: full passes over the candidate list. ``frac``: fraction
    of internal nodes attempted per round (1.0 = Bittner's everything,
    ranked worst-first). ``max_depth`` must match the builder cap (the
    traversal kernels size their stacks from it)."""
    node_min = bvh.node_min.astype(np.float32).copy()
    node_max = bvh.node_max.astype(np.float32).copy()
    child_a = bvh.child_a.astype(np.int32).copy()
    child_b = bvh.child_b.astype(np.int32).copy()
    leaf_start = bvh.leaf_start.astype(np.int32).copy()
    leaf_count = bvh.leaf_count.astype(np.int32).copy()
    n = len(child_a)
    if n < 7:  # nothing non-trivial to move
        return bvh
    parent = _parents(child_a, child_b)
    height = _heights(child_a, child_b)
    root = 0

    def area(i):
        return float(_half_area(node_min[i], node_max[i]))

    def refit_up(i):
        while i >= 0:
            a, b = child_a[i], child_b[i]
            mn = np.minimum(node_min[a], node_min[b])
            mx = np.maximum(node_max[a], node_max[b])
            h = 1 + max(height[a], height[b])
            if (
                h == height[i]
                and (mn == node_min[i]).all()
                and (mx == node_max[i]).all()
            ):
                break
            node_min[i] = mn
            node_max[i] = mx
            height[i] = h
            i = parent[i]

    def depth_of(i):
        d = 0
        while parent[i] >= 0:
            d += 1
            i = parent[i]
        return d

    def trav_cost():
        # internal-node area sum = the part of SAH this pass can move
        # (leaf areas x counts never change: leaves are never split)
        return float(_half_area(node_min, node_max)[child_a >= 0].sum())

    for _ in range(rounds):
        # snapshot: a round that nets worse (possible — removing a node
        # destroys its original position before the re-insert search
        # runs, so "put it back" is not in the search space) reverts
        snap = (node_min.copy(), node_max.copy(), child_a.copy(),
                child_b.copy(), parent.copy(), height.copy(),
                leaf_start.copy(), leaf_count.copy(), root)
        cost_before = trav_cost()
        areas = _half_area(node_min, node_max)
        internal = np.nonzero(child_a >= 0)[0]
        # candidates: internal, non-root, with an internal parent
        cand = internal[internal != root]
        if len(cand) == 0:
            break
        ca = areas[cand]
        csum = areas[child_a[cand]] + areas[child_b[cand]]
        ineff = ca * ca / np.maximum(csum, 1e-30)
        take = max(1, int(len(cand) * frac))
        sel = cand[np.argsort(-ineff, kind="stable")[:take]]

        for node in sel:
            node = int(node)
            p = int(parent[node])
            if p < 0 or child_a[node] < 0:
                continue  # became root / leaf via earlier moves
            g = int(parent[p])
            sib = int(child_b[p]) if child_a[p] == node else int(child_a[p])
            c1, c2 = int(child_a[node]), int(child_b[node])
            # -- remove: sibling replaces parent under grandparent;
            #    slots `node` and `p` go free
            if g >= 0:
                if child_a[g] == p:
                    child_a[g] = sib
                else:
                    child_b[g] = sib
                parent[sib] = g
                refit_up(g)
            else:
                root = sib
                parent[sib] = -1
            parent[c1] = -1
            parent[c2] = -1
            free = [node, p]

            for x in (c1, c2):
                bx_min, bx_max = node_min[x], node_max[x]
                ax = float(_half_area(bx_min, bx_max))
                hx = int(height[x])
                # branch-and-bound for the cheapest sibling `out`
                best_cost, best_out, best_depth = np.inf, -1, 0
                heap = [(0.0, 0, root, 0)]
                tick = 1
                while heap:
                    induced, _, out, d = heapq.heappop(heap)
                    if induced >= best_cost:
                        break  # heap is induced-ordered: all pruned
                    mn = np.minimum(node_min[out], bx_min)
                    mx = np.maximum(node_max[out], bx_max)
                    a_union = float(_half_area(mn, mx))
                    total = induced + a_union
                    # new internal node lands at depth d; BOTH subtrees
                    # (x and the displaced out) root at d+1, so both
                    # deepest-leaf depths must clear the kernel stack
                    # cap: d + 1 + max(hx, height(out)) <= max_depth
                    if (
                        total < best_cost
                        and d + 1 + max(hx, int(height[out])) <= max_depth
                    ):
                        best_cost, best_out, best_depth = total, out, d
                    if child_a[out] >= 0:
                        a_out = float(_half_area(node_min[out], node_max[out]))
                        induced2 = induced + (a_union - a_out)
                        if induced2 + ax < best_cost:
                            heapq.heappush(
                                heap, (induced2, tick, int(child_a[out]), d + 1)
                            )
                            heapq.heappush(
                                heap, (induced2, tick + 1, int(child_b[out]), d + 1)
                            )
                            tick += 2
                out = best_out
                if out < 0:  # depth budget rejected everything (can
                    out = int(root)  # only happen if hx >= max_depth)
                new = free.pop()
                op = int(parent[out])
                child_a[new] = out
                child_b[new] = x
                parent[out] = new
                parent[x] = new
                parent[new] = op
                node_min[new] = np.minimum(node_min[out], bx_min)
                node_max[new] = np.maximum(node_max[out], bx_max)
                height[new] = 1 + max(height[out], height[x])
                # leaf bookkeeping: `new` is internal
                leaf_start[new] = 0
                leaf_count[new] = 0
                if op >= 0:
                    if child_a[op] == out:
                        child_a[op] = new
                    else:
                        child_b[op] = new
                    refit_up(op)
                else:
                    root = new

        # areas array went stale during the pass; loop recomputes
        if trav_cost() >= cost_before:
            (node_min, node_max, child_a, child_b, parent, height,
             leaf_start, leaf_count, root) = snap
            break

    # ---- re-emit in DFS preorder with leaf-contiguous triangles ----
    return _renumber_dfs(
        bvh.order, node_min, node_max, child_a, child_b,
        leaf_start, leaf_count, root,
    )


def _renumber_dfs(order, node_min, node_max, child_a, child_b,
                  leaf_start, leaf_count, root):
    n = len(child_a)
    new_min = np.empty_like(node_min)
    new_max = np.empty_like(node_max)
    new_ca = np.empty_like(child_a)
    new_cb = np.empty_like(child_b)
    new_ls = np.zeros(n, np.int32)
    new_lc = np.zeros(n, np.int32)
    perm_ranges = []  # old triangle [start, count) in new leaf order
    nxt = 0
    tri_base = 0
    stack = [int(root)]
    # iterative preorder, left child first (matches the builders)
    out_of = {}
    order_nodes = []
    while stack:
        i = stack.pop()
        out_of[i] = nxt
        order_nodes.append(i)
        nxt += 1
        if child_a[i] >= 0:
            stack.append(int(child_b[i]))
            stack.append(int(child_a[i]))
    assert nxt == n, "optimizer lost nodes"
    for i in order_nodes:
        j = out_of[i]
        new_min[j] = node_min[i]
        new_max[j] = node_max[i]
        if child_a[i] >= 0:
            new_ca[j] = out_of[int(child_a[i])]
            new_cb[j] = out_of[int(child_b[i])]
        else:
            new_ca[j] = -1
            new_cb[j] = -1
            s, c = int(leaf_start[i]), int(leaf_count[i])
            perm_ranges.append((s, c))
            new_ls[j] = tri_base
            new_lc[j] = c
            tri_base += c
    tri_perm = np.concatenate(
        [np.arange(s, s + c, dtype=np.int64) for s, c in perm_ranges]
    )
    assert tri_base == len(order)
    return BVHArrays(
        node_min=new_min,
        node_max=new_max,
        child_a=new_ca,
        child_b=new_cb,
        leaf_start=new_ls,
        leaf_count=new_lc,
        order=np.asarray(order)[tri_perm].astype(np.int64),
    )
