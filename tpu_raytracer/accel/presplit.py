"""Triangle pre-splitting: multiple BVH references per oversized
triangle, with clipped bounding boxes (host-side build pre-pass).

Beyond-reference quality mode in the spirit of Ernst & Greiner 2007
("Early Split Clipping"): a triangle whose AABB is much larger than its
neighbours' (a floor slab under a quarter-million small triangles, a
Cornell wall) forces every node on its root-to-leaf path to span the
whole scene, so EVERY ray that crosses that region visits them — a
cost felt most by incoherent bounce casts. An object-split
builder cannot fix this (the reference's included, BVHTree.hpp:294-361:
it partitions whole triangles, so some leaf always owns the giant box),
and neither can reinsertion optimization — the box is huge wherever the
leaf sits.

The fix: BEFORE the build, recursively bisect the largest refs' boxes
along their longest axis, clipping the triangle polygon
(Sutherland–Hodgman) against the split plane to get tight child boxes.
The builder then partitions REFS — ``order`` maps leaf slots to
original triangles with duplicates, which the whole downstream pipeline
already supports (``MeshPrimitive.from_triangles`` fancy-indexes every
per-triangle array by ``order``; nearest-hit/any-hit over duplicated
identical records is idempotent). Rendered images are bit-identical:
the triangle records any kernel tests are the same rows, only node
membership and visit order change.

Adaptivity: only refs with box half-area > ``gate_mult`` x the mesh
median are splittable, so uniform meshes (the bunny-class blob, the
icospheres) are untouched — ``presplit_refs`` returns None and the
build takes the normal (native-capable) path. A global split budget of
``budget_factor`` x T bounds memory growth on pathological inputs.
"""

from __future__ import annotations

import heapq

import numpy as np

from .bvh import _half_area


def _clip_poly(poly: list, axis: int, pos: float, keep_low: bool) -> list:
    """Sutherland–Hodgman clip of a convex polygon against the
    axis-aligned plane x[axis] = pos, keeping the <= (or >=) side.
    Points exactly on the plane are kept by BOTH sides, so the two
    children's boxes always cover the parent polygon."""
    out = []
    n = len(poly)
    for i in range(n):
        a, b = poly[i], poly[(i + 1) % n]
        da = a[axis] - pos
        db = b[axis] - pos
        ina = (da <= 0.0) if keep_low else (da >= 0.0)
        inb = (db <= 0.0) if keep_low else (db >= 0.0)
        if ina:
            out.append(a)
        if ina != inb and da != db:
            t = da / (da - db)
            out.append(a + t * (b - a))
    return out


def _poly_box(poly: list, parent_min: np.ndarray, parent_max: np.ndarray):
    """f32 box of a (float64) polygon, conservatively rounded OUTWARD
    (one ulp) so the slab test can never miss geometry the f64 box
    contains, then clamped to the parent ref box (the polygon is a
    subset of the parent polygon, so the parent box still covers it —
    the clamp only stops cumulative ulp drift)."""
    pts = np.asarray(poly)
    mn = np.nextafter(pts.min(axis=0).astype(np.float32), np.float32(-np.inf))
    mx = np.nextafter(pts.max(axis=0).astype(np.float32), np.float32(np.inf))
    return np.maximum(mn, parent_min), np.minimum(mx, parent_max)


def presplit_refs(
    v0: np.ndarray,
    v1: np.ndarray,
    v2: np.ndarray,
    budget_factor: float = 0.15,
    gate_mult: float = 16.0,
):
    """Compute split references for oversized triangles.

    Returns ``(ref_tri [R] i64, ref_min [R,3] f32, ref_max [R,3] f32)``
    with R >= T (every triangle keeps at least one ref), or **None**
    when no triangle passes the area gate (uniform meshes — build
    proceeds exactly as without pre-splitting).
    """
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    num = len(v0)
    if num == 0:
        return None
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)
    area = np.asarray(_half_area(tri_min, tri_max), np.float64)
    pos_area = area[area > 0]
    if len(pos_area) == 0:
        return None
    gate = float(gate_mult) * float(np.median(pos_area))
    splittable = area > gate
    budget = int(num * float(budget_factor))
    if not splittable.any() or budget <= 0:
        return None

    keep_tri: list[int] = list(np.nonzero(~splittable)[0])
    keep_min: list[np.ndarray] = [tri_min[i] for i in keep_tri]
    keep_max: list[np.ndarray] = [tri_max[i] for i in keep_tri]

    # heap entries: (-area, seq, tri_id, polygon f64, box_min, box_max)
    seq = 0
    heap = []
    for i in np.nonzero(splittable)[0]:
        poly = [v0[i].astype(np.float64), v1[i].astype(np.float64),
                v2[i].astype(np.float64)]
        heapq.heappush(heap, (-area[i], seq, int(i), poly,
                              tri_min[i], tri_max[i]))
        seq += 1

    while heap and budget > 0:
        neg_a, _, tri, poly, bmn, bmx = heapq.heappop(heap)
        if -neg_a <= gate:  # heap max below gate: everything else is too
            heapq.heappush(heap, (neg_a, 0, tri, poly, bmn, bmx))
            break
        ext = bmx - bmn
        axis = int(np.argmax(ext))
        pos = float(0.5 * (bmn[axis] + bmx[axis]))
        budget -= 1
        progressed = False
        for keep_low in (True, False):
            part = _clip_poly(poly, axis, pos, keep_low)
            if len(part) < 3:
                continue  # zero-area sliver; plane points live on the
                # other side too, so coverage is preserved
            pmn, pmx = _poly_box(part, bmn, bmx)
            a = float(_half_area(pmn, pmx))
            # a child that failed to shrink (degenerate clip) retires to
            # keep rather than looping in the heap forever
            if a > gate and a < -neg_a:
                heapq.heappush(heap, (-a, seq, tri, part, pmn, pmx))
                seq += 1
                progressed = True
            else:
                keep_tri.append(tri)
                keep_min.append(pmn)
                keep_max.append(pmx)
        if not progressed and not heap:
            break

    for neg_a, _, tri, poly, bmn, bmx in heap:
        keep_tri.append(tri)
        keep_min.append(bmn)
        keep_max.append(bmx)

    ref_tri = np.asarray(keep_tri, np.int64)
    ref_min = np.asarray(keep_min, np.float32).reshape(-1, 3)
    ref_max = np.asarray(keep_max, np.float32).reshape(-1, 3)
    if len(ref_tri) <= num:  # budget produced no actual splits
        return None
    return ref_tri, ref_min, ref_max
