"""Host-side BVH construction → flat skip-link arrays.

Build semantics mirror the reference (src/accelerator/bvh_node.hpp:25-77):
recursive longest-axis median split, spans sorted by AABB min along the
split axis, leaves of one primitive. But the *output* is device-friendly: instead
of a pointer tree traversed by recursion (bvh_node.hpp:89-90), nodes are
flattened in depth-first preorder with a per-node **miss link**, enabling
stackless lockstep traversal on device:

    node i internal:  hit  → i + 1 (preorder first child)
                      miss → miss[i]
    node i leaf:      test prim[i], then → miss[i]

AABB semantics also follow the reference: sphere boxes are center ± r,
moving spheres take the union of the t=0 and t=1 boxes (sphere.hpp:16-44);
quad boxes are the union of the two corner-diagonal boxes padded to a
minimum thickness of 1e-4 per axis (quad.hpp:18-23, aabb.hpp:135-154).

A C++ builder with identical semantics lives in native/rt_native.cpp and is
used automatically when its shared library is available (see
raytracing_tpu.native); this NumPy path is the always-available fallback
and the reference implementation for tests.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

PAD_DELTA = 1e-4  # aabb::pad_to_minimums threshold (aabb.hpp:135-154)


@dataclass
class FlatBVH:
    bbox_min: np.ndarray  # (K, 3) f32
    bbox_max: np.ndarray  # (K, 3) f32
    prim: np.ndarray      # (K,) i32, leaf primitive id or -1
    miss: np.ndarray      # (K,) i32, skip link or -1


def primitive_bounds(
    sphere_center: np.ndarray,
    sphere_velocity: np.ndarray,
    sphere_radius: np.ndarray,
    quad_q: np.ndarray,
    quad_u: np.ndarray,
    quad_v: np.ndarray,
):
    """Per-primitive AABBs, (P, 3) mins and maxes, spheres then quads."""
    r = sphere_radius[:, None]
    c0 = sphere_center
    c1 = sphere_center + sphere_velocity
    smin = np.minimum(c0 - r, c1 - r)
    smax = np.maximum(c0 + r, c1 + r)

    corners = np.stack(
        [quad_q, quad_q + quad_u, quad_q + quad_v, quad_q + quad_u + quad_v], axis=0
    )
    qmin = corners.min(axis=0) if quad_q.size else np.zeros((0, 3), np.float32)
    qmax = corners.max(axis=0) if quad_q.size else np.zeros((0, 3), np.float32)
    # pad_to_minimums: expand any axis thinner than delta by delta/2 per side
    thin = (qmax - qmin) < PAD_DELTA
    qmin = np.where(thin, qmin - PAD_DELTA / 2, qmin)
    qmax = np.where(thin, qmax + PAD_DELTA / 2, qmax)

    bmin = np.concatenate([smin, qmin], axis=0).astype(np.float32)
    bmax = np.concatenate([smax, qmax], axis=0).astype(np.float32)
    return bmin, bmax


def build_bvh(
    sphere_center: np.ndarray,
    sphere_velocity: np.ndarray,
    sphere_radius: np.ndarray,
    quad_q: np.ndarray,
    quad_u: np.ndarray,
    quad_v: np.ndarray,
    quad_id_offset: int,
) -> FlatBVH:
    """Build the flat BVH. Leaf ``prim`` ids index the *padded* global
    primitive space: sphere i → i, quad j → quad_id_offset + j."""
    n_sph = len(sphere_radius)
    n_quad = len(quad_q)
    bmin, bmax = primitive_bounds(
        sphere_center, sphere_velocity, sphere_radius, quad_q, quad_u, quad_v
    )
    global_ids = np.concatenate(
        [np.arange(n_sph, dtype=np.int32), quad_id_offset + np.arange(n_quad, dtype=np.int32)]
    )

    # Prefer the C++ builder (identical semantics; tested equal in
    # tests/test_utils.py:47-91); NumPy below is the always-available
    # fallback.
    try:
        from ..native import rt_native

        native = rt_native.build_bvh_flat(bmin, bmax, global_ids)
        if native is not None:
            return FlatBVH(*native)
    except Exception:
        pass

    order = np.arange(n_sph + n_quad)

    # Recursive build into (bbox, prim, n_desc) preorder lists.
    out_min, out_max, out_prim = [], [], []

    def emit(idxs: np.ndarray) -> int:
        """Emit the subtree over ``idxs``; return its node count."""
        node_min = bmin[idxs].min(axis=0)
        node_max = bmax[idxs].max(axis=0)
        slot = len(out_prim)
        out_min.append(node_min)
        out_max.append(node_max)
        out_prim.append(-1)
        if len(idxs) == 1:
            out_prim[slot] = int(global_ids[idxs[0]])
            return 1
        axis = int(np.argmax(node_max - node_min))  # longest_axis (aabb.hpp:114-127)
        key = bmin[idxs][:, axis]
        sorted_idxs = idxs[np.argsort(key, kind="stable")]  # bvh_node.hpp:69, :109-133
        mid = len(idxs) // 2
        n_left = emit(sorted_idxs[:mid])
        n_right = emit(sorted_idxs[mid:])
        return 1 + n_left + n_right

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000 + (n_sph + n_quad)))
    try:
        emit(order)
    finally:
        sys.setrecursionlimit(old_limit)

    k = len(out_prim)
    prim = np.asarray(out_prim, np.int32)
    miss = np.full(k, -1, np.int32)

    # Second pass: compute miss links. A node's first child is i+1; its
    # second child starts at i+1+size(left). Walk with an explicit stack of
    # (node, miss) over the preorder layout.
    size = np.ones(k, np.int64)  # subtree sizes, computed right-to-left
    for i in range(k - 1, -1, -1):
        if prim[i] >= 0:
            size[i] = 1
        else:
            left = i + 1
            right = left + size[left]
            size[i] = 1 + size[left] + size[right]
    stack = [(0, -1)]
    while stack:
        i, m = stack.pop()
        miss[i] = m
        if prim[i] < 0:
            left = i + 1
            right = left + int(size[left])
            stack.append((left, right))  # left's miss → right sibling
            stack.append((right, m))     # right's miss → parent's miss
    return FlatBVH(
        bbox_min=np.stack(out_min).astype(np.float32),
        bbox_max=np.stack(out_max).astype(np.float32),
        prim=prim,
        miss=miss,
    )
