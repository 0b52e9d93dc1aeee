"""Scene-sharded ("tensor parallel") closest-hit: primitives partitioned by
range across the ``tp`` mesh axis, global closest hit via psum-min
collectives (SURVEY.md §2.9 TP analog).

Each chip intersects the megabatch against its primitive shard; the global
winner is found with two `pmin` reductions ((t), then (global prim id) for
deterministic tie-breaking); the winning chip contributes the full hit
record via a masked `psum`. Materials/textures stay replicated (tiny);
geometry memory and intersection FLOPs scale 1/ntp.

Runs inside `shard_map` with the scene's sphere/quad tables sharded on their
leading axis and everything else replicated (see parallel/shard.py).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops.intersect import BIG, T_MIN, HitBatch, hit_attributes, quad_ts, sphere_ts
from ..scene.types import Scene

_INT_MAX = jnp.int32(2**31 - 1)


def closest_hit_scene_sharded(
    scene_local: Scene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    time: jnp.ndarray,
    t_min: float = T_MIN,
    *,
    axis: str = "tp",
) -> HitBatch:
    """Closest hit where ``scene_local`` holds this chip's primitive shard.

    Global primitive ids: chip k's sphere i → k·ns_local + i; chip k's quad
    j → ns_total + k·nq_local + j.
    """
    idx = jax.lax.axis_index(axis)
    ntp = jax.lax.psum(1, axis)
    ns_local = scene_local.n_spheres
    nq_local = scene_local.n_quads
    ns_total = ns_local * ntp

    ts = sphere_ts(scene_local, o, d, time, t_min, BIG)   # (B, ns_local)
    tq = quad_ts(scene_local, o, d, t_min, BIG)           # (B, nq_local)
    all_t = jnp.concatenate([ts, tq], axis=1)
    local_best = jnp.argmin(all_t, axis=1).astype(jnp.int32)
    local_t = jnp.take_along_axis(all_t, local_best[:, None], axis=1)[:, 0]

    # Global minimum t across shards, then lowest-global-id tie-break.
    # Winner *selection* is discrete → computed under stop_gradient (pmin has
    # no AD rule and needs none); the winner's record below is assembled with
    # differentiable masked psums, so gradients still flow to geometry.
    local_t_sg = jax.lax.stop_gradient(local_t)
    t_glob = jax.lax.pmin(local_t_sg, axis)
    local_is_quad = local_best >= ns_local
    global_id = jnp.where(
        local_is_quad,
        ns_total + idx * nq_local + (local_best - ns_local),
        idx * ns_local + local_best,
    )
    candidate = jnp.where(
        (local_t_sg == t_glob) & jnp.isfinite(local_t_sg), global_id, _INT_MAX
    )
    gid = jax.lax.pmin(candidate, axis)
    i_win = (candidate == gid) & (gid != _INT_MAX)

    # Winning chip computes the full record from its local tables; everyone
    # else contributes zeros; psum assembles.
    hit_local = hit_attributes(
        scene_local, o, d, time, jnp.where(i_win, local_t, BIG), local_best
    )

    def _mask_sum(x, zero_val=0):
        masked = jnp.where(
            i_win[(...,) + (None,) * (x.ndim - 1)], x, jnp.zeros_like(x) + zero_val
        )
        return jax.lax.psum(masked.astype(jnp.float32) if x.dtype == bool else masked, axis)

    valid = jax.lax.psum(jnp.where(i_win, 1, 0), axis) > 0
    return HitBatch(
        valid=valid,
        t=jnp.where(valid, jax.lax.psum(jnp.where(i_win, hit_local.t, 0.0), axis), BIG),
        p=_mask_sum(hit_local.p),
        normal=_mask_sum(hit_local.normal),
        front_face=_mask_sum(hit_local.front_face) > 0,
        u=_mask_sum(hit_local.u),
        v=_mask_sum(hit_local.v),
        mat_id=jax.lax.psum(jnp.where(i_win, hit_local.mat_id, 0), axis),
        prim_id=jnp.where(valid, gid, -1),
    )


def closest_hit_scene_sharded_bvh(
    scene_local: Scene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    time: jnp.ndarray,
    t_min: float = T_MIN,
    *,
    axis: str = "tp",
) -> HitBatch:
    """Sharded closest hit where each chip traverses its OWN BVH subtree
    over its primitive range (``shard_scene_primitives(..., use_bvh=True)``)
    — the "scene too large to replicate" scaling mode: per-chip memory AND
    per-ray intersection cost are O(P/ntp) with a log-factor traversal,
    while the winner reduction is the same psum-min contract as the
    brute-force variant above (bvh_node.hpp:80-95 semantics per shard,
    hittable_list.hpp:40-64 "closest so far" across shards via pmin)."""
    from ..ops.traverse import closest_hit_bvh

    idx = jax.lax.axis_index(axis)
    ntp = jax.lax.psum(1, axis)
    ns_local = scene_local.n_spheres
    nq_local = scene_local.n_quads
    ns_total = ns_local * ntp

    hit_local = closest_hit_bvh(scene_local, o, d, time, t_min)
    local_t_sg = jax.lax.stop_gradient(
        jnp.where(hit_local.valid, hit_local.t, BIG)
    )
    t_glob = jax.lax.pmin(local_t_sg, axis)
    pid = hit_local.prim_id
    local_is_quad = pid >= ns_local
    global_id = jnp.where(
        local_is_quad,
        ns_total + idx * nq_local + (pid - ns_local),
        idx * ns_local + pid,
    )
    candidate = jnp.where(
        hit_local.valid & (local_t_sg == t_glob), global_id, _INT_MAX
    )
    gid = jax.lax.pmin(candidate, axis)
    i_win = (candidate == gid) & (gid != _INT_MAX)

    def _mask_sum(x):
        masked = jnp.where(
            i_win[(...,) + (None,) * (x.ndim - 1)], x, jnp.zeros_like(x)
        )
        return jax.lax.psum(
            masked.astype(jnp.float32) if x.dtype == bool else masked, axis
        )

    valid = jax.lax.psum(jnp.where(i_win, 1, 0), axis) > 0
    return HitBatch(
        valid=valid,
        t=jnp.where(
            valid, jax.lax.psum(jnp.where(i_win, hit_local.t, 0.0), axis), BIG
        ),
        p=_mask_sum(hit_local.p),
        normal=_mask_sum(hit_local.normal),
        front_face=_mask_sum(hit_local.front_face) > 0,
        u=_mask_sum(hit_local.u),
        v=_mask_sum(hit_local.v),
        mat_id=jax.lax.psum(jnp.where(i_win, hit_local.mat_id, 0), axis),
        prim_id=jnp.where(valid, gid, -1),
    )


def shard_scene_primitives(scene: Scene, ntp: int, use_bvh: bool = False) -> Scene:
    """Host-side: pad primitive tables so their leading dim divides ``ntp``
    (the actual sharding is applied by shard_map in_specs).

    ``use_bvh=False``: the sharded closest hit is brute-force over each
    chip's primitive range (``bvh=None``) — per-chip cost O(P/ntp) per
    ray, the right trade at reference scene sizes (~500 primitives) where
    per-shard traversal overhead exceeds the sweep.

    ``use_bvh=True`` (the "scene too large to replicate" regime,
    SURVEY.md §5): primitives are first ordered spatially (Morton code of
    their swept-AABB centers, per type) so each chip's contiguous range
    is a compact region, then ntp independent skip-link BVHs are built —
    one per shard, node arrays padded to a common length and stacked on a
    leading axis that shard_map splits over ``tp``. Each chip walks only
    its own subtree (ops/traverse.py); the psum-min winner reduction
    (closest_hit_scene_sharded_bvh) is unchanged. Spatial reordering
    changes only the deterministic tie-break order among exactly-equal
    hit distances.
    """
    import numpy as np

    from ..ops import bvh as bvh_mod
    from ..scene.types import BVH

    def _morton_order(mn, mx):
        if len(mn) == 0:
            return np.arange(0)
        mid = (np.asarray(mn) + np.asarray(mx)) / 2
        lo = mid.min(axis=0)
        span = np.maximum(mid.max(axis=0) - lo, 1e-30)
        q = np.clip(((mid - lo) / span * 1023.0).astype(np.int64), 0, 1023)

        def spread(x):
            x = (x | (x << 16)) & 0x030000FF
            x = (x | (x << 8)) & 0x0300F00F
            x = (x | (x << 4)) & 0x030C30C3
            x = (x | (x << 2)) & 0x09249249
            return x

        key = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
        return np.argsort(key, kind="stable")

    sph = scene.spheres
    qd = scene.quads
    if use_bvh:
        smin, smax = bvh_mod.primitive_bounds(
            np.asarray(sph.center), np.asarray(sph.velocity),
            np.asarray(sph.radius), np.zeros((0, 3), np.float32),
            np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
        )
        sperm = _morton_order(smin, smax)
        qb_min, qb_max = bvh_mod.primitive_bounds(
            np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
            np.zeros((0,), np.float32), np.asarray(qd.q),
            np.asarray(qd.u), np.asarray(qd.v),
        )
        qperm = _morton_order(qb_min, qb_max)
        sph = jax.tree_util.tree_map(lambda a: a[np.asarray(sperm)], sph)
        qd = jax.tree_util.tree_map(lambda a: a[np.asarray(qperm)], qd)

    def pad_rows(arr, mult):
        n = arr.shape[0]
        target = -(-n // mult) * mult
        if target == n:
            return arr
        pad = [(0, target - n)] + [(0, 0)] * (arr.ndim - 1)
        return jnp.asarray(np.pad(np.asarray(arr), pad))

    sph = sph.replace(
        center=pad_rows(sph.center, ntp),
        velocity=pad_rows(sph.velocity, ntp),
        radius=pad_rows(sph.radius, ntp),
        mat_id=pad_rows(sph.mat_id, ntp),
    )
    qd = qd.replace(
        q=pad_rows(qd.q, ntp),
        u=pad_rows(qd.u, ntp),
        v=pad_rows(qd.v, ntp),
        mat_id=pad_rows(qd.mat_id, ntp),
    )

    bvh = None
    if use_bvh:
        ns_local = sph.radius.shape[0] // ntp
        nq_local = qd.mat_id.shape[0] // ntp
        flats = []
        for k in range(ntp):
            ss = slice(k * ns_local, (k + 1) * ns_local)
            qs = slice(k * nq_local, (k + 1) * nq_local)
            flats.append(bvh_mod.build_bvh(
                np.asarray(sph.center[ss]), np.asarray(sph.velocity[ss]),
                np.asarray(sph.radius[ss]), np.asarray(qd.q[qs]),
                np.asarray(qd.u[qs]), np.asarray(qd.v[qs]),
                quad_id_offset=ns_local,
            ))
        kmax = max(f.prim.shape[0] for f in flats)

        def pad_nodes(f):
            padn = kmax - f.prim.shape[0]
            # pad nodes are unreachable (no link points past the real
            # tree); give them empty boxes and terminating links anyway
            return (
                np.pad(f.bbox_min, ((0, padn), (0, 0)),
                       constant_values=3.0e38),
                np.pad(f.bbox_max, ((0, padn), (0, 0)),
                       constant_values=-3.0e38),
                np.pad(f.prim, (0, padn), constant_values=-1),
                np.pad(f.miss, (0, padn), constant_values=-1),
            )

        parts = [pad_nodes(f) for f in flats]
        bvh = BVH(
            bbox_min=jnp.asarray(np.concatenate([p[0] for p in parts])),
            bbox_max=jnp.asarray(np.concatenate([p[1] for p in parts])),
            prim=jnp.asarray(np.concatenate([p[2] for p in parts])),
            miss=jnp.asarray(np.concatenate([p[3] for p in parts])),
        )

    return scene.replace(spheres=sph, quads=qd, bvh=bvh)
