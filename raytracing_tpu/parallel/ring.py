"""Ring scene-shard closest hit: ray blocks rotate around the ``tp`` ring
with `lax.ppermute` while each chip keeps its resident primitive shard —
the ring-attention-shaped dataflow of SURVEY.md §2.9/§5 ("ray batches
rotate around chips holding BVH/primitive shards via ppermute").

Two ring passes:
  1. closest-hit: the (ray, best-t, best-global-id) block makes a full
     revolution; at each stop it is tested against the local shard and the
     running minimum is carried along with the rays (the reference's
     ``closest_so_far`` semantics, hittable_list.hpp:40-64, distributed
     around the ring);
  2. attribute fill: the winning (t, gid) makes a second revolution and the
     chip owning the winner writes the full hit record into the circulating
     block.

After R steps each block is back on its home chip, so the result layout is
unchanged. Compared with the psum-min reduction (parallel/scene_shard.py),
communication is R point-to-point neighbor exchanges of the ray block
instead of tree all-reduces of hit records — the classic
bandwidth-optimal systolic alternative; both produce identical hits.

Runs inside `shard_map` (parallel/shard.py, hit_method="ring").
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.intersect import BIG, T_MIN, HitBatch, hit_attributes, quad_ts, sphere_ts
from ..scene.types import Scene

_INT_MAX = jnp.int32(2**31 - 1)


def _ring_perm(n, axis_idx_unused=None):
    return [(i, (i + 1) % n) for i in range(n)]


def closest_hit_ring(
    scene_local: Scene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    time: jnp.ndarray,
    t_min: float = T_MIN,
    *,
    axis: str = "tp",
) -> HitBatch:
    """Closest hit with primitives sharded over the ``axis`` ring.

    Global primitive ids follow parallel/scene_shard.py: chip k's sphere i →
    k·ns_local + i; chip k's quad j → ns_total + k·nq_local + j.
    """
    ntp = jax.lax.psum(1, axis)
    my = jax.lax.axis_index(axis)
    ns_local = scene_local.n_spheres
    nq_local = scene_local.n_quads
    ns_total = ns_local * ntp
    perm = _ring_perm(ntp)

    def local_best(o, d, time, t_cap, owner):
        """Best (t, global id) against MY shard, clipped to t_cap."""
        ts = sphere_ts(scene_local, o, d, time, t_min, t_cap)
        tq = quad_ts(scene_local, o, d, t_min, t_cap)
        all_t = jnp.concatenate([ts, tq], axis=1)
        best = jnp.argmin(all_t, axis=1).astype(jnp.int32)
        t = jnp.take_along_axis(all_t, best[:, None], axis=1)[:, 0]
        gid = jnp.where(
            best >= ns_local,
            ns_total + my * nq_local + (best - ns_local),
            my * ns_local + best,
        )
        return t, jnp.where(jnp.isfinite(t), gid, _INT_MAX)

    # ---- pass 1: rays revolve; min-carry travels with them --------------
    B = o.shape[0]
    t_best = jnp.full((B,), BIG)
    gid_best = jnp.full((B,), _INT_MAX)
    block = (o, d, time, t_best, gid_best)
    for _step in range(ntp):
        o_c, d_c, tm_c, tb, gb = block
        t_loc, gid_loc = local_best(o_c, d_c, tm_c, tb, my)
        better = t_loc < tb
        tb = jnp.where(better, t_loc, tb)
        gb = jnp.where(better, gid_loc, gb)
        block = jax.lax.ppermute((o_c, d_c, tm_c, tb, gb), axis, perm)
    # after ntp rotations every block is home again
    o_c, d_c, tm_c, t_best, gid_best = block

    # ---- pass 2: winner's owner fills the hit record --------------------
    zero_hit = HitBatch(
        valid=jnp.zeros((B,), bool),
        t=jnp.full((B,), BIG),
        p=jnp.zeros((B, 3)),
        normal=jnp.zeros((B, 3)),
        front_face=jnp.zeros((B,), bool),
        u=jnp.zeros((B,)),
        v=jnp.zeros((B,)),
        mat_id=jnp.zeros((B,), jnp.int32),
        prim_id=jnp.full((B,), -1, jnp.int32),
    )
    block2 = (o_c, d_c, tm_c, t_best, gid_best, zero_hit)
    for _step in range(ntp):
        o_c, d_c, tm_c, tb, gb, hb = block2
        sph_lo = my * ns_local
        quad_lo = ns_total + my * nq_local
        is_my_sph = (gb >= sph_lo) & (gb < sph_lo + ns_local)
        is_my_quad = (gb >= quad_lo) & (gb < quad_lo + nq_local)
        mine = is_my_sph | is_my_quad
        local_idx = jnp.where(is_my_quad, ns_local + (gb - quad_lo), gb - sph_lo)
        local_idx = jnp.clip(local_idx, 0, ns_local + nq_local - 1)
        filled = hit_attributes(
            scene_local, o_c, d_c, tm_c, jnp.where(mine, tb, BIG), local_idx
        )
        hb = jax.tree.map(
            lambda new, old: jnp.where(
                mine[(...,) + (None,) * (new.ndim - 1)], new, old
            ),
            filled, hb,
        )
        # restore the true global prim id for rays we just filled
        hb = hb.replace(prim_id=jnp.where(mine & filled.valid, gb, hb.prim_id))
        block2 = jax.lax.ppermute((o_c, d_c, tm_c, tb, gb, hb), axis, perm)
    _, _, _, _, _, hit = block2
    return hit
