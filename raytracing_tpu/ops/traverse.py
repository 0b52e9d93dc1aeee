"""Stackless lockstep BVH traversal in pure JAX.

Every ray in the megabatch walks the flattened skip-link BVH (ops/bvh.py) in
lockstep inside one ``lax.while_loop``: each iteration, every live ray
fetches its current node (vector gather), slab-tests the node AABB against
its ``[t_min, t_best)`` interval, intersects the leaf primitive if any, and
advances via the hit/miss links. ``t_best`` shrinks monotonically, giving
the same closest-so-far pruning as the reference's recursive traversal
(src/accelerator/bvh_node.hpp:83-90) without recursion or stacks.

The loop runs until every ray's node pointer reaches -1; divergence costs
iterations (max walk length over the batch), not correctness.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import interval as iv
from ..core import vecmath as vm
from ..scene.types import Scene
from .intersect import (
    BIG,
    PARALLEL_EPS,
    T_MIN,
    HitBatch,
    hit_attributes,
    quad_plane_basis,
)

_DIR_EPS = 1e-20  # clamp for axis-parallel slab reciprocals


def _slab_test(o, inv_d, bmin, bmax, t_lo, t_hi):
    """AABB slab test (reference aabb.hpp:61-112): intersect the per-axis
    [t0, t1] intervals with [t_lo, t_hi]; hit iff the result is non-empty.
    Unlike the reference's strict ``if (max <= min) return false`` (in
    double), an empty-width interval still counts: a quad's box is padded
    to only 1e-4 thick, which at the Cornell box's 555-unit scale is a
    couple of f32 ulps in t, so t0 and t1 can round to the same value. The
    cull stays conservative; the leaf test decides the hit."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tnear = jnp.minimum(t0, t1)
    tfar = jnp.maximum(t0, t1)
    enter = jnp.maximum(jnp.max(tnear, axis=-1), t_lo)
    exit_ = jnp.minimum(jnp.min(tfar, axis=-1), t_hi)
    return enter <= exit_


def _intersect_one_sphere(scene: Scene, sid, o, d, time, t_lo, t_hi):
    """Candidate t for one sphere per ray (sphere.hpp:47-80)."""
    sph = scene.spheres
    c = sph.center[sid] + time[:, None] * sph.velocity[sid]
    r = sph.radius[sid]
    oc = o - c
    a = vm.length_squared(d)
    half_b = vm.dot(oc, d)
    cq = vm.length_squared(oc) - r * r
    disc = half_b * half_b - a * cq
    sqrtd = vm.safe_sqrt(disc)  # guarded (see vecmath.safe_sqrt)
    root0 = (-half_b - sqrtd) / a
    root1 = (-half_b + sqrtd) / a
    ok0 = iv.surrounds(t_lo, t_hi, root0)  # open-interval root test
    ok1 = iv.surrounds(t_lo, t_hi, root1)
    root = jnp.where(ok0, root0, root1)
    hit = (disc >= 0.0) & (ok0 | ok1) & (r > 0.0)
    return jnp.where(hit, root, BIG)


def _intersect_one_quad(scene: Scene, qid, o, d, t_lo, t_hi):
    """Candidate t for one quad per ray (quad.hpp:44-94)."""
    qd = scene.quads
    normal_all, dconst_all, w_all, degen_all = quad_plane_basis(scene)
    normal = normal_all[qid]
    w = w_all[qid]
    denom = vm.dot(normal, d)
    safe = jnp.where(jnp.abs(denom) < PARALLEL_EPS, 1.0, denom)
    t = (dconst_all[qid] - vm.dot(normal, o)) / safe
    p = o + t[:, None] * d
    planar = p - qd.q[qid]
    alpha = vm.dot(w, vm.cross(planar, qd.v[qid]))
    beta = vm.dot(w, vm.cross(qd.u[qid], planar))
    hit = (
        (jnp.abs(denom) >= PARALLEL_EPS)
        & ~degen_all[qid]
        & (t > t_lo)
        & (t < t_hi)
        & (alpha >= 0.0)
        & (alpha <= 1.0)
        & (beta >= 0.0)
        & (beta <= 1.0)
    )
    return jnp.where(hit, t, BIG)


def closest_hit_bvh(
    scene: Scene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    time: jnp.ndarray,
    t_min: float = T_MIN,
    t_max: float = BIG,
) -> HitBatch:
    """Closest hit via lockstep skip-link traversal.

    The traversal itself (a ``while_loop``) is wrapped in ``stop_gradient``:
    which primitive wins is a discrete decision with no useful derivative
    (SURVEY.md §7 hard-part 3). The winning primitive's ``t`` and hit
    attributes are then *recomputed differentiably*, so gradients flow to
    geometry/material parameters exactly as in the brute-force path.
    """
    assert scene.bvh is not None, "scene compiled without BVH"
    best_prim, _ = _traverse(
        jax.lax.stop_gradient(scene),
        jax.lax.stop_gradient(o),
        jax.lax.stop_gradient(d),
        jax.lax.stop_gradient(time),
        t_min,
        t_max,
    )
    # Differentiable recompute of the winner's t (same nearest-valid-root
    # selection; unclipped upper bound picks the identical root).
    n_sph = scene.n_spheres
    is_quad = best_prim >= n_sph
    sid = jnp.clip(best_prim, 0, n_sph - 1)
    qid = jnp.clip(best_prim - n_sph, 0, scene.n_quads - 1)
    t_s = _intersect_one_sphere(scene, sid, o, d, time, t_min, BIG)
    t_q = _intersect_one_quad(scene, qid, o, d, t_min, BIG)
    t_prim = jnp.where(is_quad, t_q, t_s)
    t_final = jnp.where(best_prim >= 0, t_prim, BIG)
    return hit_attributes(scene, o, d, time, t_final, jnp.maximum(best_prim, 0))


def _traverse(scene: Scene, o, d, time, t_min, t_max):
    """Lockstep skip-link walk; returns (best_prim (B,), t_best (B,))."""
    bvh = scene.bvh
    n_sph = scene.n_spheres
    B = o.shape[0]

    d_safe = jnp.where(jnp.abs(d) < _DIR_EPS, jnp.where(d < 0, -_DIR_EPS, _DIR_EPS), d)
    inv_d = 1.0 / d_safe

    def cond(carry):
        node, _, _ = carry
        return jnp.any(node >= 0)

    def body(carry):
        node, t_best, best_prim = carry
        live = node >= 0
        ni = jnp.maximum(node, 0)

        bmin = bvh.bbox_min[ni]
        bmax = bvh.bbox_max[ni]
        box_hit = _slab_test(o, inv_d, bmin, bmax, t_min, t_best) & live

        prim = bvh.prim[ni]
        is_leaf = prim >= 0

        # Leaf primitive test (sphere or quad by global id), clipped to the
        # current best — the closest-so-far pruning of bvh_node.hpp:90.
        is_quad = prim >= n_sph
        sid = jnp.clip(prim, 0, n_sph - 1)
        qid = jnp.clip(prim - n_sph, 0, scene.n_quads - 1)
        t_s = _intersect_one_sphere(scene, sid, o, d, time, t_min, t_best)
        t_q = _intersect_one_quad(scene, qid, o, d, t_min, t_best)
        t_prim = jnp.where(is_quad, t_q, t_s)

        improve = live & is_leaf & box_hit & (t_prim < t_best)
        t_best = jnp.where(improve, t_prim, t_best)
        best_prim = jnp.where(improve, prim, best_prim)

        descend = box_hit & ~is_leaf
        nxt = jnp.where(descend, ni + 1, bvh.miss[ni])
        node = jnp.where(live, nxt, node)
        return node, t_best, best_prim

    node0 = jnp.zeros((B,), jnp.int32)
    t0 = jnp.full((B,), jnp.asarray(t_max, jnp.float32))
    prim0 = jnp.full((B,), -1, jnp.int32)
    _, t_best, best_prim = jax.lax.while_loop(cond, body, (node0, t0, prim0))
    return best_prim, t_best
