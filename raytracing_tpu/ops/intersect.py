"""Vectorized ray–primitive intersection and closest-hit queries.

This replaces the reference's virtual ``hittable::hit`` dispatch + linear
closest-hit scan (src/hittable/hittable_list.hpp:40-64) with masked batch
math: every (ray, primitive) pair gets a candidate ``t`` (``+inf`` on miss)
and the closest hit is an argmin — the exact same ``closest_so_far``
semantics, fully parallel.

Hit-validity uses the open ``surrounds`` test everywhere (the reference
mixes open for spheres, sphere.hpp:70/:75, and closed for quads,
quad.hpp:62 — SURVEY.md §2.8.6 standardizes on open).
"""
from __future__ import annotations

import jax.numpy as jnp
from ..core import pytree as struct

from ..core import interval as iv
from ..core import vecmath as vm
from ..scene.types import Scene

T_MIN = 1e-3        # shadow-acne epsilon (reference camera.hpp:192)
PARALLEL_EPS = 1e-8  # quad parallel-reject threshold (quad.hpp:49-56)
BIG = jnp.inf


@struct.dataclass
class HitBatch:
    """SoA hit record batch (replaces hit_record, hittable.hpp:16-36)."""
    valid: jnp.ndarray       # (B,) bool
    t: jnp.ndarray           # (B,) f32, +inf on miss
    p: jnp.ndarray           # (B, 3) hit point
    normal: jnp.ndarray      # (B, 3) unit, oriented against the ray
    front_face: jnp.ndarray  # (B,) bool
    u: jnp.ndarray           # (B,) f32 surface coord
    v: jnp.ndarray           # (B,) f32 surface coord
    mat_id: jnp.ndarray      # (B,) i32
    prim_id: jnp.ndarray     # (B,) i32 global primitive id


def sphere_centers_at(scene: Scene, time: jnp.ndarray) -> jnp.ndarray:
    """Time-dependent sphere centers (sphere.hpp:50 ``center.at(time)``).
    Returns (B, N, 3) when the scene has moving spheres, else (N, 3)."""
    sph = scene.spheres
    if scene.flags.has_moving:
        return sph.center[None, :, :] + time[:, None, None] * sph.velocity[None, :, :]
    return sph.center


def sphere_ts(
    scene: Scene,
    o: jnp.ndarray,      # (B, 3)
    d: jnp.ndarray,      # (B, 3)
    time: jnp.ndarray,   # (B,)
    t_min: jnp.ndarray,
    t_max: jnp.ndarray,  # scalar or (B,)
) -> jnp.ndarray:
    """Candidate t per (ray, sphere) — (B, N), +inf on miss.

    Quadratic with the half-b formulation and nearest-valid-root selection
    (sphere.hpp:47-80)."""
    sph = scene.spheres
    c = sphere_centers_at(scene, time)
    oc = o[:, None, :] - c                               # (B, N, 3)
    a = vm.length_squared(d)[:, None]                    # (B, 1)
    half_b = jnp.sum(oc * d[:, None, :], axis=-1)        # (B, N)
    cq = vm.length_squared(oc) - (sph.radius * sph.radius)[None, :]
    disc = half_b * half_b - a * cq
    sqrtd = vm.safe_sqrt(disc)  # guarded: miss lanes (disc<=0) must not NaN grads
    root0 = (-half_b - sqrtd) / a
    root1 = (-half_b + sqrtd) / a
    if jnp.ndim(t_max) == 1:
        t_max = t_max[:, None]
    ok0 = iv.surrounds(t_min, t_max, root0)  # open root test (sphere.hpp:70/:75)
    ok1 = iv.surrounds(t_min, t_max, root1)
    root = jnp.where(ok0, root0, root1)
    hit = (disc >= 0.0) & (ok0 | ok1) & (sph.radius > 0.0)[None, :]
    return jnp.where(hit, root, BIG)


def quad_plane_basis(scene: Scene):
    """Derived plane parameters (n, unit normal, D, w) for all quads —
    computed in-jit from (q, u, v) so gradients flow (quad.hpp:12-23)."""
    qd = scene.quads
    n = vm.cross(qd.u, qd.v)                 # (M, 3)
    nn = vm.length_squared(n)
    safe_nn = jnp.where(nn > 0, nn, 1.0)
    normal = n * jax_rsqrt(safe_nn)[:, None]
    dconst = vm.dot(normal, qd.q)
    w = n / safe_nn[:, None]
    degenerate = nn == 0.0
    return normal, dconst, w, degenerate


def jax_rsqrt(x):
    return 1.0 / jnp.sqrt(x)


def quad_ts(
    scene: Scene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    t_min: jnp.ndarray,
    t_max: jnp.ndarray,
) -> jnp.ndarray:
    """Candidate t per (ray, quad) — (B, M), +inf on miss
    (plane solve + α/β interior test, quad.hpp:44-94)."""
    normal, dconst, w, degenerate = quad_plane_basis(scene)
    qd = scene.quads
    # Explicit mul-sum, NOT einsum/dot: a dot may run at reduced matmul
    # precision (TF32 on the GPU by default), which is catastrophic at
    # Cornell's 555-unit scale (t errors ~1e-3 relative → dead paths).
    # Elementwise f32 is exact and fuses for K=3.
    denom = jnp.sum(normal[None, :, :] * d[:, None, :], axis=-1)   # (B, M)
    safe_denom = jnp.where(jnp.abs(denom) < PARALLEL_EPS, 1.0, denom)
    n_dot_o = jnp.sum(normal[None, :, :] * o[:, None, :], axis=-1)
    t = (dconst[None, :] - n_dot_o) / safe_denom
    p = o[:, None, :] + t[..., None] * d[:, None, :]       # (B, M, 3)
    planar = p - qd.q[None, :, :]
    alpha = jnp.sum(w[None] * jnp.cross(planar, qd.v[None]), axis=-1)
    beta = jnp.sum(w[None] * jnp.cross(qd.u[None], planar), axis=-1)
    if jnp.ndim(t_max) == 1:
        t_max = t_max[:, None]
    hit = (
        (jnp.abs(denom) >= PARALLEL_EPS)
        & ~degenerate[None, :]
        & iv.surrounds(t_min, t_max, t)
        & iv.contains(0.0, 1.0, alpha)  # is_interior (quad.hpp:97-114)
        & iv.contains(0.0, 1.0, beta)
    )
    return jnp.where(hit, t, BIG)


def hit_attributes(
    scene: Scene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    time: jnp.ndarray,
    t: jnp.ndarray,        # (B,) winning t (may be +inf)
    prim_id: jnp.ndarray,  # (B,) global primitive id (sphere i → i, quad j → n_spheres + j)
) -> HitBatch:
    """Recompute full hit attributes for the winning primitive only —
    normal/front_face (hittable.hpp:29-35), sphere UV (sphere.hpp:100-111),
    quad UV = (α, β) (quad.hpp:97-114)."""
    n_sph = scene.n_spheres
    valid = jnp.isfinite(t)
    t_safe = jnp.where(valid, t, 0.0)
    p = vm.ray_at(o, d, t_safe)

    is_quad = prim_id >= n_sph
    sid = jnp.clip(prim_id, 0, n_sph - 1)
    qid = jnp.clip(prim_id - n_sph, 0, scene.n_quads - 1)

    # Sphere attributes
    sph = scene.spheres
    c = sph.center[sid] + time[:, None] * sph.velocity[sid]
    r = sph.radius[sid]
    outward_s = (p - c) / jnp.where(r > 0, r, 1.0)[:, None]
    # Spherical UV (sphere.hpp:100-111). θ is computed as
    # atan2(√(x²+z²), -y) — identical to acos(-y) on the unit sphere but
    # with finite gradients at the poles (acos' → ∞ at ±1 would NaN masked
    # lanes); the sqrt is guarded for the exact-pole case.
    rxz = vm.safe_sqrt(outward_s[:, 0] ** 2 + outward_s[:, 2] ** 2)
    theta = jnp.arctan2(rxz, -outward_s[:, 1])
    x_safe = jnp.where(rxz > 0, outward_s[:, 0], 1.0)  # atan2(0,0) has NaN grads
    phi = jnp.arctan2(-outward_s[:, 2], x_safe) + jnp.pi
    u_s = phi / (2.0 * jnp.pi)
    v_s = theta / jnp.pi

    # Quad attributes
    normal_all, _, w_all, _ = quad_plane_basis(scene)
    qn = normal_all[qid]
    qw = w_all[qid]
    planar = p - scene.quads.q[qid]
    alpha = vm.dot(qw, vm.cross(planar, scene.quads.v[qid]))
    beta = vm.dot(qw, vm.cross(scene.quads.u[qid], planar))

    outward = jnp.where(is_quad[:, None], qn, outward_s)
    uu = jnp.where(is_quad, alpha, u_s)
    vv = jnp.where(is_quad, beta, v_s)
    mat_id = jnp.where(is_quad, scene.quads.mat_id[qid], sph.mat_id[sid])

    normal, front_face = vm.set_face_normal(d, outward)
    return HitBatch(
        valid=valid,
        t=jnp.where(valid, t, BIG),
        p=p,
        normal=normal,
        front_face=front_face,
        u=uu,
        v=vv,
        mat_id=mat_id,
        prim_id=jnp.where(valid, prim_id, -1),
    )


def winner_t(
    scene: Scene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    time: jnp.ndarray,
    prim_id: jnp.ndarray,   # (B,) global id, -1 = miss
    t_min: float = T_MIN,
) -> jnp.ndarray:
    """Differentiable winner-t recompute for a *known* primitive per ray —
    the single-primitive forms of sphere_ts/quad_ts (sphere.hpp:47-80,
    quad.hpp:44-62). Bit-matches the sweep's candidate t for the winning
    row: the nearest root in (t_min, closest-so-far) is always the nearest
    root in (t_min, ∞) for the *winner* (a farther root of the same sphere
    cannot beat the nearer one), so no t_max clip is needed here."""
    n_sph = scene.n_spheres
    valid = prim_id >= 0
    pid = jnp.where(valid, prim_id, 0)
    is_quad = pid >= n_sph
    sid = jnp.clip(pid, 0, n_sph - 1)
    qid = jnp.clip(pid - n_sph, 0, scene.n_quads - 1)

    sph = scene.spheres
    c = sph.center[sid]
    if scene.flags.has_moving:
        c = c + time[:, None] * sph.velocity[sid]
    oc = o - c
    a = vm.length_squared(d)
    half_b = jnp.sum(oc * d, axis=-1)
    cq = vm.length_squared(oc) - sph.radius[sid] * sph.radius[sid]
    disc = half_b * half_b - a * cq
    sqrtd = vm.safe_sqrt(disc)
    root0 = (-half_b - sqrtd) / a
    root1 = (-half_b + sqrtd) / a
    t_s = jnp.where(root0 > t_min, root0, root1)

    normal_all, dconst_all, _, _ = quad_plane_basis(scene)
    qn = normal_all[qid]
    denom = jnp.sum(qn * d, axis=-1)
    safe_denom = jnp.where(jnp.abs(denom) < PARALLEL_EPS, 1.0, denom)
    t_q = (dconst_all[qid] - jnp.sum(qn * o, axis=-1)) / safe_denom

    t = jnp.where(is_quad, t_q, t_s)
    return jnp.where(valid, t, BIG)


def hit_from_id(
    scene: Scene,
    prim_id: jnp.ndarray,
    o: jnp.ndarray,
    d: jnp.ndarray,
    time: jnp.ndarray,
    t_min: float = T_MIN,
) -> HitBatch:
    """Full differentiable HitBatch for a recorded winner id — winner-t
    recompute + the shared attribute recompute (normal/front_face/UV,
    ops/intersect.py hit_attributes)."""
    t = winner_t(scene, o, d, time, prim_id, t_min)
    return hit_attributes(scene, o, d, time, t, jnp.where(prim_id >= 0, prim_id, 0))


def closest_hit_brute(
    scene: Scene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    time: jnp.ndarray,
    t_min: float = T_MIN,
    t_max: float = BIG,
) -> HitBatch:
    """Brute-force closest hit: candidate t over every primitive, then
    argmin — the vectorized form of the reference's linear scan
    (hittable_list.hpp:40-64). O(B·P), branch-free and fully dense."""
    ts = sphere_ts(scene, o, d, time, t_min, t_max)
    tq = quad_ts(scene, o, d, t_min, t_max)
    all_t = jnp.concatenate([ts, tq], axis=1)          # (B, N+M)
    best = jnp.argmin(all_t, axis=1).astype(jnp.int32)  # (B,)
    t = jnp.take_along_axis(all_t, best[:, None], axis=1)[:, 0]
    return hit_attributes(scene, o, d, time, t, best)
