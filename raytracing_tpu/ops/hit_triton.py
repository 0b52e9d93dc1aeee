"""Closest-hit sweep as a Pallas kernel on the Triton route (NVIDIA GPUs).

``closest_hit_brute`` (ops/intersect.py) builds ``(B, N)`` sphere and
``(B, M)`` quad candidate arrays and takes an argmin over their
concatenation. This kernel runs the same sweep with one ray per thread:

* the grid runs over blocks of ``BLOCK`` rays, one warp per 32 rays;
* inside a block a ``fori_loop`` walks a small f32 primitive table, reading
  one primitive's fields as scalar loads — every thread of a warp reads the
  same address, so the cache broadcasts it;
* ``t_best``/``id_best`` stay in registers and only ``(t, id)`` is written.

The arithmetic is that of ``sphere_ts``/``quad_ts``: the open ``surrounds``
test, motion blur as ``center + time·velocity``, and ties won by the lowest
global id (strict ``<`` in primitive order, as ``argmin`` does).

Gradient rule: the kernel's ``(t, id)`` is a discrete decision and is held
under ``stop_gradient``; ``t`` and the hit attributes are recomputed
differentiably for the winner alone (``hit_from_id``). ``jax.grad`` with
this hit function therefore equals ``jax.grad`` with ``closest_hit_brute``
under the pathwise contract (diff/gradients.py). There is no VJP through
the kernel.

``interpret=True`` runs the kernel in the Pallas interpreter (CPU tests).
Without it the kernel compiles for the GPU only.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..scene.types import Scene
from .intersect import BIG, PARALLEL_EPS, T_MIN, HitBatch, hit_from_id, quad_plane_basis

BLOCK = 128         # rays per program (one per thread: 4 warps)
NUM_WARPS = BLOCK // 32
SPH_FIELDS = 8      # cx cy cz | vx vy vz | r | pad
QUAD_FIELDS = 16    # qx qy qz | ux uy uz | vx vy vz | nx ny nz | D | wx wy wz
# quad table columns
_Q, _U, _V, _N, _D, _W = 0, 3, 6, 9, 12, 13


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _pad_rows(x: jnp.ndarray, rows: int) -> jnp.ndarray:
    return jnp.pad(x, ((0, rows - x.shape[0]), (0, 0)))


def primitive_tables(scene: Scene):
    """(sphere table (Ns, 8), quad table (Mq, 16)), rows padded to powers
    of two with inert zeros. Quad plane data comes from
    ``quad_plane_basis``, so the kernel sees the same normal/D/w values as
    ``quad_ts``; a degenerate quad has a zero normal, which the parallel
    test rejects exactly as ``quad_ts`` does."""
    sph = scene.spheres
    n = scene.n_spheres
    sph_t = jnp.concatenate(
        [sph.center, sph.velocity, sph.radius[:, None],
         jnp.zeros((n, 1), jnp.float32)], axis=1)
    normal, dconst, w, _ = quad_plane_basis(scene)
    qd = scene.quads
    quad_t = jnp.concatenate(
        [qd.q, qd.u, qd.v, normal, dconst[:, None], w], axis=1)
    return (_pad_rows(sph_t, _pow2(n)),
            _pad_rows(quad_t, _pow2(scene.n_quads)))


def _sweep_kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, tm_ref,
                  sph_ref, quad_ref, t_ref, id_ref, *,
                  n_sph: int, n_quad: int, moving: bool, t_min: float):
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    inf = jnp.float32(jnp.inf)
    a = dx * dx + dy * dy + dz * dz

    def surrounds(x):
        return (x > t_min) & (x < inf)

    def sphere(j, carry):
        t_best, id_best = carry
        cx, cy, cz = sph_ref[j, 0], sph_ref[j, 1], sph_ref[j, 2]
        r = sph_ref[j, 6]
        if moving:
            tm = tm_ref[...]
            cx = cx + tm * sph_ref[j, 3]
            cy = cy + tm * sph_ref[j, 4]
            cz = cz + tm * sph_ref[j, 5]
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        half_b = ocx * dx + ocy * dy + ocz * dz
        cq = (ocx * ocx + ocy * ocy + ocz * ocz) - r * r
        disc = half_b * half_b - a * cq
        sqrtd = jnp.sqrt(jnp.maximum(disc, 0.0))
        root0 = (-half_b - sqrtd) / a
        root1 = (-half_b + sqrtd) / a
        ok0 = surrounds(root0)
        ok1 = surrounds(root1)
        root = jnp.where(ok0, root0, root1)
        better = (disc >= 0.0) & (ok0 | ok1) & (r > 0.0) & (root < t_best)
        return jnp.where(better, root, t_best), jnp.where(better, j, id_best)

    def quad(j, carry):
        t_best, id_best = carry

        def col(k):
            return quad_ref[j, k]

        qx, qy, qz = col(_Q), col(_Q + 1), col(_Q + 2)
        ux, uy, uz = col(_U), col(_U + 1), col(_U + 2)
        vx, vy, vz = col(_V), col(_V + 1), col(_V + 2)
        nx, ny, nz = col(_N), col(_N + 1), col(_N + 2)
        wx, wy, wz = col(_W), col(_W + 1), col(_W + 2)
        denom = nx * dx + ny * dy + nz * dz
        parallel = jnp.abs(denom) < PARALLEL_EPS
        safe = jnp.where(parallel, 1.0, denom)
        t = (col(_D) - (nx * ox + ny * oy + nz * oz)) / safe
        # planar = p - q; alpha = w·(planar × v), beta = w·(u × planar)
        px = ox + t * dx - qx
        py = oy + t * dy - qy
        pz = oz + t * dz - qz
        alpha = (wx * (py * vz - pz * vy) + wy * (pz * vx - px * vz)
                 + wz * (px * vy - py * vx))
        beta = (wx * (uy * pz - uz * py) + wy * (uz * px - ux * pz)
                + wz * (ux * py - uy * px))
        better = (~parallel & surrounds(t)
                  & (alpha >= 0.0) & (alpha <= 1.0)
                  & (beta >= 0.0) & (beta <= 1.0) & (t < t_best))
        return (jnp.where(better, t, t_best),
                jnp.where(better, n_sph + j, id_best))

    carry = (jnp.full(ox.shape, inf), jnp.zeros(ox.shape, jnp.int32))
    carry = jax.lax.fori_loop(0, n_sph, sphere, carry)
    if n_quad:
        carry = jax.lax.fori_loop(0, n_quad, quad, carry)
    t_ref[...], id_ref[...] = carry


def closest_t_id(scene: Scene, o, d, time, t_min: float = T_MIN,
                 interpret: bool = False):
    """The kernel alone → (t (B,) f32, +inf on miss; id (B,) i32 global
    primitive id, 0 on miss). Not differentiable."""
    B = o.shape[0]
    b_pad = -(-B // BLOCK) * BLOCK
    # padded rays have a zero direction: every root is NaN, so none hits
    cols = [jnp.pad(c.astype(jnp.float32), (0, b_pad - B))
            for c in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                      time)]
    sph_t, quad_t = primitive_tables(scene)
    ray_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    kernel = partial(_sweep_kernel, n_sph=scene.n_spheres,
                     n_quad=scene.n_quads, moving=scene.flags.has_moving,
                     t_min=float(t_min))
    t, ids = pl.pallas_call(
        kernel,
        grid=(b_pad // BLOCK,),
        in_specs=[ray_spec] * 7 + [
            pl.BlockSpec(sph_t.shape, lambda i: (0, 0)),
            pl.BlockSpec(quad_t.shape, lambda i: (0, 0)),
        ],
        out_specs=[ray_spec, ray_spec],
        out_shape=[jax.ShapeDtypeStruct((b_pad,), jnp.float32),
                   jax.ShapeDtypeStruct((b_pad,), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="closest_hit_sweep",
    )(*cols, sph_t, quad_t)
    return t[:B], ids[:B]


def closest_hit_triton(scene: Scene, o, d, time, t_min: float = T_MIN,
                       t_max: float = BIG, interpret: bool = False
                       ) -> HitBatch:
    """Drop-in ``HitFn``: kernel decision, differentiable winner recompute."""
    if t_max != BIG:
        raise ValueError("the sweep kernel searches (t_min, inf)")
    sg = jax.lax.stop_gradient
    t, ids = closest_t_id(sg(scene), sg(o), sg(d), sg(time), t_min,
                          interpret=interpret)
    prim = jnp.where(jnp.isfinite(t), ids, -1)
    return hit_from_id(scene, prim, o, d, time, t_min)
