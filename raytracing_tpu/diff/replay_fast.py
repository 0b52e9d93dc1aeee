"""Packed-table decision replay.

diff/replay.py's ``replay_trace`` re-derives each bounce's winner data by
indexing ~25 separate scene arrays per bounce (``center[sid]``,
``normal_all[qid]``, ``mats.fuzz[mid]``, ``tex.rgb[tid]``, …). Here every
per-primitive quantity the bounce math needs is packed into ONE
differentiable table (built in-jit from the scene pytree, so cotangents
flow back through the packing) and fetched with ONE row gather per bounce;
its transpose, a scatter-add into the table, is XLA's own. Every quantity is
carried as separate ``(B,)`` components, so the only ``(B, 3)``
materializations are the state split/restack at the scan boundary.

The bounce math mirrors render/integrator.py ``_bounce_once`` (which
implements camera.hpp:180-232) op for op — scalarized forms of the same
helper formulas (core/rng.py unit_vector, core/vecmath.py
reflect/refract/safe_sqrt/near_zero, ops/scatter.py
schlick_reflectance), same op order and f32 rounding (negation and
per-component arithmetic are exact under IEEE, so the scalarized sums
round identically), same RNG streams — radiance and segment counts are
bit-identical to ``replay_trace`` (asserted in tests/test_replay_fast.py).
Branch *inputs* differ only on masked lanes (e.g. non-dielectric lanes
see ior 1.0 instead of an arbitrary default), which the final material
selects discard.

Supported scenes: solid and depth-1 checker textures (the final-scene
benchmark set). Image/noise textures and nested checkers fall back to
diff/replay.py (``supported_fast``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import rng as rng_mod
from ..core.vecmath import NEAR_ZERO_EPS
from ..ops.intersect import BIG, PARALLEL_EPS, T_MIN, quad_plane_basis
from ..ops.scatter import schlick_reflectance
from ..scene.types import (
    MAT_DIELECTRIC,
    MAT_DIFFUSE_LIGHT,
    MAT_METAL,
    TEX_CHECKER,
    TEX_SOLID,
    Scene,
)

# packed field slots
_F_ISQUAD = 0
_F_G0 = 1      # center | q          (3)
_F_G1 = 4      # velocity | u edge   (3)
_F_RAD = 7     # radius | 0
_F_QN = 8      # 0 | unit normal     (3)
_F_QD = 11     # 0 | plane D
_F_MTYPE = 12
_F_FUZZ = 13
_F_IOR = 14    # 1.0 for non-dielectrics (keeps masked branches finite)
_F_ISCHK = 15
_F_RGB_E = 16  # even-child / solid rgb (3)
_F_RGB_O = 19  # odd-child rgb          (3)
_F_INVSC = 22  # checker inv_scale
N_FIELDS = 23


def supported_fast(scene: Scene) -> bool:
    """Fast replay covers solid + one-level checker-of-solids textures."""
    import numpy as np

    tt = np.asarray(scene.textures.ttype)
    if not np.all((tt == TEX_SOLID) | (tt == TEX_CHECKER)):
        return False
    child = np.asarray(scene.textures.child)
    chk = tt == TEX_CHECKER
    kids = child[chk].reshape(-1)
    return bool(np.all(tt[kids] == TEX_SOLID)) if kids.size else True


def build_replay_table(scene: Scene) -> jnp.ndarray:
    """(n_primitives, N_FIELDS) f32 packed per-global-primitive table, built
    in-jit from the scene pytree (differentiable: cotangents flow back
    to sphere centers, quad corners/edges, material params, texture
    rgbs through the packing slices)."""
    n_sph = scene.n_spheres
    n_quad = scene.n_quads

    sph = scene.spheres
    qd = scene.quads
    normal_all, dconst_all, w_all, _ = quad_plane_basis(scene)
    del w_all  # α/β (image UV) not needed: no image textures here

    mats = scene.materials
    tex = scene.textures

    def mat_cols(mat_id):
        mtype = mats.mtype[mat_id].astype(jnp.float32)
        fuzz = mats.fuzz[mat_id]
        ior = jnp.where(mats.mtype[mat_id] == MAT_DIELECTRIC,
                        mats.ior[mat_id], 1.0)
        tid = mats.tex_id[mat_id]
        is_chk = tex.ttype[tid] == TEX_CHECKER
        even = jnp.where(is_chk, tex.child[tid, 0], tid)
        odd = jnp.where(is_chk, tex.child[tid, 1], tid)
        return (mtype, fuzz, ior, is_chk.astype(jnp.float32),
                tex.rgb[even], tex.rgb[odd],
                jnp.where(is_chk, tex.scale[tid], 0.0))

    # these lookups index SMALL static-shape tables once per render (not
    # per bounce); the XLA gathers here are off the hot path
    s_mt, s_fz, s_io, s_ck, s_re, s_ro, s_sc = mat_cols(sph.mat_id)
    zeros3s = jnp.zeros((n_sph, 3), jnp.float32)
    rows_s = jnp.concatenate([
        jnp.zeros((n_sph, 1), jnp.float32),
        sph.center, sph.velocity, sph.radius[:, None],
        zeros3s, jnp.zeros((n_sph, 1), jnp.float32),
        s_mt[:, None], s_fz[:, None], s_io[:, None], s_ck[:, None],
        s_re, s_ro, s_sc[:, None],
    ], axis=1)
    if n_quad > 0:
        q_mt, q_fz, q_io, q_ck, q_re, q_ro, q_sc = mat_cols(qd.mat_id)
        rows_q = jnp.concatenate([
            jnp.ones((n_quad, 1), jnp.float32),
            qd.q, qd.u, jnp.zeros((n_quad, 1), jnp.float32),
            normal_all, dconst_all[:, None],
            q_mt[:, None], q_fz[:, None], q_io[:, None], q_ck[:, None],
            q_re, q_ro, q_sc[:, None],
        ], axis=1)
        return jnp.concatenate([rows_s, rows_q], axis=0)
    return rows_s


def replay_trace_fast(
    scene: Scene,
    ids: jnp.ndarray,        # (max_depth, B) i32 recorded global ids
    o: jnp.ndarray,
    d: jnp.ndarray,
    time: jnp.ndarray,
    pixel_ids: jnp.ndarray,
    sample_ids: jnp.ndarray,
    background,
    max_depth: int,
    seed,
    remat: bool = True,
    active0=None,
):
    """Drop-in for diff/replay.py ``replay_trace`` (bit-identical
    radiance/segments) with one packed-table lookup per bounce and fully
    scalarized (B,) state."""
    B = o.shape[0]
    bg = jnp.asarray(background, jnp.float32)
    bg_r, bg_g, bg_b = bg[0], bg[1], bg[2]
    table = build_replay_table(scene)
    n_sph = scene.n_spheres
    has_moving = scene.flags.has_moving
    two_pi = jnp.float32(2.0 * jnp.pi)

    zeros = jnp.zeros((B,), jnp.float32)
    ones = jnp.ones((B,), jnp.float32)
    act0 = (jnp.ones((B,), bool) if active0 is None else active0)
    st0 = (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
           zeros, zeros, zeros,        # radiance
           ones, ones, ones,           # throughput
           act0, jnp.zeros((), jnp.int32))

    def body(carry, xs):
        table, st = carry
        bounce, ids_b = xs
        (ox, oy, oz, dx, dy, dz, rr, rg, rb, tr, tg, tb,
         active, segments) = st

        pid = jnp.where(ids_b >= 0, ids_b, 0)
        v = jnp.take(table, pid, axis=0).T  # v[field] is (B,)
        is_quad = pid >= n_sph  # row order matches global ids

        # --- winner t (diff/replay.py winner_t, op for op) ---
        cx, cy, cz = v[_F_G0], v[_F_G0 + 1], v[_F_G0 + 2]
        if has_moving:
            cx = cx + time * v[_F_G1]
            cy = cy + time * v[_F_G1 + 1]
            cz = cz + time * v[_F_G1 + 2]
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        a = dx * dx + dy * dy + dz * dz
        half_b = ocx * dx + ocy * dy + ocz * dz
        r = v[_F_RAD]
        cq = (ocx * ocx + ocy * ocy + ocz * ocz) - r * r
        disc = half_b * half_b - a * cq
        pos = disc > 0.0
        sqrtd = jnp.where(pos, jnp.sqrt(jnp.where(pos, disc, 1.0)), 0.0)
        root0 = (-half_b - sqrtd) / a
        root1 = (-half_b + sqrtd) / a
        t_s = jnp.where(root0 > T_MIN, root0, root1)

        qnx, qny, qnz = v[_F_QN], v[_F_QN + 1], v[_F_QN + 2]
        denom = qnx * dx + qny * dy + qnz * dz
        safe_denom = jnp.where(jnp.abs(denom) < PARALLEL_EPS, 1.0, denom)
        t_q = (v[_F_QD] - (qnx * ox + qny * oy + qnz * oz)) / safe_denom
        t = jnp.where(is_quad, t_q, t_s)
        t = jnp.where(ids_b >= 0, t, BIG)

        # --- hit attributes (ops/intersect.py hit_attributes) ---
        valid = jnp.isfinite(t)
        t_safe = jnp.where(valid, t, 0.0)
        px = ox + t_safe * dx
        py = oy + t_safe * dy
        pz = oz + t_safe * dz
        inv_r = 1.0 / jnp.where(r > 0, r, 1.0)
        owx = jnp.where(is_quad, qnx, (px - cx) * inv_r)
        owy = jnp.where(is_quad, qny, (py - cy) * inv_r)
        owz = jnp.where(is_quad, qnz, (pz - cz) * inv_r)
        front = (dx * owx + dy * owy + dz * owz) < 0.0
        nx = jnp.where(front, owx, -owx)
        ny = jnp.where(front, owy, -owy)
        nz = jnp.where(front, owz, -owz)

        # --- texture: solid rgb or checker parity-selected child rgb
        # (scene/textures.py resolve_checker semantics) ---
        inv_sc = v[_F_INVSC]
        cells = (jnp.floor(inv_sc * px).astype(jnp.int32)
                 + jnp.floor(inv_sc * py).astype(jnp.int32)
                 + jnp.floor(inv_sc * pz).astype(jnp.int32))
        use_even = ((cells % 2) == 0) | (v[_F_ISCHK] == 0.0)
        tex_r = jnp.where(use_even, v[_F_RGB_E], v[_F_RGB_O])
        tex_g = jnp.where(use_even, v[_F_RGB_E + 1], v[_F_RGB_O + 1])
        tex_b = jnp.where(use_even, v[_F_RGB_E + 2], v[_F_RGB_O + 2])

        # --- scatter + emit (ops/scatter.py scatter_and_emit) ---
        ctr = bounce.astype(jnp.uint32) * jnp.uint32(rng_mod.N_STREAMS) + \
            jnp.uint32(rng_mod.STREAM_SCATTER)
        u4 = rng_mod.uniform4(pixel_ids, sample_ids,
                              jnp.broadcast_to(ctr, pixel_ids.shape), seed)
        # unit_vector (core/rng.py): z = 1-2u, r = sqrt(max(0,1-z²)),
        # φ = 2πv
        zdir = 1.0 - 2.0 * u4[:, 0]
        rho = jnp.sqrt(jnp.maximum(0.0, 1.0 - zdir * zdir))
        phi = two_pi * u4[:, 1]
        rux = rho * jnp.cos(phi)
        ruy = rho * jnp.sin(phi)
        ruz = zdir

        # lambertian
        ldx = nx + rux
        ldy = ny + ruy
        ldz = nz + ruz
        degen = ((jnp.abs(ldx) < NEAR_ZERO_EPS)
                 & (jnp.abs(ldy) < NEAR_ZERO_EPS)
                 & (jnp.abs(ldz) < NEAR_ZERO_EPS))
        ldx = jnp.where(degen, nx, ldx)
        ldy = jnp.where(degen, ny, ldy)
        ldz = jnp.where(degen, nz, ldz)

        # metal: unit(reflect(d, n)) + fuzz·ruv (vm.reflect + vm.normalize
        # use division by sqrt, mirrored exactly)
        d_dot_n = dx * nx + dy * ny + dz * nz
        rfx = dx - 2.0 * d_dot_n * nx
        rfy = dy - 2.0 * d_dot_n * ny
        rfz = dz - 2.0 * d_dot_n * nz
        rlen = jnp.sqrt(rfx * rfx + rfy * rfy + rfz * rfz)
        fuzz = v[_F_FUZZ]
        mdx = rfx / rlen + fuzz * rux
        mdy = rfy / rlen + fuzz * ruy
        mdz = rfz / rlen + fuzz * ruz
        metal_ok = (mdx * nx + mdy * ny + mdz * nz) > 0.0

        # dielectric (vm.refract's double-where guard mirrored)
        ior = v[_F_IOR]
        ri = jnp.where(front, 1.0 / ior, ior)
        dlen = jnp.sqrt(dx * dx + dy * dy + dz * dz)
        udx, udy, udz = dx / dlen, dy / dlen, dz / dlen
        cos_t = jnp.minimum(-(udx * nx + udy * ny + udz * nz), 1.0)
        sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
        cannot = ri * sin_t > 1.0
        use_reflect = cannot | (schlick_reflectance(cos_t, ri) > u4[:, 2])
        ppx = ri * (udx + cos_t * nx)
        ppy = ri * (udy + cos_t * ny)
        ppz = ri * (udz + cos_t * nz)
        k = jnp.abs(1.0 - (ppx * ppx + ppy * ppy + ppz * ppz))
        k_pos = k > 0.0
        kroot = jnp.where(k_pos, jnp.sqrt(jnp.where(k_pos, k, 1.0)), 0.0)
        fdx = ppx - kroot * nx
        fdy = ppy - kroot * ny
        fdz = ppz - kroot * nz
        u_dot_n = udx * nx + udy * ny + udz * nz
        xrx = udx - 2.0 * u_dot_n * nx
        xry = udy - 2.0 * u_dot_n * ny
        xrz = udz - 2.0 * u_dot_n * nz
        gdx = jnp.where(use_reflect, xrx, fdx)
        gdy = jnp.where(use_reflect, xry, fdy)
        gdz = jnp.where(use_reflect, xrz, fdz)

        mtype = v[_F_MTYPE].astype(jnp.int32)
        is_metal = mtype == MAT_METAL
        is_diel = mtype == MAT_DIELECTRIC
        is_light = mtype == MAT_DIFFUSE_LIGHT

        ndx = jnp.where(is_metal, mdx, ldx)
        ndy = jnp.where(is_metal, mdy, ldy)
        ndz = jnp.where(is_metal, mdz, ldz)
        ndx = jnp.where(is_diel, gdx, ndx)
        ndy = jnp.where(is_diel, gdy, ndy)
        ndz = jnp.where(is_diel, gdz, ndz)

        att_r = jnp.where(is_diel, 1.0, tex_r)
        att_g = jnp.where(is_diel, 1.0, tex_g)
        att_b = jnp.where(is_diel, 1.0, tex_b)
        did_scatter = jnp.where(is_metal, metal_ok, True) & ~is_light

        # --- bounce bookkeeping (render/integrator.py _bounce_once) ---
        miss = active & ~valid
        rr = rr + jnp.where(miss, tr * bg_r, 0.0)
        rg = rg + jnp.where(miss, tg * bg_g, 0.0)
        rb = rb + jnp.where(miss, tb * bg_b, 0.0)
        hit_mask = active & valid
        emit = hit_mask & is_light
        rr = rr + jnp.where(emit, tr * tex_r, 0.0)
        rg = rg + jnp.where(emit, tg * tex_g, 0.0)
        rb = rb + jnp.where(emit, tb * tex_b, 0.0)
        live = hit_mask & did_scatter
        tr = jnp.where(live, tr * att_r, tr)
        tg = jnp.where(live, tg * att_g, tg)
        tb = jnp.where(live, tb * att_b, tb)
        ox = jnp.where(live, px, ox)
        oy = jnp.where(live, py, oy)
        oz = jnp.where(live, pz, oz)
        dx = jnp.where(live, ndx, dx)
        dy = jnp.where(live, ndy, dy)
        dz = jnp.where(live, ndz, dz)
        segments = segments + jnp.sum(active.astype(jnp.int32))
        st = (ox, oy, oz, dx, dy, dz, rr, rg, rb, tr, tg, tb, live,
              segments)
        return (table, st), None

    if remat:
        body = jax.checkpoint(body)

    (table, st), _ = jax.lax.scan(
        body, (table, st0),
        (jnp.arange(max_depth, dtype=jnp.int32), ids))
    radiance = jnp.stack([st[6], st[7], st[8]], axis=-1)
    return radiance, st[13]
