"""Agreement of a closest-hit decision with the reference sweep.

Used to judge ``ops/hit_triton.py`` against ``closest_hit_brute``. Both run
the same f32 formulas, but with different rounding (operation order, fused
multiply-adds), so they agree only up to the formulas' own f32 error:

* the winner ids must agree on at least ``MIN_ID_AGREEMENT`` of the rays,
  and every disagreement must be a razor-edge case: the two candidates' t,
  recomputed in float64, differ by at most ``T_RTOL`` relative, or one of
  the two candidates lies within the f32 rounding bound of its silhouette
  (a grazing sphere, a quad edge) or of ``t_min``;
* where the ids agree, t must agree to ``T_RTOL`` relative, or within the
  f32 rounding bound of the sphere root, or the hit must be a razor-edge
  case as above (a root at ``t_min`` off a surface the ray leaves). The
  bound matters for the final scene's small spheres seen from afar:
  ``half_b² - a·c`` cancels to a part in 1e4, so the root carries ~1e-5
  relative rounding error in any f32 implementation of the formula.

The rounding bound is ``K_ULP`` units of 2^-24 on every product and sum of
``sphere_ts`` that feeds the discriminant, propagated to t to first order.
"""
from __future__ import annotations

import numpy as np

MIN_ID_AGREEMENT = 0.9999
T_RTOL = 1e-5
K_ULP = 8
EPS32 = 2.0 ** -24
T_MIN = 1e-3


def _f64_hit(scene, o, d, time, pid):
    """Float64 (t, t_bound, edge) of global primitive ``pid`` for each of a
    handful of rays: t is inf on a miss, ``t_bound`` the f32 rounding bound
    of the sphere root (0 for quads), ``edge`` whether the hit-or-miss
    decision lies within rounding of a silhouette or of ``t_min``."""
    n_sph = scene.n_spheres
    t_out = np.full(len(pid), np.inf)
    bound = np.zeros(len(pid))
    edge = np.zeros(len(pid), bool)
    ctr = np.asarray(scene.spheres.center, np.float64)
    vel = np.asarray(scene.spheres.velocity, np.float64)
    rad = np.asarray(scene.spheres.radius, np.float64)
    q = np.asarray(scene.quads.q, np.float64)
    u = np.asarray(scene.quads.u, np.float64)
    v = np.asarray(scene.quads.v, np.float64)
    k_eps = K_ULP * EPS32
    for k, (oo, dd, tm, p) in enumerate(zip(o, d, time, pid)):
        if p < 0:
            continue
        if p < n_sph:
            c = ctr[p] + tm * vel[p] if scene.flags.has_moving else ctr[p]
            oc = oo - c
            a, hb, cq = dd @ dd, oc @ dd, oc @ oc - rad[p] ** 2
            disc = hb * hb - a * cq
            err_disc = k_eps * (hb * hb + 2 * abs(hb) * np.sqrt((oc @ oc) * a)
                                + a * abs(cq) + a * (oc @ oc + rad[p] ** 2))
            edge[k] = abs(disc) <= err_disc
            if disc < 0 or rad[p] <= 0:
                continue
            sq = np.sqrt(disc)
            for root in ((-hb - sq) / a, (-hb + sq) / a):
                err = (err_disc / (2 * max(sq, 1e-30)) + k_eps * abs(hb)) / a
                edge[k] |= abs(root - T_MIN) <= err + T_RTOL * T_MIN
                if root > T_MIN:
                    t_out[k], bound[k] = root, err
                    break
        else:
            j = p - n_sph
            n = np.cross(u[j], v[j])
            nn = n @ n
            if nn == 0 or abs(n @ dd) < 1e-16:
                continue
            t = (n @ q[j] - n @ oo) / (n @ dd)
            w = n / nn
            planar = oo + t * dd - q[j]
            al = w @ np.cross(planar, v[j])
            be = w @ np.cross(u[j], planar)
            edge[k] = min(abs(al), abs(1 - al), abs(be), abs(1 - be)) <= T_RTOL
            edge[k] |= abs(t - T_MIN) <= T_RTOL * max(t, 1.0)
            if t > T_MIN and 0 <= al <= 1 and 0 <= be <= 1:
                t_out[k] = t
    return t_out, bound, edge


def hit_agreement(scene, o, d, time, t_k, id_k, t_ref, id_ref) -> dict:
    """Compare a kernel's (t, id) with the reference's. Inputs are arrays
    of one batch; ids are global primitive ids, a miss being t = inf.
    Returns counts and an ``ok`` verdict against the criteria above."""
    o, d, time = (np.asarray(x, np.float64) for x in (o, d, time))
    t_k, t_ref = np.asarray(t_k), np.asarray(t_ref)
    id_k = np.where(np.isfinite(t_k), np.asarray(id_k), -1)
    id_ref = np.where(np.isfinite(t_ref), np.asarray(id_ref), -1)
    same = id_k == id_ref
    both = same & (id_ref >= 0)
    rel = np.zeros(len(t_k))
    rel[both] = np.abs(t_k[both] - t_ref[both]) / np.abs(t_ref[both])
    far = np.nonzero(both & (rel > T_RTOL))[0]
    _, bound, edge = _f64_hit(scene, o[far], d[far], time[far], id_ref[far])
    t_bad = int(np.sum((np.abs(t_k[far] - t_ref[far]) > 2 * bound) & ~edge))
    diff = np.nonzero(~same)[0]
    tk64, _, ek = _f64_hit(scene, o[diff], d[diff], time[diff], id_k[diff])
    tr64, _, er = _f64_hit(scene, o[diff], d[diff], time[diff], id_ref[diff])
    with np.errstate(invalid="ignore"):
        tie = ek | er | (np.abs(tk64 - tr64)
                         <= T_RTOL * np.minimum(tk64, tr64))
    res = dict(
        rays=len(t_k),
        id_agreement=float(np.mean(same)),
        id_disagreements=int(len(diff)),
        non_tie_disagreements=int(np.sum(~tie)),
        t_max_rel=float(rel.max(initial=0.0)),
        t_beyond_rtol=int(len(far)),
        t_beyond_rounding_bound=t_bad,
    )
    res["ok"] = bool(res["id_agreement"] >= MIN_ID_AGREEMENT
                     and res["non_tie_disagreements"] == 0 and t_bad == 0)
    return res


def ray_batches(scene, cfg, n: int, seed: int = 7) -> dict:
    """Two batches of ``n`` rays to judge a hit function on: the camera
    rays of ``cfg`` (pixels cycled, then samples), and the rays that leave
    the first bounce (live ones, cycled to fill ``n``). Each is
    ``(o, d, time)``."""
    import jax
    import jax.numpy as jnp

    from ..ops.intersect import closest_hit_brute
    from ..render import camera as cam_mod
    from ..render.camera import CameraParams
    from ..render.integrator import _bounce_once

    idx = jnp.arange(n, dtype=jnp.int32)
    pix, smp = idx % cfg.n_pixels, idx // cfg.n_pixels
    derived = cam_mod.derive(cfg, CameraParams.from_config(cfg))
    o, d, t = cam_mod.generate_rays(cfg, derived, pix, smp, jnp.uint32(seed),
                                    motion_blur=scene.flags.has_moving)
    state = (o, d, t, pix, smp, jnp.zeros((n, 3)), jnp.ones((n, 3)),
             jnp.ones((n,), bool), jnp.int32(0))
    nxt = jax.jit(lambda s, st: _bounce_once(
        s, jnp.asarray(cfg.background, jnp.float32), jnp.uint32(seed),
        closest_hit_brute, st, jnp.int32(0)))(scene, state)
    live = np.nonzero(np.asarray(nxt[7]))[0]
    take = live[np.arange(n) % len(live)]
    bounce1 = tuple(jnp.asarray(np.asarray(x)[take]) for x in nxt[:3])
    return {"bounce0": (o, d, t), "bounce1": bounce1}
