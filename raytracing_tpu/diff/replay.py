"""Decision-replay differentiable rendering (the fast fwd+bwd path).

The reference's ``ray_color`` (src/core/camera.hpp:180-232) — and our
wavefront integrator — spends almost all of its time on the *closest-hit
search* (the scan over every primitive / the BVH walk,
src/hittable/hittable_list.hpp:40-64, src/accelerator/bvh_node.hpp:80-95).
But the search only produces a **discrete decision**: which primitive wins
each bounce. Under the pathwise-gradient contract (diff/gradients.py:
discrete decisions are constants of the differentiation), the gradient of
the rendered image never flows through the argmin itself — only through
the *continuous* math conditioned on the winner.

So the fast differentiable path splits rendering into two passes, in the
spirit of path-replay backpropagation (Vicini et al. 2021), adapted to a
wavefront tracer:

1. **Decision pass** (not differentiated): the forward wavefront with any
   ``hit_fn`` (the fastest one for the device) records the winning global
   primitive id per (ray, bounce) — ``-1`` for miss.
2. **Replay pass** (differentiated): re-trace the *same* paths, but at
   each bounce intersect only the recorded winner — a gather plus a few
   dozen FLOPs per segment instead of a sweep over the whole scene. Every
   continuous dependence (winner t → hit point → normal/UV → texture →
   scattered ray → next bounce) is recomputed differentiably; the RNG is
   the same counter-based stream (core/rng.py), so the replayed path is
   bit-identical to the forward path and ``jax.grad`` of the replay equals
   ``jax.grad`` of the full forward wherever the decisions are locally
   constant — i.e. almost everywhere (verified against the brute-force
   autodiff path in tests/test_replay.py).

The replay's per-bounce cost is O(B) with small constants — no O(B·P)
sweep, no BVH walk — which is what makes honest forward+backward
throughput land within a small factor of forward-only throughput.
"""
from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..ops.intersect import T_MIN, closest_hit_brute, hit_from_id
from ..render import camera as cam_mod
from ..render.camera import CameraConfig, CameraParams
from ..render.integrator import _bounce_once
from ..scene.types import Scene


def record_decisions(
    scene: Scene,
    o: jnp.ndarray,          # (B, 3)
    d: jnp.ndarray,          # (B, 3)
    time: jnp.ndarray,       # (B,)
    pixel_ids: jnp.ndarray,  # (B,) i32
    sample_ids: jnp.ndarray, # (B,) i32
    background,
    max_depth: int,
    seed,
    hit_fn: Callable = closest_hit_brute,
    active0=None,
    return_active: bool = False,
):
    """XLA decision pass: run the forward wavefront and record the winning
    global primitive id per (bounce, ray) — (max_depth, B) i32, ``-1`` for
    miss (or for lanes whose path already terminated; replay masks those
    via its own liveness replay, so their value is irrelevant).

    This shares the *exact* bounce body with the integrator
    (render/integrator.py ``_bounce_once``): the hit is computed once here,
    recorded, and handed to ``_bounce_once`` unchanged.

    ``return_active`` additionally returns the (max_depth, B) bool mask of
    lanes that were live entering each bounce — the set of (bounce, ray)
    slots whose recorded id is meaningful.
    """
    B = o.shape[0]
    background = jnp.asarray(background, jnp.float32)
    state = (
        o, d, time, pixel_ids, sample_ids,
        jnp.zeros((B, 3), jnp.float32), jnp.ones((B, 3), jnp.float32),
        jnp.ones((B,), bool) if active0 is None else active0,
        jnp.zeros((), jnp.int32),
    )

    def step(st, bounce):
        hit = hit_fn(scene, st[0], st[1], st[2], T_MIN)
        nxt = _bounce_once(scene, background, seed, lambda *_: hit, st, bounce)
        # prim_id is already -1 when invalid (hit_attributes)
        return nxt, (hit.prim_id, st[7])

    state, (ids, act) = jax.lax.scan(
        step, state, jnp.arange(max_depth, dtype=jnp.int32)
    )
    ids = jax.lax.stop_gradient(ids)
    if return_active:
        return ids, jax.lax.stop_gradient(act)
    return ids


def replay_trace(
    scene: Scene,
    ids: jnp.ndarray,        # (max_depth, B) i32 recorded decisions
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
    """Differentiable replay of recorded paths → (radiance (B, 3),
    segments ()). Same bounce semantics as render/integrator.py ``trace``
    (``_bounce_once`` is shared verbatim); only the closest-hit search is
    replaced by the O(B) single-primitive recompute. Liveness (miss →
    background, absorb, light termination) replays from the same RNG
    stream, so ``segments`` is the honest traced-segment count."""
    B = o.shape[0]
    background = jnp.asarray(background, jnp.float32)
    state = (
        o, d, time, pixel_ids, sample_ids,
        jnp.zeros((B, 3), jnp.float32), jnp.ones((B, 3), jnp.float32),
        jnp.ones((B,), bool) if active0 is None else active0,
        jnp.zeros((), jnp.int32),
    )

    def body(st, xs):
        bounce, ids_b = xs

        def hf(sc, oo, dd, tt, tmin):
            return hit_from_id(sc, ids_b, oo, dd, tt, tmin)

        return _bounce_once(scene, background, seed, hf, st, bounce)

    if remat:
        body = jax.checkpoint(body)

    def step(st, xs):
        return body(st, xs), None

    state, _ = jax.lax.scan(
        step, state, (jnp.arange(max_depth, dtype=jnp.int32), ids)
    )
    return state[5], state[8]


def render_replay(
    scene: Scene,
    cfg: CameraConfig,
    params: Optional[CameraParams] = None,
    seed: int = 0,
    ids: Optional[jnp.ndarray] = None,
    hit_fn: Callable = closest_hit_brute,
    remat: bool = True,
    sample_start: int = 0,
    spp: Optional[int] = None,
    return_segments: bool = False,
):
    """Drop-in fast-gradient counterpart of diff/gradients.py
    ``render_once``: identical output image, but ``jax.grad`` through it
    never differentiates (or re-executes, under remat) the closest-hit
    search. Pass precomputed ``ids`` (from ``record_decisions``) to skip
    the decision pass."""
    if params is None:
        params = CameraParams.from_config(cfg)
    derived = cam_mod.derive(cfg, params)
    n_pix = cfg.n_pixels
    if spp is None:
        spp = cfg.samples_per_pixel
    pixel_ids = jnp.tile(jnp.arange(n_pix, dtype=jnp.int32), spp)
    sample_ids = sample_start + jnp.repeat(
        jnp.arange(spp, dtype=jnp.int32), n_pix
    )
    o, d, t = cam_mod.generate_rays(
        cfg, derived, pixel_ids, sample_ids, jnp.uint32(seed),
        motion_blur=scene.flags.has_moving,
    )
    bg = jnp.asarray(cfg.background, jnp.float32)
    if ids is None:
        ids = record_decisions(
            jax.lax.stop_gradient(scene),
            jax.lax.stop_gradient(o), jax.lax.stop_gradient(d),
            jax.lax.stop_gradient(t), pixel_ids, sample_ids, bg,
            cfg.max_depth, jnp.uint32(seed), hit_fn=hit_fn,
        )
    radiance, segments = replay_trace(
        scene, ids, o, d, t, pixel_ids, sample_ids, bg,
        cfg.max_depth, jnp.uint32(seed), remat=remat,
    )
    img = radiance.reshape(spp, n_pix, 3).mean(axis=0)
    img = img.reshape(cfg.image_height, cfg.image_width, 3)
    if return_segments:
        return img, segments
    return img
