"""The wavefront path-tracing integrator.

The reference integrates by recursion: ``ray_color`` returns
``emitted + attenuation · ray_color(scattered, depth-1)``, black at depth 0,
background on miss (src/core/camera.hpp:180-232). That recursion is affine
in the child value, so it unrolls exactly into the iterative wavefront form
carried here (SURVEY.md §2.5):

    radiance   += throughput · emitted        (on hit)
    radiance   += throughput · background     (on miss, then deactivate)
    throughput *= attenuation                 (on scatter)
    deactivate on absorb

The bounce loop is a ``lax.scan`` over ``max_depth`` with optional per-bounce
rematerialization (``jax.checkpoint``) so reverse-mode gradients at depth 50
don't blow out HBM; a ``lax.while_loop`` early-exit variant is used for
inference when all rays die before max_depth.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from ..core import rng as rng_mod
from ..ops.intersect import T_MIN, HitBatch, closest_hit_brute
from ..ops.scatter import scatter_and_emit
from ..scene.types import Scene

HitFn = Callable[..., HitBatch]  # (scene, o, d, time, t_min) -> HitBatch


def _bounce_once(scene: Scene, background, seed, hit_fn: HitFn, state, bounce):
    """One wavefront bounce. ``state`` = (o, d, time, pixel, sample,
    radiance, throughput, active, segments)."""
    o, d, time, pixel, sample, radiance, throughput, active, segments = state

    hit = hit_fn(scene, o, d, time, T_MIN)

    # Miss → background, terminate (camera.hpp:192-196).
    miss = active & ~hit.valid
    radiance = radiance + jnp.where(miss[:, None], throughput * background[None, :], 0.0)

    # Hit → emitted + scatter (camera.hpp:199-231).
    ctr = bounce.astype(jnp.uint32) * jnp.uint32(rng_mod.N_STREAMS) + jnp.uint32(
        rng_mod.STREAM_SCATTER
    )
    u4 = rng_mod.uniform4(pixel, sample, jnp.broadcast_to(ctr, pixel.shape), seed)
    sc = scatter_and_emit(scene, d, hit, u4)

    hit_mask = active & hit.valid
    radiance = radiance + jnp.where(hit_mask[:, None], throughput * sc.emitted, 0.0)

    live = hit_mask & sc.did_scatter
    throughput = jnp.where(live[:, None], throughput * sc.attenuation, throughput)
    o = jnp.where(live[:, None], hit.p, o)
    d = jnp.where(live[:, None], sc.direction, d)

    # Per-call counter; callers accumulate across chunks in Python ints.
    segments = segments + jnp.sum(active.astype(jnp.int32))
    return (o, d, time, pixel, sample, radiance, throughput, live, segments)


def make_overlapped_bounce(hit_fn: HitFn, axes: tuple):
    """Per-bounce gradient all-reduce (BASELINE north star / SURVEY.md §5
    comm-backend design rule: overlap the parameter-grad psum with the
    backward bounce sweep).

    Plain reverse-mode over the bounce scan produces ONE scene-cotangent
    psum after the entire backward sweep (shard_map's transpose reduces
    replicated-input cotangents at the boundary) — a serial communication
    tail. This wrapper moves the reduction *into each bounce's backward*:
    the scene cotangent of bounce b is psum'd over ``axes`` as soon as that
    bounce's VJP runs, so traffic for bounce b overlaps the backward
    compute of bounce b-1 and the scheduler can hide all but the last one.

    Correctness under the boundary reduction: the per-bounce psum leaves
    every device holding the *global* per-bounce cotangent; dividing by the
    axes' total size makes the boundary's final psum reconstruct exactly
    the unoverlapped value (N identical copies of g/N sum to g). Verified
    bit-for-bit against the plain path in tests/test_parallel.py
    (test_overlapped_grad_psum_identical) on an 8-virtual-device CPU
    mesh; whether the overlap hides the collectives on cards needs a
    profiler trace of a multi-GPU run.
    """
    # Every traced value must be an explicit custom_vjp argument (tracers
    # may not be closed over); only the static hit_fn stays in the closure.
    def plain(scene, bg, sd, state, bounce):
        return _bounce_once(scene, bg, sd, hit_fn, state, bounce)

    @jax.custom_vjp
    def bounce_fn(scene, bg, sd, state, bounce):
        return plain(scene, bg, sd, state, bounce)

    def fwd(scene, bg, sd, state, bounce):
        return plain(scene, bg, sd, state, bounce), (scene, bg, sd, state, bounce)

    def bwd(res, g):
        scene, bg, sd, state, bounce = res
        _, vjp = jax.vjp(plain, scene, bg, sd, state, bounce)
        s_bar, bg_bar, sd_bar, st_bar, b_bar = vjp(g)
        inv_n = 1.0 / jax.lax.psum(jnp.ones((), jnp.float32), axes)
        s_bar = jax.tree.map(
            lambda x: jax.lax.psum(x, axes) * inv_n.astype(x.dtype)
            if jnp.issubdtype(x.dtype, jnp.floating) else x,
            s_bar,
        )
        return s_bar, bg_bar, sd_bar, st_bar, b_bar

    bounce_fn.defvjp(fwd, bwd)
    return bounce_fn


def trace(
    scene: Scene,
    o: jnp.ndarray,          # (B, 3)
    d: jnp.ndarray,          # (B, 3)
    time: jnp.ndarray,       # (B,)
    pixel_ids: jnp.ndarray,  # (B,) i32 — RNG identity
    sample_ids: jnp.ndarray, # (B,) i32 — RNG identity
    background,              # (3,) f32
    max_depth: int,
    seed,
    hit_fn: HitFn = closest_hit_brute,
    mode: str = "scan",      # "scan" (differentiable) | "while" (early-exit)
    remat: bool = True,
    active0=None,            # (B,) bool initial liveness (e.g. padded rays)
    grad_psum_axes: tuple = (),  # mesh axes for per-bounce grad all-reduce
):
    """Trace a megabatch of rays to completion.

    Returns (radiance (B, 3), segments traced ()) — ``segments`` counts
    ray-scene intersection queries actually performed, the standard
    "rays/s" unit for the benchmark harness.

    Rays still active after ``max_depth`` bounces contribute nothing more,
    which is exactly the reference's depth-0 black return (camera.hpp:183).

    ``grad_psum_axes``: inside shard_map, reduce each bounce's scene
    cotangent over these axes during the backward sweep (see
    make_overlapped_bounce) instead of leaving one boundary psum at the end.
    """
    B = o.shape[0]
    background = jnp.asarray(background, jnp.float32)
    radiance = jnp.zeros((B, 3), jnp.float32)
    throughput = jnp.ones((B, 3), jnp.float32)
    active = jnp.ones((B,), bool) if active0 is None else active0
    segments = jnp.zeros((), jnp.int32)
    state = (o, d, time, pixel_ids, sample_ids, radiance, throughput, active, segments)

    if grad_psum_axes:
        ob = make_overlapped_bounce(hit_fn, tuple(grad_psum_axes))

        def body(st, bounce):
            return ob(scene, background, seed, st, bounce)
    else:
        body = partial(_bounce_once, scene, background, seed, hit_fn)

    if mode == "while":
        def cond(carry):
            bounce, st = carry
            return (bounce < max_depth) & jnp.any(st[7])

        def wbody(carry):
            bounce, st = carry
            return bounce + 1, body(st, bounce)

        _, state = jax.lax.while_loop(cond, wbody, (jnp.int32(0), state))
    else:
        scan_body = body
        if remat:
            scan_body = jax.checkpoint(body)

        def step(st, bounce):
            return scan_body(st, bounce), None

        state, _ = jax.lax.scan(step, state, jnp.arange(max_depth, dtype=jnp.int32))

    return state[5], state[8]
