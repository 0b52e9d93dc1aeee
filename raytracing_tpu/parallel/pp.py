"""Pipeline-parallel (PP) wavefront rendering: bounce segments staged
across a mesh axis, microbatches of rays streaming through the pipe.

SURVEY.md §2.9 maps the reference's bounce recursion (camera.hpp:220) to
"wavefront stages pipelined across cores". This module implements that
GPipe-shaped schedule under ``shard_map``:

* The ``pp`` axis has P stages; stage p applies the bounce window
  [b0_p, b1_p) of the depth budget (windows cover max_depth exactly).
* The ray stream is cut into M microbatches of B rays. At step t, stage
  p holds microbatch t − p: stage 0 injects fresh camera rays, every
  stage advances its resident microbatch through its bounce window with
  the SAME ``_bounce_once`` the single-device integrator uses (the
  bounce index is a traced scalar ``b0_p + k``, so the per-(pixel,
  sample, bounce) RNG streams are identical to the single-device
  render), and the state tuple shifts one stage down the ring with ONE
  ``lax.ppermute`` per step — neighbor traffic only, the classic
  pipeline dataflow.
* Stage P−1 banks each finished microbatch's radiance; a final ``psum``
  over the axis replicates the assembled image (all other stages
  contribute zeros).

Per-path radiance is BIT-IDENTICAL to the single-device integrator
(tests/test_pp.py): the pipeline reorders nothing within a path — it
only overlaps different microbatches' bounce windows in time. Pipeline
efficiency is M / (M + P − 1); the injector defaults to M = 2·P
microbatches when the ray count allows.

This axis composes with dp (split rays first, pipe each shard) the same
way the other parallel modes do; it is most useful when the scene state
needed per bounce stage differs (e.g. per-stage BVH residency), which
is also why SURVEY.md ranks it an optimization rather than a default.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from ..ops.intersect import closest_hit_brute
from ..render import camera as cam_mod
from ..render.camera import CameraConfig, CameraParams
from ..render.integrator import _bounce_once


def _stage_windows(max_depth: int, n_stages: int):
    """Split max_depth bounces into n_stages contiguous windows (earlier
    stages get the remainder — they see the most live rays)."""
    base = max_depth // n_stages
    rem = max_depth % n_stages
    sizes = [base + (1 if p < rem else 0) for p in range(n_stages)]
    starts = [sum(sizes[:p]) for p in range(n_stages)]
    return starts, sizes


def build_pp_renderer(scene, cfg: CameraConfig, mesh, axis: str = "pp",
                      hit_fn=closest_hit_brute, n_micro: int | None = None):
    """Returns ``(render_fn, n_rays_pad, n_micro)`` where
    ``render_fn(scene, params, seed) -> (radiance (n_rays_pad, 3),
    segments ())`` renders the full (pixel × sample) stream through the
    bounce pipeline. Rays are sample-major like the single-device
    renderer; ``radiance[i]`` belongs to pixel ``i % n_pix_pad`` of
    sample ``i // n_pix_pad`` (padded pixels are dead)."""
    n_stages = mesh.shape[axis]
    if n_micro is None:
        # 2P microbatches → pipeline efficiency 2P/(3P-1) ≈ 2/3+; capped
        # by the sample count (microbatches split the sample axis)
        n_micro = max(1, min(2 * n_stages, cfg.samples_per_pixel))
    B = -(-cfg.n_pixels // 1024) * 1024  # rays per microbatch row block
    spp = cfg.samples_per_pixel
    # microbatch m covers samples [m*spb, (m+1)*spb) of every pixel
    assert spp % n_micro == 0 or n_micro <= spp, (
        "n_micro must not exceed samples_per_pixel")
    while spp % n_micro:
        n_micro -= 1
    spb = spp // n_micro
    n_rays_pad = B * spp
    starts, sizes = _stage_windows(cfg.max_depth, n_stages)
    starts_a = jnp.asarray(starts, jnp.int32)
    max_win = max(sizes)
    sizes_a = jnp.asarray(sizes, jnp.int32)
    n_pix = cfg.n_pixels
    bg = jnp.asarray(cfg.background, jnp.float32)

    def _fresh(scene_a, derived, m, seed):
        """Microbatch m's initial wavefront state (sample-major)."""
        lane = jnp.arange(B * spb, dtype=jnp.int32)
        pix = jnp.minimum(lane % B, n_pix - 1)
        smp = m * spb + lane // B
        o, d, t = cam_mod.generate_rays(
            cfg, derived, pix, smp, seed,
            motion_blur=scene_a.flags.has_moving)
        act = (lane % B) < n_pix
        nb = B * spb
        return (o, d, t, pix, smp,
                jnp.zeros((nb, 3), jnp.float32),
                jnp.ones((nb, 3), jnp.float32),
                act, jnp.zeros((), jnp.int32))

    def _dead_like(st):
        return tuple(
            jnp.zeros_like(x) if i != 6 else jnp.ones_like(x)
            for i, x in enumerate(st))

    def pp_body(scene_a, params, seed):
        p = jax.lax.axis_index(axis)
        derived = cam_mod.derive(cfg, params)
        st = _dead_like(_fresh(scene_a, derived, jnp.int32(0), seed))
        out = jnp.zeros((n_micro, B * spb, 3), jnp.float32)
        segs = jnp.zeros((), jnp.int32)
        b0 = starts_a[p]
        win = sizes_a[p]
        is_first = p == 0
        is_last = p == n_stages - 1

        def sel(c, a, b):
            return jax.tree.map(
                lambda x, y: jnp.where(
                    jnp.reshape(c, (1,) * x.ndim), x, y), a, b)

        for t in range(n_micro + n_stages - 1):
            # stage 0 injects microbatch t (or a dead batch past the end)
            fresh = _fresh(scene_a, derived,
                           jnp.int32(min(t, n_micro - 1)), seed)
            if t < n_micro:
                st = sel(is_first, fresh, st)
            else:
                st = sel(is_first, _dead_like(fresh), st)
            # advance the resident microbatch through this stage's bounce
            # window (bounce index is traced: same RNG identity as the
            # single-device integrator's bounce counter)
            for k in range(max_win):
                nxt = _bounce_once(scene_a, bg, seed, hit_fn, st,
                                   (b0 + k).astype(jnp.int32))
                st = sel(k < win, nxt, st)
            # last stage banks the finished microbatch
            m = t - (n_stages - 1)
            if 0 <= m < n_micro:
                bank = jax.lax.dynamic_update_slice(
                    out, st[5][None], (jnp.int32(m), 0, 0))
                out = jnp.where(is_last, bank, out)
                segs = segs + jnp.where(is_last, st[8], 0)
            # shift every state one stage down the ring
            perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
            st = jax.tree.map(
                lambda x: jax.lax.ppermute(x, axis, perm), st)
        out = jax.lax.psum(out, axis)
        segs = jax.lax.psum(segs, axis)
        # (n_micro, B*spb, 3) sample-major blocks → (B*spp, 3) stream
        return out.reshape(n_micro * B * spb, 3), segs

    fn = jax.jit(shard_map(
        pp_body, mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(P(), P()),
        check_rep=False,
    ))

    def render_fn(scene_a, params: CameraParams, seed):
        return fn(scene_a, params, jnp.uint32(seed))

    return render_fn, n_rays_pad, n_micro
