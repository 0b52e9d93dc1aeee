"""Sharded rendering via `shard_map` over a device mesh.

Parallelization axes (SURVEY.md §2.9):
  * ``dp`` — pixels sharded across chips (each chip renders a pixel block),
  * ``sp`` — samples-per-pixel sharded; partial radiance psum'd across
    devices,
  * ``tp`` — scene/primitive sharding with collective closest-hit
    (parallel/scene_shard.py).

The per-chip body is the same wavefront integrator as single-chip rendering;
only the hit function and the final reductions differ. With identical seeds
the sharded render is bit-identical to the single-device render (RNG is
counter-based on global pixel/sample ids — see core/rng.py), which is the
key invariant tested in tests/test_parallel.py.

The reference has no distributed anything (single thread, camera.hpp:40-67);
this module is designed from the BASELINE.json scaling targets.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..render import camera as cam_mod
from ..render.camera import CameraConfig, CameraParams
from ..render.integrator import trace
from ..render.renderer import pick_hit_fn
from ..scene.types import Scene
from .scene_shard import closest_hit_scene_sharded, shard_scene_primitives


def _device_render(
    scene: Scene,
    params: CameraParams,
    pixel_ids: jnp.ndarray,  # (P_local,) this chip's pixels
    seed: jnp.ndarray,
    sample_range: jnp.ndarray,  # (2,) i32 [start, stop) of global samples
    *,
    cfg: CameraConfig,
    spp_local: int,
    dp_axis: str,
    tp_axis: Optional[str],
    sp_axis: Optional[str],
    hit_method: str,
    mode: str,
    grad_psum_axes: tuple = (),
):
    # global sample window [start, stop): checkpoint/resume renders a
    # sub-range of samples per call (RNG ids are global, so any chunking
    # reproduces the same per-sample paths)
    sample0 = sample_range[0]
    if sp_axis is not None:
        sample0 = sample0 + jax.lax.axis_index(sp_axis).astype(jnp.int32) * spp_local
    p_local = pixel_ids.shape[0]
    # pixel_ids arrive unclamped so dp-padding pixels can start dead (they
    # neither trace nor count); clamp only for ray generation / RNG identity.
    pix_valid = pixel_ids < cfg.n_pixels
    pixel_ids = jnp.minimum(pixel_ids, cfg.n_pixels - 1)
    pix = jnp.tile(pixel_ids, spp_local)
    samp = sample0 + jnp.repeat(jnp.arange(spp_local, dtype=jnp.int32), p_local)
    active0 = jnp.tile(pix_valid, spp_local) & (samp < sample_range[1])

    derived = cam_mod.derive(cfg, params)
    o, d, t = cam_mod.generate_rays(
        cfg, derived, pix, samp, seed, motion_blur=scene.flags.has_moving
    )

    if tp_axis is not None:
        if hit_method == "ring":
            from .ring import closest_hit_ring

            hit_fn = partial(closest_hit_ring, axis=tp_axis)
        elif hit_method == "bvh":
            from .scene_shard import closest_hit_scene_sharded_bvh

            hit_fn = partial(closest_hit_scene_sharded_bvh, axis=tp_axis)
        else:
            hit_fn = partial(closest_hit_scene_sharded, axis=tp_axis)
    else:
        hit_fn = pick_hit_fn(scene, hit_method)

    radiance, segments = trace(
        scene, o, d, t, pix, samp,
        jnp.asarray(cfg.background, jnp.float32), cfg.max_depth, seed,
        hit_fn=hit_fn, mode=mode, active0=active0,
        grad_psum_axes=grad_psum_axes,
    )
    valid = active0[:, None]
    radiance = jnp.where(valid, radiance, 0.0)
    part = radiance.reshape(spp_local, p_local, 3).sum(axis=0)

    # Reduce over sample shards; gradients flow through this psum (the
    # "grad all-reduce" of the differentiable path).
    if sp_axis is not None:
        part = jax.lax.psum(part, sp_axis)
        segments = jax.lax.psum(segments, sp_axis)
    if tp_axis is not None:
        # every tp rank traces the same rays → average the replicated count
        # (integer psum + divide; pmean on ints is float-typed)
        part = jax.lax.pmean(part, tp_axis)  # already replicated; assert it
        segments = jax.lax.psum(segments, tp_axis) // jax.lax.psum(
            jnp.int32(1), tp_axis
        )
    # total segments over the pixel shards: out_specs declares segments
    # replicated (P()), so it must actually be the dp-wide sum
    segments = jax.lax.psum(segments, dp_axis)
    return part, segments


def build_sharded_renderer(
    scene: Scene,
    cfg: CameraConfig,
    mesh: Mesh,
    *,
    hit_method: str = "brute",
    mode: str = "scan",
    grad_psum_axes: tuple = (),
):
    """Compile a mesh-sharded render function.

    ``hit_method``: on dp/sp meshes any ``Renderer`` hit method (each chip
    sweeps the whole replicated scene); with a ``tp`` axis ``"brute"``
    (psum-min reduction), ``"ring"`` (ppermute ring) or ``"bvh"``
    (per-shard subtrees).

    ``grad_psum_axes``: reduce each bounce's scene-parameter cotangent over
    these mesh axes during the backward sweep (render/integrator.py
    make_overlapped_bounce) so grad communication overlaps backward
    compute instead of trailing it.

    Returns ``(fn, scene_prepared)`` where
    ``fn(scene_prepared, params, pixel_ids, seed, sample_range=None) ->
    (radiance (n_pix_pad, 3) sample-sum, segments)`` and pixels are
    sharded over ``dp``. ``sample_range`` = (2,) i32 ``[start, stop)``
    global sample window (default: the full spp) — chunked calls over
    disjoint windows sum to the full render bit-for-bit per sample
    (global RNG ids), the checkpoint/resume unit for distributed renders.
    """
    axis_names = mesh.axis_names
    dp = "dp" if "dp" in axis_names else None
    tp = "tp" if "tp" in axis_names else None
    sp = "sp" if "sp" in axis_names else None
    assert dp is not None, "mesh must have a 'dp' axis"
    ndp = mesh.shape[dp]
    ntp = mesh.shape.get(tp, 1) if tp else 1
    nsp = mesh.shape.get(sp, 1) if sp else 1

    if tp:
        scene = shard_scene_primitives(scene, ntp,
                                       use_bvh=(hit_method == "bvh"))

    spp_local = -(-cfg.samples_per_pixel // nsp)
    n_pix_pad = -(-cfg.n_pixels // ndp) * ndp

    # PartitionSpec pytrees
    scene_spec = jax.tree.map(lambda _: P(), scene)
    if tp:
        repl = dict(
            spheres=jax.tree.map(lambda _: P(tp), scene.spheres),
            quads=jax.tree.map(lambda _: P(tp), scene.quads),
        )
        if scene.bvh is not None:
            # per-shard subtree node arrays stacked on the leading axis
            repl["bvh"] = jax.tree.map(lambda _: P(tp), scene.bvh)
        scene_spec = scene_spec.replace(**repl)
    params_spec = jax.tree.map(lambda _: P(), CameraParams.from_config(cfg))

    body = partial(
        _device_render,
        cfg=cfg,
        spp_local=spp_local,
        dp_axis=dp,
        tp_axis=tp,
        sp_axis=sp,
        hit_method=hit_method,
        mode=mode,
        grad_psum_axes=tuple(grad_psum_axes),
    )
    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(scene_spec, params_spec, P(dp), P(), P()),
        out_specs=(P(dp), P()),
        check_vma=False,
    )
    jfn = jax.jit(fn)

    def call(scene_a, params_a, pixel_ids_a, seed_a, sample_range=None):
        if sample_range is None:
            sample_range = jnp.asarray(
                [0, cfg.samples_per_pixel], jnp.int32)
        return jfn(scene_a, params_a, pixel_ids_a, seed_a,
                   jnp.asarray(sample_range, jnp.int32))

    return call, scene, n_pix_pad


def render_sharded(
    scene: Scene,
    cfg: CameraConfig,
    mesh: Mesh,
    params: Optional[CameraParams] = None,
    seed: int = 0,
    *,
    hit_method: str = "brute",
    mode: str = "scan",
):
    """One-shot sharded render → ((H, W, 3) mean radiance, segments)."""
    fn, scene_prep, n_pix_pad = build_sharded_renderer(
        scene, cfg, mesh, hit_method=hit_method, mode=mode
    )
    if params is None:
        params = CameraParams.from_config(cfg)
    # unclamped: _device_render deactivates out-of-range padding pixels
    pixel_ids = jnp.arange(n_pix_pad, dtype=jnp.int32)
    part, segments = fn(scene_prep, params, pixel_ids, jnp.uint32(seed))
    mean = np.asarray(part)[: cfg.n_pixels] / cfg.samples_per_pixel
    return mean.reshape(cfg.image_height, cfg.image_width, 3), int(segments)
