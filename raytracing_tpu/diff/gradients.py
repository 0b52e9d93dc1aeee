"""Differentiable rendering: losses and gradients w.r.t. scene and camera
parameters.

The reference is not differentiable at all; this module delivers the
BASELINE.json north-star requirement: pixel gradients flow to sphere
centers/radii, quad geometry, material albedo/fuzz/IOR, emission and camera
pose. The wavefront integrator (render/integrator.py) is a `lax.scan` whose
body is `jax.checkpoint`-wrapped, so the backward sweep rematerializes each
bounce instead of storing all live state — bounded memory at depth 50
(SURVEY.md §7 hard-part 6).

Gradient semantics (SURVEY.md §7 hard-part 3). These are *pathwise interior*
gradients, the standard contract of path-level differentiable renderers
without edge sampling:

  * Discrete decisions (hit-or-miss, BVH winner, material branch, stochastic
    Fresnel coin) are constants of the differentiation — visibility/boundary
    gradients are NOT produced.
  * Shading-parameter gradients (albedo, emission, any texture value) are
    always exact.
  * Geometry/camera/fuzz/IOR gradients flow through every *continuous*
    dependence: hit position → texture value (marble noise; image textures
    with ``image_bilinear=True``), hit position → next-bounce ray, etc.
    With purely flat shading (solid colors + constant background) the
    radiance is piecewise constant in geometry, so pathwise geometry
    gradients are exactly zero — correct, and verified against finite
    differences on continuously-shaded scenes in tests/test_grad.py.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..ops.intersect import closest_hit_brute
from ..render import camera as cam_mod
from ..render.camera import CameraConfig, CameraParams
from ..render.integrator import trace
from ..scene.types import Scene


def render_once(
    scene: Scene,
    cfg: CameraConfig,
    params: Optional[CameraParams] = None,
    seed: int = 0,
    hit_fn: Callable = closest_hit_brute,
    remat: bool = True,
    sample_start: int = 0,
    spp: Optional[int] = None,
    return_segments: bool = False,
):
    """Fully-jittable single-launch render → (H, W, 3) mean radiance.

    Use for differentiable pipelines and small/medium configs (the chunked
    Renderer in render/renderer.py is for big production renders).

    ``sample_start``/``spp`` select a sample sub-range (same RNG streams as
    the full render — chunked differentiable renders accumulate over
    ranges). ``return_segments`` additionally returns the exact number of
    ray-scene queries traced (an int32 from the forward pass; pair with
    ``jax.value_and_grad(..., has_aux=True)`` for honest fwd+bwd
    throughput metrics).
    """
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
    radiance, segments = trace(
        scene, o, d, t, pixel_ids, sample_ids,
        jnp.asarray(cfg.background, jnp.float32),
        cfg.max_depth, jnp.uint32(seed), hit_fn=hit_fn, mode="scan", remat=remat,
    )
    img = radiance.reshape(spp, n_pix, 3).mean(axis=0)
    img = img.reshape(cfg.image_height, cfg.image_width, 3)
    if return_segments:
        return img, segments
    return img


def mse_loss(
    scene: Scene,
    target: jnp.ndarray,
    cfg: CameraConfig,
    params: Optional[CameraParams] = None,
    seed: int = 0,
    render_fn: Optional[Callable] = None,
    **kwargs,
) -> jnp.ndarray:
    """Mean-squared pixel loss against a target image. ``render_fn``
    (default ``render_once``) may be ``diff.replay.render_replay``, which
    has the same signature and image but a cheaper backward."""
    img = (render_fn or render_once)(scene, cfg, params, seed, **kwargs)
    return jnp.mean((img - target) ** 2)


def scene_grad(
    scene: Scene,
    target: jnp.ndarray,
    cfg: CameraConfig,
    seed: int = 0,
    **kwargs,
) -> Scene:
    """∂MSE/∂scene — a Scene-shaped pytree of cotangents."""
    return jax.grad(lambda s: mse_loss(s, target, cfg, seed=seed, **kwargs))(scene)


def camera_grad(
    scene: Scene,
    target: jnp.ndarray,
    cfg: CameraConfig,
    params: CameraParams,
    seed: int = 0,
    **kwargs,
) -> CameraParams:
    """∂MSE/∂camera-params."""
    return jax.grad(
        lambda p: mse_loss(scene, target, cfg, params=p, seed=seed, **kwargs)
    )(params)
