"""Camera model: static config, differentiable pose parameters, derived
viewport geometry and batched ray generation
(reference: src/core/camera.hpp:13-177).

The reference couples configuration, derivation and the render loop in one
class; here they split into jit-friendly pieces:

  * :class:`CameraConfig` — static/hashable knobs (image size, spp, depth),
    safe to close over in jit,
  * :class:`CameraParams` — the differentiable pose/optics pytree
    (lookfrom/lookat/vup/vfov/defocus/focus), a gradient target,
  * :func:`derive` — pure function computing the viewport basis
    (camera.hpp:76-136),
  * :func:`generate_rays` — batched get_ray with AA jitter, defocus disk
    sampling and motion-blur time (camera.hpp:139-177).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax.numpy as jnp
from ..core import pytree as struct

from ..core import rng as rng_mod


@dataclass(frozen=True)
class CameraConfig:
    """Static render configuration (mirrors camera.hpp:13-25 public knobs;
    the pose fields are *defaults* used to build CameraParams)."""
    aspect_ratio: float = 1.0
    image_width: int = 100
    samples_per_pixel: int = 10
    max_depth: int = 10
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    vfov: float = 90.0
    lookfrom: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    lookat: Tuple[float, float, float] = (0.0, 0.0, -1.0)
    vup: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    defocus_angle: float = 0.0
    focus_dist: float = 10.0

    @property
    def image_height(self) -> int:
        """height = width / aspect, clamped ≥ 1 (camera.hpp:79-80)."""
        return max(1, int(self.image_width / self.aspect_ratio))

    @property
    def n_pixels(self) -> int:
        return self.image_width * self.image_height


@struct.dataclass
class CameraParams:
    """Differentiable camera pose/optics pytree."""
    lookfrom: jnp.ndarray   # (3,)
    lookat: jnp.ndarray     # (3,)
    vup: jnp.ndarray        # (3,)
    vfov: jnp.ndarray       # ()
    defocus_angle: jnp.ndarray  # ()
    focus_dist: jnp.ndarray     # ()

    @classmethod
    def from_config(cls, cfg: CameraConfig) -> "CameraParams":
        f32 = jnp.float32
        return cls(
            lookfrom=jnp.asarray(cfg.lookfrom, f32),
            lookat=jnp.asarray(cfg.lookat, f32),
            vup=jnp.asarray(cfg.vup, f32),
            vfov=jnp.asarray(cfg.vfov, f32),
            defocus_angle=jnp.asarray(cfg.defocus_angle, f32),
            focus_dist=jnp.asarray(cfg.focus_dist, f32),
        )


@struct.dataclass
class DerivedCamera:
    """Viewport basis derived from params (camera.hpp:76-136)."""
    center: jnp.ndarray          # (3,)
    pixel00: jnp.ndarray         # (3,)
    pixel_delta_u: jnp.ndarray   # (3,)
    pixel_delta_v: jnp.ndarray   # (3,)
    defocus_disk_u: jnp.ndarray  # (3,)
    defocus_disk_v: jnp.ndarray  # (3,)
    defocus_angle: jnp.ndarray   # ()


def _unit(v):
    return v / jnp.sqrt(jnp.sum(v * v))


def derive(cfg: CameraConfig, params: CameraParams) -> DerivedCamera:
    """Pure viewport derivation — the analogue of camera::initialize
    (camera.hpp:76-136)."""
    w_img = cfg.image_width
    h_img = cfg.image_height

    theta = params.vfov * (jnp.pi / 180.0)
    h = jnp.tan(theta / 2.0)
    viewport_height = 2.0 * h * params.focus_dist
    viewport_width = viewport_height * (w_img / h_img)

    w = _unit(params.lookfrom - params.lookat)
    u = _unit(jnp.cross(params.vup, w))
    v = jnp.cross(w, u)

    viewport_u = viewport_width * u
    viewport_v = viewport_height * (-v)
    pixel_delta_u = viewport_u / w_img
    pixel_delta_v = viewport_v / h_img
    upper_left = params.lookfrom - params.focus_dist * w - viewport_u / 2 - viewport_v / 2
    pixel00 = upper_left + 0.5 * (pixel_delta_u + pixel_delta_v)

    defocus_radius = params.focus_dist * jnp.tan(params.defocus_angle * (jnp.pi / 180.0) / 2.0)
    return DerivedCamera(
        center=params.lookfrom,
        pixel00=pixel00,
        pixel_delta_u=pixel_delta_u,
        pixel_delta_v=pixel_delta_v,
        defocus_disk_u=u * defocus_radius,
        defocus_disk_v=v * defocus_radius,
        defocus_angle=params.defocus_angle,
    )


def generate_rays(
    cfg: CameraConfig,
    cam: DerivedCamera,
    pixel_ids: jnp.ndarray,   # (B,) i32 flat pixel index (row-major)
    sample_ids: jnp.ndarray,  # (B,) i32 sample index within the pixel
    seed,
    motion_blur: bool = True,
):
    """Batched get_ray (camera.hpp:139-162): AA jitter in [-0.5, 0.5)²,
    optional defocus-disk origin, U[0,1) ray time. Directions are left
    unnormalized, matching the reference's t parameterization.

    Returns (origin (B,3), direction (B,3), time (B,)).
    """
    i = (pixel_ids % cfg.image_width).astype(jnp.float32)
    j = (pixel_ids // cfg.image_width).astype(jnp.float32)

    u4 = rng_mod.uniform4(pixel_ids, sample_ids, jnp.uint32(rng_mod.STREAM_RAYGEN), seed)
    offset = rng_mod.square_offset(u4)  # (B, 2)
    pixel_sample = (
        cam.pixel00[None, :]
        + (i + offset[:, 0])[:, None] * cam.pixel_delta_u[None, :]
        + (j + offset[:, 1])[:, None] * cam.pixel_delta_v[None, :]
    )

    if cfg.defocus_angle > 0.0:
        disk = rng_mod.unit_disk(u4[:, 2:4])  # (B, 2)
        origin = (
            cam.center[None, :]
            + disk[:, 0:1] * cam.defocus_disk_u[None, :]
            + disk[:, 1:2] * cam.defocus_disk_v[None, :]
        )
    else:
        origin = jnp.broadcast_to(cam.center[None, :], pixel_sample.shape)

    direction = pixel_sample - origin

    if motion_blur:
        time = rng_mod.uniform4(
            pixel_ids, sample_ids, jnp.uint32(rng_mod.STREAM_TIME), seed
        )[:, 0]
    else:
        time = jnp.zeros(pixel_ids.shape, jnp.float32)
    return origin, direction, time
