"""Top-level render driver: batches (pixel-block × sample-chunk) launches of
the jitted wavefront integrator and accumulates radiance.

This replaces the reference's triple render loop (src/core/camera.hpp:40-67):
the pixel and sample loops become one megabatch ray dimension per launch;
the bounce recursion is the integrator's scan. Chunking bounds device memory
for arbitrarily large (W·H·spp) workloads and gives natural
checkpoint/resume boundaries (SURVEY.md §5 checkpoint/resume).
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.color import to_u8_image
from ..ops.intersect import closest_hit_brute
from ..scene.types import Scene
from . import camera as cam_mod
from .camera import CameraConfig, CameraParams
from .integrator import trace

HIT_METHODS = ("auto", "brute", "bvh", "triton")


@dataclass
class RenderResult:
    radiance: np.ndarray  # (H, W, 3) f32 mean radiance
    segments: int         # total ray-scene queries traced
    seconds: float        # wall-clock render time (excludes compile)
    launches: int

    @property
    def image_u8(self) -> np.ndarray:
        return np.asarray(to_u8_image(jnp.asarray(self.radiance)))


def auto_hit_method(scene: Scene, platform: Optional[str] = None) -> str:
    """The closest-hit path ``hit_method="auto"`` resolves to on
    ``platform`` (default: JAX's default backend)."""
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return "triton"
    if scene.bvh is not None and scene.n_primitives > 64:
        return "bvh"
    return "brute"


def pick_hit_fn(scene: Scene, method: str = "auto",
                platform: Optional[str] = None) -> Callable:
    """Resolve a ``hit_method`` name to a ``HitFn``."""
    if method not in HIT_METHODS:
        raise ValueError(f"hit_method must be one of {HIT_METHODS}")
    if method == "auto":
        method = auto_hit_method(scene, platform)
    if method == "triton":
        from ..ops.hit_triton import closest_hit_triton

        return closest_hit_triton
    if method == "bvh":
        if scene.bvh is None:
            raise ValueError("scene was compiled without a BVH")
        from ..ops.traverse import closest_hit_bvh

        return closest_hit_bvh
    return closest_hit_brute


def _render_chunk(
    scene: Scene,
    params: CameraParams,
    pixel_start: jnp.ndarray,   # () i32 — first pixel of the block
    sample_start: jnp.ndarray,  # () i32 — first sample of the chunk
    seed: jnp.ndarray,          # () u32
    *,
    cfg: CameraConfig,
    n_block: int,
    spp_chunk: int,
    hit_fn: Callable,
    mode: str,
    remat: bool,
):
    """One launch: n_block contiguous pixels × spp_chunk samples, laid out
    sample-major. Returns (block radiance *sum* over the chunk's samples
    (n_block, 3), segments traced ())."""
    derived = cam_mod.derive(cfg, params)
    pix_raw = pixel_start + jnp.arange(n_block, dtype=jnp.int32)
    pix = jnp.minimum(pix_raw, cfg.n_pixels - 1)      # clamp tail padding
    pixel_ids = jnp.tile(pix, spp_chunk)               # (B,)
    sample_ids = sample_start + jnp.repeat(
        jnp.arange(spp_chunk, dtype=jnp.int32), n_block)
    o, d, t = cam_mod.generate_rays(
        cfg, derived, pixel_ids, sample_ids, seed,
        motion_blur=scene.flags.has_moving,
    )
    # Padded rays — tail samples (sample >= spp) AND the last block's
    # clamped duplicate pixels — start dead: they neither trace (no wasted
    # bounces) nor count toward the segments metric.
    valid0 = ((sample_ids < cfg.samples_per_pixel)
              & jnp.tile(pix_raw < cfg.n_pixels, spp_chunk))
    radiance, segments = trace(
        scene, o, d, t, pixel_ids, sample_ids,
        jnp.asarray(cfg.background, jnp.float32), cfg.max_depth, seed,
        hit_fn=hit_fn, mode=mode, remat=remat, active0=valid0,
    )
    # Mask samples past spp (tail of the last sample chunk).
    valid = (sample_ids < cfg.samples_per_pixel)[:, None]
    radiance = jnp.where(valid, radiance, 0.0)
    return radiance.reshape(spp_chunk, n_block, 3).sum(axis=0), segments


class Renderer:
    """Caches the compiled chunk function across calls for a given
    (scene structure, camera config, batching plan)."""

    def __init__(
        self,
        cfg: CameraConfig,
        *,
        hit_method: str = "auto",
        mode: str = "scan",
        remat: bool = False,
        max_rays_per_launch: int = 1 << 18,
        fused: bool = True,
    ):
        if hit_method not in HIT_METHODS:
            raise ValueError(f"hit_method must be one of {HIT_METHODS}")
        self.cfg = cfg
        self.hit_method = hit_method
        self.mode = mode
        self.remat = remat
        # whole-render single-dispatch mode (see render()); falls back to
        # the per-chunk loop when progress/checkpointing needs host control
        self.fused = fused
        n_pix = cfg.n_pixels
        self.n_block = min(n_pix, max_rays_per_launch)
        self.spp_chunk = max(
            1, min(cfg.samples_per_pixel, max_rays_per_launch // self.n_block))
        self._compiled_scene = None
        self._chunk_fn = None
        self._compiled = None
        self._fused_key = None
        self._fused_exe = None

    def _get_compiled(self, scene: Scene):
        # the hit method is resolved per scene (auto looks at its size)
        if self._compiled is None or scene is not self._compiled_scene:
            self._compiled_scene = scene
            self._chunk_fn = partial(
                _render_chunk, cfg=self.cfg, n_block=self.n_block,
                spp_chunk=self.spp_chunk,
                hit_fn=pick_hit_fn(scene, self.hit_method),
                mode=self.mode, remat=self.remat)
            self._compiled = jax.jit(self._chunk_fn)
        return self._compiled

    def _get_fused(self, scene: Scene, params, accum, seed_arr,
                   n_blocks: int, start_schunk: int, total: int):
        """Whole-render executable: a fori_loop over all (sample-chunk,
        block) chunks in one jit — one host dispatch for the full image.
        Compiled ahead of time so the timed call excludes compilation."""
        self._get_compiled(scene)
        key = (n_blocks, start_schunk, total, self._compiled_scene)
        if self._fused_key == key:
            return self._fused_exe
        chunk_fn = self._chunk_fn
        n_block, spp_chunk = self.n_block, self.spp_chunk

        def render_all(scene, params, accum0, seed):
            def body(i, carry):
                accum, segs = carry
                c = i + start_schunk * n_blocks
                s = c // n_blocks
                b = c % n_blocks
                rad, seg = chunk_fn(
                    scene, params, b * n_block, s * spp_chunk, seed)
                old = jax.lax.dynamic_slice(
                    accum, (b * n_block, 0), (n_block, 3))
                accum = jax.lax.dynamic_update_slice(
                    accum, old + rad, (b * n_block, 0))
                return accum, segs.at[i].set(seg)

            return jax.lax.fori_loop(
                0, total, body, (accum0, jnp.zeros((total,), jnp.int32)))

        self._fused_exe = jax.jit(render_all).lower(
            scene, params, accum, seed_arr).compile()
        self._fused_key = key
        return self._fused_exe

    def render(
        self,
        scene: Scene,
        params: Optional[CameraParams] = None,
        seed: int = 0,
        progress: bool = False,
        resume_state: Optional[dict] = None,
        checkpoint_cb: Optional[Callable[[dict], None]] = None,
    ) -> RenderResult:
        cfg = self.cfg
        if params is None:
            params = CameraParams.from_config(cfg)
        fn = self._get_compiled(scene)
        seed_arr = jnp.uint32(seed)

        n_pix = cfg.n_pixels
        n_blocks = -(-n_pix // self.n_block)
        n_schunks = -(-cfg.samples_per_pixel // self.spp_chunk)

        accum = jnp.zeros((n_blocks * self.n_block, 3), jnp.float32)
        seg_base = 0
        # Per-launch i32 counts stay on device (no per-launch sync) and are
        # summed on host in int64 at the end: a device-side i32 running sum
        # would overflow at ~2.1e9 segments (e.g. 1080p @ 500 spp, depth 50).
        seg_parts: list = []
        launches = 0
        start_schunk = 0
        if resume_state is not None:
            accum = jnp.asarray(resume_state["accum"])
            seg_base = int(resume_state["segments"])
            start_schunk = int(resume_state["schunk"])

        if self.fused and checkpoint_cb is None and not progress:
            total = (n_schunks - start_schunk) * n_blocks
            compiled = self._get_fused(scene, params, accum, seed_arr,
                                       n_blocks, start_schunk, total)
            t0 = _time.perf_counter()
            accum, segs_vec = jax.block_until_ready(
                compiled(scene, params, accum, seed_arr))
            seconds = _time.perf_counter() - t0
            seg_parts = [segs_vec]
            launches = total
        else:
            # Warm-up compile outside the timed region.
            jax.block_until_ready(
                fn(scene, params, jnp.int32(0), jnp.int32(0), seed_arr))
            t0 = _time.perf_counter()
            for s in range(start_schunk, n_schunks):
                for b in range(n_blocks):
                    rad, seg = fn(scene, params, jnp.int32(b * self.n_block),
                                  jnp.int32(s * self.spp_chunk), seed_arr)
                    accum = accum.at[
                        b * self.n_block:(b + 1) * self.n_block].add(rad)
                    seg_parts.append(seg)
                    launches += 1
                if progress:
                    print(f"\rsample chunks remaining: {n_schunks - s - 1} ",
                          end="", flush=True)
                if checkpoint_cb is not None:
                    checkpoint_cb({
                        "accum": np.asarray(accum),
                        "segments": seg_base + int(np.sum(
                            np.asarray(jnp.stack(seg_parts), np.int64))),
                        "schunk": s + 1,
                    })
            jax.block_until_ready(accum)
            seconds = _time.perf_counter() - t0
            if progress:
                print("\rDone.                        ", flush=True)

        segments = seg_base + int(np.sum(
            [np.asarray(p, np.int64).sum() for p in seg_parts], initial=0))
        mean = np.asarray(accum)[:n_pix] / cfg.samples_per_pixel
        return RenderResult(
            radiance=mean.reshape(cfg.image_height, cfg.image_width, 3),
            segments=segments,
            seconds=seconds,
            launches=launches,
        )


def render(
    scene: Scene,
    cfg: CameraConfig,
    params: Optional[CameraParams] = None,
    seed: int = 0,
    hit_method: str = "auto",
    mode: str = "scan",
    remat: bool = False,
    max_rays_per_launch: int = 1 << 20,
    progress: bool = False,
) -> RenderResult:
    """One-shot functional API over :class:`Renderer`."""
    return Renderer(
        cfg,
        hit_method=hit_method,
        mode=mode,
        remat=remat,
        max_rays_per_launch=max_rays_per_launch,
    ).render(scene, params, seed, progress=progress)
