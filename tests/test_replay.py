"""Decision-replay differentiable path (diff/replay.py).

Correctness claims tested:
  1. Replaying recorded decisions reproduces the forward integrator's
     radiance and honest segment count bit-for-bit (same RNG stream, same
     bounce body) — across every texture/material/geometry family.
  2. ``jax.grad`` through the replay equals ``jax.grad`` through the full
     autodiff forward (which differentiates the whole closest-hit search)
     — the pathwise gradients agree because the argmin is locally constant
     (diff/gradients.py contract).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracing_tpu.diff.gradients import render_once
from raytracing_tpu.diff.replay import (
    record_decisions,
    render_replay,
    replay_trace,
)
from raytracing_tpu.models.scenes import build
from raytracing_tpu.ops.intersect import closest_hit_brute
from raytracing_tpu.ops.traverse import closest_hit_bvh
from raytracing_tpu.render.integrator import trace
from raytracing_tpu.render import camera as cam_mod
from raytracing_tpu.render.camera import CameraParams


# (name, exact): exact scenes must match bit-for-bit. Noise-textured scenes
# get a tolerance: XLA fuses the winner-t math differently in the (B, N)
# sweep vs the (B,) replay (FMA contraction), and a 1-ulp t difference is
# amplified ~2^7 by the 7-octave turbulence before the marble sin.
SCENES = [
    ("three_spheres", True),      # lambertian + dielectric + metal, sky bg
    ("bouncing_spheres", True),   # moving spheres + checker + BVH flag
    ("cornell_box", True),        # quads, emission, black background
    ("perlin_sphere", False),     # marble noise texture
    ("quads", True),              # all-quad geometry
    ("simple_light", False),      # noise + diffuse light
]


def _rays(scene, cfg, seed=3):
    n_pix = cfg.n_pixels
    spp = cfg.samples_per_pixel
    pixel_ids = jnp.tile(jnp.arange(n_pix, dtype=jnp.int32), spp)
    sample_ids = jnp.repeat(jnp.arange(spp, dtype=jnp.int32), n_pix)
    params = CameraParams.from_config(cfg)
    derived = cam_mod.derive(cfg, params)
    o, d, t = cam_mod.generate_rays(
        cfg, derived, pixel_ids, sample_ids, jnp.uint32(seed),
        motion_blur=scene.flags.has_moving,
    )
    return o, d, t, pixel_ids, sample_ids


@pytest.mark.parametrize("name,exact", SCENES)
def test_replay_matches_forward(name, exact):
    scene, cfg = build(name, image_width=24, samples_per_pixel=2, max_depth=6)
    o, d, t, pix, smp = _rays(scene, cfg)
    bg = jnp.asarray(cfg.background, jnp.float32)
    seed = jnp.uint32(3)

    rad_fwd, seg_fwd = trace(
        scene, o, d, t, pix, smp, bg, cfg.max_depth, seed,
        hit_fn=closest_hit_brute, mode="scan",
    )
    ids = record_decisions(
        scene, o, d, t, pix, smp, bg, cfg.max_depth, seed,
        hit_fn=closest_hit_brute,
    )
    rad_rep, seg_rep = replay_trace(
        scene, ids, o, d, t, pix, smp, bg, cfg.max_depth, seed,
    )
    if exact:
        np.testing.assert_array_equal(np.asarray(rad_fwd), np.asarray(rad_rep))
    else:
        np.testing.assert_allclose(
            np.asarray(rad_fwd), np.asarray(rad_rep), atol=2e-3, rtol=0
        )
    assert int(seg_fwd) == int(seg_rep)


def test_replay_matches_forward_bvh_decisions():
    """Decisions recorded through the BVH hit fn replay identically too
    (BVH == brute winner is asserted elsewhere; this covers the plumbing)."""
    scene, cfg = build("bouncing_spheres", image_width=16, samples_per_pixel=2,
                       max_depth=5)
    o, d, t, pix, smp = _rays(scene, cfg)
    bg = jnp.asarray(cfg.background, jnp.float32)
    seed = jnp.uint32(3)
    rad_fwd, seg_fwd = trace(
        scene, o, d, t, pix, smp, bg, cfg.max_depth, seed,
        hit_fn=closest_hit_bvh, mode="scan",
    )
    ids = record_decisions(
        scene, o, d, t, pix, smp, bg, cfg.max_depth, seed,
        hit_fn=closest_hit_bvh,
    )
    rad_rep, _ = replay_trace(
        scene, ids, o, d, t, pix, smp, bg, cfg.max_depth, seed,
    )
    np.testing.assert_array_equal(np.asarray(rad_fwd), np.asarray(rad_rep))


def test_render_replay_equals_render_once():
    scene, cfg = build("cornell_box", image_width=16, samples_per_pixel=2,
                       max_depth=6)
    img0 = render_once(scene, cfg, seed=5)
    img1 = render_replay(scene, cfg, seed=5)
    np.testing.assert_array_equal(np.asarray(img0), np.asarray(img1))


# Tolerances are set by the scene's f32 conditioning, not by the replay:
# the full autodiff path compared against ITSELF with different fusion
# (remat=True vs False — mathematically identical) differs by up to 3.0%
# rel / 2.4e-3 abs on perlin_sphere (7-octave turbulence amplifies 1-ulp
# t differences by ~2^7 before the marble sin' factor). The replay must
# land inside that same noise floor.
@pytest.mark.parametrize("name,rtol,atol", [
    ("perlin_sphere", 0.04, 3e-3),
    ("bouncing_spheres", 2e-4, 2e-6),
])
def test_replay_grads_match_autodiff(name, rtol, atol):
    """∂MSE/∂(sphere centers, texture rgb) via replay == via the full
    autodiff forward — the same mathematical derivative."""
    scene, cfg = build(name, image_width=12, samples_per_pixel=2, max_depth=4)
    target = jnp.zeros((cfg.image_height, cfg.image_width, 3), jnp.float32)

    def loss_full(center, rgb):
        s = scene.replace(
            spheres=scene.spheres.replace(center=center),
            textures=scene.textures.replace(rgb=rgb),
        )
        img = render_once(s, cfg, seed=2)
        return jnp.mean((img - target) ** 2)

    def loss_replay(center, rgb):
        s = scene.replace(
            spheres=scene.spheres.replace(center=center),
            textures=scene.textures.replace(rgb=rgb),
        )
        img = render_replay(s, cfg, seed=2)
        return jnp.mean((img - target) ** 2)

    args = (scene.spheres.center, scene.textures.rgb)
    g_full = jax.jit(jax.grad(loss_full, argnums=(0, 1)))(*args)
    g_rep = jax.jit(jax.grad(loss_replay, argnums=(0, 1)))(*args)
    for a, b in zip(g_full, g_rep):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=rtol, atol=atol
        )


def test_replay_camera_grads_match():
    scene, cfg = build("perlin_sphere", image_width=10, samples_per_pixel=2,
                       max_depth=3)
    target = jnp.zeros((cfg.image_height, cfg.image_width, 3), jnp.float32)
    p0 = CameraParams.from_config(cfg)

    def loss(fn, lookfrom):
        p = p0.replace(lookfrom=lookfrom)
        img = fn(scene, cfg, params=p, seed=4)
        return jnp.mean((img - target) ** 2)

    g_full = jax.jit(jax.grad(lambda lf: loss(render_once, lf)))(p0.lookfrom)
    g_rep = jax.jit(jax.grad(lambda lf: loss(render_replay, lf)))(p0.lookfrom)
    # noise-scene conditioning — see test_replay_grads_match_autodiff
    np.testing.assert_allclose(
        np.asarray(g_full), np.asarray(g_rep), rtol=0.04, atol=3e-3
    )


# (name, rtol, atol): bit-exact scenes get test_replay_grads_match_autodiff's
# tight bound; noise scenes its noise-floor bound.
FAMILIES = [
    ("three_spheres", 2e-4, 2e-6),      # metal + dielectric branches
    ("cornell_box", 2e-4, 2e-6),        # quads + emission
    ("quads", 2e-4, 2e-6),              # all-quad geometry
    ("checkered_spheres", 2e-4, 2e-6),  # checker texture
    # image texture: a 1-ulp hit-point difference can move a nearest-texel
    # lookup to the neighbouring texel, so a handful of texel cotangents
    # (~1e-3 each at this size) land one texel over
    ("earth", 2e-4, 1e-3),
    ("simple_light", 0.04, 3e-3),       # noise + lights
]


@pytest.mark.parametrize("name,rtol,atol", FAMILIES)
def test_replay_albedo_grads_per_family(name, rtol, atol):
    """∂MSE/∂(texture rgb, image texels) via render_replay == via
    render_once autodiff, for every material/texture/geometry family."""
    scene, cfg = build(name, image_width=10, samples_per_pixel=2,
                       max_depth=3)
    target = jnp.full((cfg.image_height, cfg.image_width, 3), 0.5)

    def loss(fn, rgb, texels):
        s = scene.replace(textures=scene.textures.replace(rgb=rgb),
                          atlas=scene.atlas.replace(texels=texels))
        return jnp.mean((fn(s, cfg, seed=1) - target) ** 2)

    args = (scene.textures.rgb, scene.atlas.texels)
    g_full = jax.jit(jax.grad(lambda *a: loss(render_once, *a),
                              argnums=(0, 1)))(*args)
    g_rep = jax.jit(jax.grad(lambda *a: loss(render_replay, *a),
                             argnums=(0, 1)))(*args)
    assert max(np.abs(np.asarray(g)).max() for g in g_full) > 0
    for a, b in zip(g_rep, g_full):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["three_spheres", "cornell_box",
                                  "bouncing_spheres"])
def test_recorded_ids_match_across_hit_fns(name):
    """The decision pass records the same winner ids whichever hit function
    runs it — the contract that lets the fastest one serve replay."""
    scene, cfg = build(name, image_width=12, samples_per_pixel=2,
                       max_depth=4, use_bvh=True)
    o, d, t, pix, smp = _rays(scene, cfg, seed=0)
    bg = jnp.asarray(cfg.background, jnp.float32)
    ids = [
        np.asarray(record_decisions(scene, o, d, t, pix, smp, bg,
                                    cfg.max_depth, jnp.uint32(0), hit_fn=h))
        for h in (closest_hit_brute, closest_hit_bvh)
    ]
    np.testing.assert_array_equal(ids[0], ids[1])


def test_precomputed_ids_pass_through():
    """render_replay(ids=...) skips the decision pass and must agree with
    the self-recorded variant."""
    scene, cfg = build("quads", image_width=12, samples_per_pixel=2,
                       max_depth=4)
    o, d, t, pix, smp = _rays(scene, cfg, seed=0)
    bg = jnp.asarray(cfg.background, jnp.float32)
    ids = record_decisions(
        scene, o, d, t, pix, smp, bg, cfg.max_depth, jnp.uint32(0),
    )
    img0 = render_replay(scene, cfg, seed=0)
    img1 = render_replay(scene, cfg, seed=0, ids=ids)
    np.testing.assert_array_equal(np.asarray(img0), np.asarray(img1))
