"""Correctness on an NVIDIA GPU (marker ``gpu``; skipped without one).

    python -m pytest -m gpu tests/

* the compiled Triton sweep kernel vs ``closest_hit_brute`` at the
  Renderer's launch width (2^18 rays), camera rays and rays after one
  bounce, under utils/hit_compare's criteria;
* default-``Renderer`` images vs the float64 oracle (tests/oracle.py) with
  tests/test_golden_oracle.py's tolerances;
* the Cornell light-transport canary: a dot product run at TF32 instead of
  f32 at the box's 555-unit scale kills most light paths;
* ``render_replay`` gradients vs ``render_once`` autodiff gradients with
  the GPU hit function, with tests/test_replay.py's tolerances.

Everything is f32 and no path computes a matrix product; the references
still run under ``default_matmul_precision("highest")`` so that none
could silently drop to TF32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oracle import OracleRenderer

from raytracing_tpu.diff.gradients import render_once
from raytracing_tpu.diff.replay import render_replay
from raytracing_tpu.models.scenes import build
from raytracing_tpu.render.renderer import Renderer, pick_hit_fn

pytestmark = pytest.mark.gpu

LAUNCH = 1 << 18


@pytest.mark.parametrize("name,kw", [
    ("bouncing_spheres", dict(image_width=400)),
    ("cornell_box", dict(image_width=400)),
])
def test_kernel_matches_brute(gpu, name, kw):
    from raytracing_tpu.ops.hit_triton import closest_t_id
    from raytracing_tpu.ops.intersect import closest_hit_brute
    from raytracing_tpu.utils.hit_compare import hit_agreement, ray_batches

    scene, cfg = build(name, **kw)
    for batch, rays in ray_batches(scene, cfg, LAUNCH).items():
        t_k, id_k = jax.jit(closest_t_id)(scene, *rays)
        with jax.default_matmul_precision("highest"):
            ref = jax.jit(closest_hit_brute)(scene, *rays)
        agree = hit_agreement(scene, *rays, t_k, id_k, ref.t, ref.prim_id)
        assert agree["ok"], (batch, agree)


@pytest.mark.parametrize("name,overrides,mean_tol", [
    ("three_spheres", dict(image_width=64, samples_per_pixel=4,
                           max_depth=5), 2e-3),
    ("cornell_box", dict(image_width=32, samples_per_pixel=4,
                         max_depth=6), 2e-3),
    ("checkered_spheres", dict(image_width=64, samples_per_pixel=4,
                               max_depth=5), 2e-3),
    ("perlin_sphere", dict(image_width=32, samples_per_pixel=2,
                           max_depth=5), 8e-3),
    ("earth", dict(image_width=48, samples_per_pixel=2, max_depth=4), 2e-3),
])
def test_image_matches_f64_oracle(gpu, name, overrides, mean_tol):
    scene, cfg = build(name, **overrides)
    got = Renderer(cfg).render(scene, seed=3).radiance
    want = OracleRenderer(scene, cfg, seed=3).render()
    diff = np.abs(got - want)
    assert diff.mean() < mean_tol, f"mean diff {diff.mean()}"
    assert (diff.max(axis=-1) > 0.05).mean() < 0.02


def test_cornell_light_transport_canary(gpu):
    scene, cfg = build("cornell_box", image_width=64, samples_per_pixel=16,
                       max_depth=16)
    img = Renderer(cfg).render(scene, seed=0).radiance
    lit = (img.max(-1) > 0).mean()
    assert 0.25 < lit < 0.6, f"lit-pixel fraction {lit}: precision trap?"


@pytest.mark.parametrize("name,rtol,atol", [
    ("perlin_sphere", 0.04, 3e-3),
    ("bouncing_spheres", 2e-4, 2e-6),
])
def test_replay_grads_match_autodiff(gpu, name, rtol, atol):
    scene, cfg = build(name, image_width=12, samples_per_pixel=2,
                       max_depth=4)
    hit_fn = pick_hit_fn(scene, "auto")
    target = jnp.zeros((cfg.image_height, cfg.image_width, 3), jnp.float32)

    def loss(fn, center, rgb):
        s = scene.replace(spheres=scene.spheres.replace(center=center),
                          textures=scene.textures.replace(rgb=rgb))
        return jnp.mean((fn(s, cfg, seed=2, hit_fn=hit_fn) - target) ** 2)

    args = (scene.spheres.center, scene.textures.rgb)
    with jax.default_matmul_precision("highest"):
        g_full = jax.jit(jax.grad(lambda *a: loss(render_once, *a),
                                  argnums=(0, 1)))(*args)
    g_rep = jax.jit(jax.grad(lambda *a: loss(render_replay, *a),
                             argnums=(0, 1)))(*args)
    for a, b in zip(g_full, g_rep):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=rtol, atol=atol)
