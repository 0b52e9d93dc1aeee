"""The XLA closest-hit paths and how ``Renderer`` chooses among them.

* ``closest_hit_bvh`` (lockstep skip-link walk) returns the same hits as
  ``closest_hit_brute`` on every registry scene, with a batch size that is
  no power of two;
* ``hit_method="auto"`` resolves per platform string: the Triton sweep
  kernel on a GPU, the BVH or the sweep on the CPU by scene size.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from raytracing_tpu.models.scenes import SCENES, build
from raytracing_tpu.ops.hit_triton import closest_hit_triton
from raytracing_tpu.ops.intersect import closest_hit_brute
from raytracing_tpu.ops.traverse import closest_hit_bvh
from raytracing_tpu.render import camera as cam_mod
from raytracing_tpu.render.camera import CameraParams
from raytracing_tpu.render.renderer import Renderer, auto_hit_method, pick_hit_fn


def _camera_rays(scene, cfg, n, seed=1):
    idx = jnp.arange(n, dtype=jnp.int32)
    derived = cam_mod.derive(cfg, CameraParams.from_config(cfg))
    return cam_mod.generate_rays(
        cfg, derived, idx % cfg.n_pixels, idx // cfg.n_pixels,
        jnp.uint32(seed), motion_blur=scene.flags.has_moving)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_bvh_matches_brute_on_scene(name):
    scene, cfg = build(name, image_width=32, samples_per_pixel=1,
                       max_depth=2, use_bvh=True)
    o, d, t = _camera_rays(scene, cfg, 333)
    a = closest_hit_brute(scene, o, d, t)
    b = closest_hit_bvh(scene, o, d, t)
    np.testing.assert_array_equal(np.asarray(b.prim_id),
                                  np.asarray(a.prim_id))
    np.testing.assert_allclose(np.asarray(b.t), np.asarray(a.t),
                               rtol=1e-5)


@pytest.mark.parametrize("platform,name,want", [
    ("gpu", "bouncing_spheres", "triton"),
    ("gpu", "three_spheres", "triton"),
    ("cpu", "bouncing_spheres", "bvh"),
    ("cpu", "three_spheres", "brute"),
])
def test_auto_choice_per_platform(platform, name, want):
    scene, _ = build(name)
    assert auto_hit_method(scene, platform) == want


def test_pick_hit_fn_names():
    scene, _ = build("bouncing_spheres")
    assert pick_hit_fn(scene, "brute") is closest_hit_brute
    assert pick_hit_fn(scene, "bvh") is closest_hit_bvh
    assert pick_hit_fn(scene, "triton") is closest_hit_triton
    assert pick_hit_fn(scene, "auto", "gpu") is closest_hit_triton
    assert pick_hit_fn(scene, "auto", "cpu") is closest_hit_bvh


def test_unknown_hit_method_raises():
    scene, cfg = build("three_spheres")
    with pytest.raises(ValueError):
        pick_hit_fn(scene, "mega")
    with pytest.raises(ValueError):
        Renderer(cfg, hit_method="mega")


def test_bvh_without_bvh_raises():
    scene, _ = build("three_spheres", use_bvh=False)
    with pytest.raises(ValueError, match="without a BVH"):
        pick_hit_fn(scene, "bvh")
