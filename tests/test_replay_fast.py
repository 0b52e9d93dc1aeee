"""Packed-table fast replay vs the reference replay path.

The fast replay (diff/replay_fast.py) must be BIT-identical to
diff/replay.py replay_trace in radiance and segment count (same ops on
the same values — only the data sourcing changes), and its gradients
must match the slow path's to reassociation tolerance (one packed-table
gather's scatter-add sums the cotangents in another order than ~25
separate gathers' scatter-adds).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracing_tpu.diff.replay import record_decisions, replay_trace
from raytracing_tpu.diff.replay_fast import (
    replay_trace_fast, supported_fast,
)
from raytracing_tpu.models.scenes import build
from raytracing_tpu.render import camera as cam_mod
from raytracing_tpu.render.camera import CameraParams


def _setup(name, width=24, spp=2, depth=8, seed=5):
    scene, cfg = build(name, image_width=width, samples_per_pixel=spp,
                       max_depth=depth)
    n_pix = cfg.n_pixels
    B = n_pix * spp
    pix = jnp.tile(jnp.arange(n_pix, dtype=jnp.int32), spp)
    smp = jnp.repeat(jnp.arange(spp, dtype=jnp.int32), n_pix)
    params = CameraParams.from_config(cfg)
    derived = cam_mod.derive(cfg, params)
    o, d, t = cam_mod.generate_rays(cfg, derived, pix, smp,
                                    jnp.uint32(seed),
                                    motion_blur=scene.flags.has_moving)
    bg = jnp.asarray(cfg.background, jnp.float32)
    ids = record_decisions(scene, o, d, t, pix, smp, bg, depth,
                           jnp.uint32(seed))
    return scene, cfg, ids, o, d, t, pix, smp, bg, depth, seed


class TestReplayFast:
    @pytest.mark.parametrize("name", [
        "three_spheres", "bouncing_spheres", "quads", "cornell_box",
        "checkered_spheres",
    ])
    def test_bit_identical_radiance_and_segments(self, name):
        scene, cfg, ids, o, d, t, pix, smp, bg, depth, seed = _setup(name)
        assert supported_fast(scene), name
        want, wseg = replay_trace(scene, ids, o, d, t, pix, smp, bg,
                                  depth, jnp.uint32(seed))
        got, gseg = replay_trace_fast(scene, ids, o, d, t, pix, smp, bg,
                                      depth, jnp.uint32(seed))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert int(gseg) == int(wseg)

    def test_unsupported_scenes_detected(self):
        for name in ("earth", "perlin_sphere"):
            scene, _ = build(name, image_width=16, samples_per_pixel=1,
                             max_depth=2)
            assert not supported_fast(scene)

    def test_gradients_match_slow_replay(self):
        scene, cfg, ids, o, d, t, pix, smp, bg, depth, seed = _setup(
            "bouncing_spheres", width=16, spp=2, depth=6)

        def loss(fn, center, rgb, qq):
            s = scene.replace(
                spheres=scene.spheres.replace(center=center),
                textures=scene.textures.replace(rgb=rgb),
                quads=scene.quads.replace(q=qq),
            )
            rad, _ = fn(s, ids, o, d, t, pix, smp, bg, depth,
                        jnp.uint32(seed))
            return jnp.sum(rad * rad)

        args = (scene.spheres.center, scene.textures.rgb, scene.quads.q)
        g_slow = jax.grad(lambda *a: loss(replay_trace, *a),
                          argnums=(0, 1, 2))(*args)
        g_fast = jax.grad(lambda *a: loss(replay_trace_fast, *a),
                          argnums=(0, 1, 2))(*args)
        for gs, gf in zip(g_slow, g_fast):
            np.testing.assert_allclose(np.asarray(gf), np.asarray(gs),
                                       rtol=2e-5, atol=2e-6)
