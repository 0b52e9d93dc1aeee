"""The Triton-route closest-hit kernel (ops/hit_triton.py) in Pallas
interpret mode, against ``closest_hit_brute`` — the plain reference.

Batches stay within two 128-ray blocks so the interpreter is quick. The
compiled kernel on a GPU is judged by tests/test_gpu.py.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracing_tpu.diff.gradients import render_once
from raytracing_tpu.models.scenes import SCENES, build
from raytracing_tpu.ops import hit_triton
from raytracing_tpu.ops.hit_triton import BLOCK, closest_hit_triton, closest_t_id
from raytracing_tpu.ops.intersect import closest_hit_brute
from raytracing_tpu.render import camera as cam_mod
from raytracing_tpu.render.camera import CameraParams
from raytracing_tpu.scene.builder import SceneBuilder
from raytracing_tpu.utils.hit_compare import hit_agreement

kernel_hit = partial(closest_hit_triton, interpret=True)


def _camera_rays(scene, cfg, n, seed=1):
    idx = jnp.arange(n, dtype=jnp.int32)
    derived = cam_mod.derive(cfg, CameraParams.from_config(cfg))
    return cam_mod.generate_rays(
        cfg, derived, idx % cfg.n_pixels, idx // cfg.n_pixels,
        jnp.uint32(seed), motion_blur=scene.flags.has_moving)


def _rays(*rows, time=0.0):
    o = jnp.asarray([r[0] for r in rows], jnp.float32)
    d = jnp.asarray([r[1] for r in rows], jnp.float32)
    return o, d, jnp.full((len(rows),), time, jnp.float32)


def _assert_same_hits(scene, o, d, t):
    got = kernel_hit(scene, o, d, t)
    ref = closest_hit_brute(scene, o, d, t)
    np.testing.assert_array_equal(np.asarray(got.prim_id),
                                  np.asarray(ref.prim_id))
    np.testing.assert_array_equal(np.asarray(got.valid),
                                  np.asarray(ref.valid))
    return got, ref


@pytest.mark.parametrize("name", sorted(SCENES))
def test_matches_brute_on_scene(name):
    """Every registry scene, a ragged batch (not a multiple of the block):
    the decisions agree under utils/hit_compare's criteria and the
    differentiable recompute returns the reference's hit record."""
    scene, cfg = build(name, image_width=24, samples_per_pixel=1,
                       max_depth=2)
    o, d, t = _camera_rays(scene, cfg, BLOCK + 77)
    t_k, id_k = closest_t_id(scene, o, d, t, interpret=True)
    ref = closest_hit_brute(scene, o, d, t)
    agree = hit_agreement(scene, o, d, t, t_k, id_k, ref.t, ref.prim_id)
    assert agree["non_tie_disagreements"] == 0, agree
    assert agree["t_beyond_rounding_bound"] == 0, agree
    got = kernel_hit(scene, o, d, t)
    same = np.asarray(got.prim_id) == np.asarray(ref.prim_id)
    assert same.mean() >= 0.99, agree
    np.testing.assert_allclose(np.asarray(got.p)[same],
                               np.asarray(ref.p)[same], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [1, BLOCK - 1, BLOCK, BLOCK + 1])
def test_padding_to_block(n):
    """Batches padded up to the block size return exactly B results,
    identical to the same rays inside a larger batch."""
    scene, cfg = build("three_spheres", image_width=24, samples_per_pixel=1,
                       max_depth=2)
    o, d, t = _camera_rays(scene, cfg, 2 * BLOCK)
    t_all, id_all = closest_t_id(scene, o, d, t, interpret=True)
    t_n, id_n = closest_t_id(scene, o[:n], d[:n], t[:n], interpret=True)
    assert t_n.shape == (n,) and id_n.shape == (n,)
    np.testing.assert_array_equal(np.asarray(t_n), np.asarray(t_all)[:n])
    np.testing.assert_array_equal(np.asarray(id_n), np.asarray(id_all)[:n])


def test_all_miss():
    scene, _ = build("three_spheres")
    o, d, t = _rays(((0, 0, 0), (0, 1, 0)), ((0, 0, 0), (0, 0, 1)),
                    ((0, 50, 0), (1, 0, 0)))
    got, _ = _assert_same_hits(scene, o, d, t)
    assert not np.asarray(got.valid).any()
    assert np.isinf(np.asarray(got.t)).all()
    assert (np.asarray(got.prim_id) == -1).all()


def test_inactive_zero_direction_rays_miss():
    """Padding lanes and dead rays with a zero direction never hit."""
    scene, _ = build("cornell_box")
    o, d, t = _rays(((278, 278, -800), (0, 0, 0)), ((0, 0, 0), (0, 0, 0)))
    t_k, _ = closest_t_id(scene, o, d, t, interpret=True)
    assert np.isinf(np.asarray(t_k)).all()


def test_tie_lowest_index_wins():
    b = SceneBuilder()
    m = b.lambertian((1, 1, 1))
    b.sphere((0, 0, -3), 1.0, m)
    b.sphere((0, 0, -3), 1.0, m)   # exact duplicate
    b.quad((4, -1, -2), (2, 0, 0), (0, 2, 0), m)
    b.quad((4, -1, -2), (2, 0, 0), (0, 2, 0), m)
    b.quad((-1, 4, -2), (2, 0, 0), (0, 2, 0), m)
    b.sphere((0, 5, -3), 1.0, m)   # ties the third quad at t = 2
    scene = b.compile(use_bvh=False)
    o, d, t = _rays(((0, 0, 0), (0, 0, -1)), ((5, 0, 0), (0, 0, -1)),
                    ((0, 5, 0), (0, 0, -1)))
    got, _ = _assert_same_hits(scene, o, d, t)
    # sphere ids precede quad ids, so the sphere wins the sphere-quad tie
    assert list(np.asarray(got.prim_id)) == [0, scene.n_spheres, 2]


def test_zero_radius_sphere_never_hits():
    b = SceneBuilder()
    m = b.lambertian((1, 1, 1))
    b.sphere((0, 0, -3), 0.0, m)
    b.sphere((0, 0, -6), 1.0, m)
    scene = b.compile(use_bvh=False)
    o, d, t = _rays(((0, 0, 0), (0, 0, -1)))
    got, _ = _assert_same_hits(scene, o, d, t)
    assert int(got.prim_id[0]) == 1


def test_degenerate_quad_never_hits():
    b = SceneBuilder()
    m = b.lambertian((1, 1, 1))
    b.quad((-1, -1, -2), (2, 0, 0), (4, 0, 0), m)  # u ∥ v: zero normal
    b.quad((-1, -1, -4), (2, 0, 0), (0, 2, 0), m)
    scene = b.compile(use_bvh=False)
    o, d, t = _rays(((0, 0, 0), (0, 0, -1)), ((0, 0, 0), (0, 0.1, -1)))
    got, _ = _assert_same_hits(scene, o, d, t)
    assert (np.asarray(got.prim_id) == scene.n_spheres + 1).all()


def test_motion_blur_center_at_time():
    b = SceneBuilder()
    b.sphere((0, 0, -3), 0.5, b.lambertian((1, 1, 1)), center2=(2, 0, -3))
    scene = b.compile(use_bvh=False)
    rows = [((0, 0, 0), (0, 0, -1)), ((2, 0, 0), (0, 0, -1))]
    for time, want in ((0.0, [True, False]), (1.0, [False, True])):
        o, d, t = _rays(*rows, time=time)
        got, _ = _assert_same_hits(scene, o, d, t)
        assert list(np.asarray(got.valid)) == want


def test_grad_rule_matches_brute():
    """jax.grad through the integrator with the kernel hit function equals
    jax.grad with closest_hit_brute (decision held, winner recomputed)."""
    scene, cfg = build("bouncing_spheres", image_width=12,
                       samples_per_pixel=2, max_depth=4)

    def loss(center, rgb, hit_fn):
        s = scene.replace(spheres=scene.spheres.replace(center=center),
                          textures=scene.textures.replace(rgb=rgb))
        return jnp.mean(render_once(s, cfg, seed=1, hit_fn=hit_fn) ** 2)

    args = (scene.spheres.center, scene.textures.rgb)
    g_k = jax.grad(partial(loss, hit_fn=kernel_hit), argnums=(0, 1))(*args)
    g_b = jax.grad(partial(loss, hit_fn=closest_hit_brute),
                   argnums=(0, 1))(*args)
    assert np.abs(np.asarray(g_b[1])).max() > 0
    for a, b in zip(g_k, g_b):
        # tests/test_replay.py's tolerance for this scene
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-6)


def test_grad_rule_geometry_matches_brute():
    """A marble-textured sphere (continuous shading, so the pathwise
    geometry gradient is non-zero): d(image)/d(center) through the kernel
    hit function equals the brute-force one (tests/test_grad.py's
    BVH-vs-brute tolerance)."""
    from raytracing_tpu.render.camera import CameraConfig

    b = SceneBuilder()
    b.sphere((0.0, 0.0, -3.0), 1.0, b.lambertian(b.noise(2.0)))
    scene = b.compile(use_bvh=False)
    cfg = CameraConfig(image_width=8, samples_per_pixel=2, max_depth=3,
                       background=(0.7, 0.8, 1.0), vfov=40.0)

    def loss(center, hit_fn):
        s = scene.replace(spheres=scene.spheres.replace(center=center))
        return jnp.mean(render_once(s, cfg, seed=1, hit_fn=hit_fn))

    g_k = jax.grad(partial(loss, hit_fn=kernel_hit))(scene.spheres.center)
    g_b = jax.grad(partial(loss, hit_fn=closest_hit_brute))(
        scene.spheres.center)
    assert np.abs(np.asarray(g_b[0])).max() > 0
    np.testing.assert_allclose(np.asarray(g_k), np.asarray(g_b),
                               rtol=1e-3, atol=1e-6)


def test_kernel_inputs_carry_no_gradient():
    """The kernel sees only stop-gradient inputs: differentiating the hit
    record w.r.t. the scene never transposes the pallas_call."""
    scene, cfg = build("three_spheres", image_width=8, samples_per_pixel=1,
                       max_depth=2)
    o, d, t = _camera_rays(scene, cfg, 16)

    def f(center):
        s = scene.replace(spheres=scene.spheres.replace(center=center))
        return jnp.sum(kernel_hit(s, o, d, t).p)

    g = jax.grad(f)(scene.spheres.center)
    assert np.isfinite(np.asarray(g)).all() and np.abs(np.asarray(g)).max() > 0


def test_primitive_tables_pad_to_powers_of_two():
    scene, _ = build("bouncing_spheres")
    sph_t, quad_t = hit_triton.primitive_tables(scene)
    assert sph_t.shape == (512, hit_triton.SPH_FIELDS)
    assert quad_t.shape[1] == hit_triton.QUAD_FIELDS
    assert quad_t.shape[0] & (quad_t.shape[0] - 1) == 0
    assert not np.asarray(sph_t[scene.n_spheres:]).any()


def test_compiled_route_is_triton_only():
    """Without interpret=True the kernel is a GPU kernel: on the CPU it
    refuses to lower instead of falling back to the interpreter."""
    scene, cfg = build("three_spheres", image_width=8, samples_per_pixel=1,
                       max_depth=2)
    o, d, t = _camera_rays(scene, cfg, 8)
    with pytest.raises(Exception):
        jax.block_until_ready(closest_t_id(scene, o, d, t))
