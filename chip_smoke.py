"""Smoke test of the path tracer on one NVIDIA GPU.

    python chip_smoke.py           # one card: all phases below
    python chip_smoke.py --four    # four cards: the sharded paths only

One card, in one process:

1. device — JAX's default device must be a GPU;
2. kernel — the Triton closest-hit sweep compiled at the Renderer's launch
   width (2^18 rays) on the final scene and the Cornell box, compared with
   ``closest_hit_brute``, with the compiled step's ``memory_analysis()``;
3. forward — the default ``Renderer`` on the final scene at BASELINE.md
   config 3's size (400×225, 100 spp, depth 20): segments, seconds, rays/s
   and peak device memory;
4. inverse rendering — 3 optimizer steps each of ``fit_sphere_params`` and
   ``fit_albedo``, through autodiff and through ``render_replay``, on the
   final scene at 400×225, depth 20, 2 spp: finite losses, and albedos
   that move and lower the loss;
5. GPU tests — ``pytest -m gpu tests/`` in this process: the kernel
   comparison, images vs the float64 oracle, the Cornell canary and
   replay-vs-autodiff gradients.

Four cards (``--four``): ``render_sharded`` with dp=4 and with dp=2 × tp=2
on the final scene at 400×225, each compared with the one-card
``Renderer`` image at the same seed, then one sharded training step
(``__graft_entry__.dryrun_multichip(4)``).

Any failed phase fails the script. The last line of standard output is a
JSON object with ``ok`` and the device JAX reports.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

FINAL = dict(image_width=400, samples_per_pixel=100, max_depth=20)
LAUNCH = 1 << 18


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, msg: str) -> None:
    """Fail the phase (a raise, so that ``python -O`` keeps the check)."""
    if not ok:
        raise RuntimeError(msg)


def phase(name: str):
    """Decorator: time a phase and label its output."""
    def wrap(fn):
        def run(*a, **kw):
            log(f"== {name}")
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            log(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)")
            return out
        return run
    return wrap


@phase("kernel")
def kernel_phase():
    import jax

    from raytracing_tpu.models.scenes import build
    from raytracing_tpu.ops.hit_triton import closest_t_id
    from raytracing_tpu.ops.intersect import closest_hit_brute
    from raytracing_tpu.utils.hit_compare import hit_agreement, ray_batches

    for name in ("bouncing_spheres", "cornell_box"):
        scene, cfg = build(name, image_width=400)
        for batch, rays in ray_batches(scene, cfg, LAUNCH).items():
            compiled = jax.jit(closest_t_id).lower(scene, *rays).compile()
            t_k, id_k = compiled(scene, *rays)
            with jax.default_matmul_precision("highest"):
                ref = jax.jit(closest_hit_brute)(scene, *rays)
            agree = hit_agreement(scene, *rays, t_k, id_k, ref.t,
                                  ref.prim_id)
            log(f"{name} {batch}: {json.dumps(agree)}")
            log(f"{name} {batch} memory: {compiled.memory_analysis()}")
            check(agree["ok"], "kernel disagrees with the reference")


@phase("forward")
def forward_phase(card: str):
    import jax
    import numpy as np

    from raytracing_tpu.models.scenes import build
    from raytracing_tpu.render.renderer import Renderer, auto_hit_method

    scene, cfg = build("bouncing_spheres", **FINAL)
    r = Renderer(cfg)
    t0 = time.perf_counter()
    r.render(scene, seed=7)
    setup = time.perf_counter() - t0
    res = r.render(scene, seed=7)
    check(res.segments > 0, "no segments traced")
    check(np.isfinite(res.radiance).all(), "non-finite image")
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    log(json.dumps(dict(
        scene="bouncing_spheres", width=cfg.image_width,
        height=cfg.image_height, spp=cfg.samples_per_pixel,
        depth=cfg.max_depth, hit_method=auto_hit_method(scene),
        segments=res.segments, seconds=res.seconds,
        rays_per_s=res.segments / res.seconds, first_call_seconds=setup,
        peak_bytes_in_use=peak, card=card)))
    return res.radiance


@phase("inverse rendering")
def inverse_phase():
    """Sphere centers and radii get exactly zero pathwise gradient on the
    final scene (flat shading: solid/checker albedos and a constant
    background, diff/gradients.py), so ``fit_sphere_params`` must run and
    stay finite there, and ``fit_albedo`` must move its parameters."""
    import jax.numpy as jnp
    import numpy as np

    from raytracing_tpu.diff.gradients import render_once
    from raytracing_tpu.diff.optimize import fit_albedo, fit_sphere_params
    from raytracing_tpu.diff.replay import render_replay
    from raytracing_tpu.models.scenes import build
    from raytracing_tpu.render.renderer import pick_hit_fn

    scene, cfg = build("bouncing_spheres", image_width=400,
                       samples_per_pixel=2, max_depth=20)
    hit_fn = pick_hit_fn(scene, "auto")
    target = render_once(scene, cfg, seed=11, hit_fn=hit_fn, remat=False)
    start = scene.replace(textures=scene.textures.replace(
        rgb=scene.textures.rgb * 0.8))
    for render_fn in (render_once, render_replay):
        for fit, params in ((fit_sphere_params,
                             lambda s: (s.spheres.center, s.spheres.radius)),
                            (fit_albedo, lambda s: (s.textures.rgb,))):
            t0 = time.perf_counter()
            fitted, losses = fit(
                start, target, cfg, steps=3, seed=11,
                reseed_every_step=False, render_fn=render_fn, hit_fn=hit_fn)
            moved = max(float(jnp.max(jnp.abs(a - b))) for a, b in
                        zip(params(fitted), params(start)))
            log(json.dumps(dict(path=render_fn.__name__, fit=fit.__name__,
                                losses=[float(x) for x in losses],
                                max_param_step=moved,
                                seconds=time.perf_counter() - t0)))
            check(np.isfinite(np.asarray(losses)).all(), "non-finite loss")
            check(np.isfinite(moved), "non-finite parameters")
            if fit is fit_albedo:
                check(moved > 0, "the optimizer did not move the albedos")
                check(losses[-1] < losses[0], "the albedo fit did not descend")


@phase("gpu tests")
def gpu_tests_phase():
    import pytest

    class Count:
        passed = failed = skipped = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                Count.passed += 1
            elif report.failed:
                Count.failed += 1
            elif report.skipped:
                Count.skipped += 1

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests")], plugins=[Count()])
    log(f"gpu tests: {Count.passed} passed, {Count.failed} failed, "
        f"{Count.skipped} skipped")
    check(rc == 0 and Count.failed == 0 and Count.skipped == 0
          and Count.passed > 0, "gpu tests failed")


def _image_gap(img, ref) -> dict:
    import numpy as np

    diff = np.abs(img - ref).max(axis=-1)
    return dict(mean_abs=float(diff.mean()), max_abs=float(diff.max()),
                frac_above_1e_3=float((diff > 1e-3).mean()))


@phase("four cards")
def four_phase(n_dev=4, width=400, spp=100, depth=20):
    """dp=n_dev and dp=2 × tp=n_dev/2 renders of the final scene vs the
    one-card Renderer, then the sharded training step.

    Tolerance: RNG ids are global, so both trace the same paths, but the
    sharded program is compiled and summed differently; f32 rounding then
    flips a rare grazing decision, which moves one sample of one pixel.
    So: segments within 0.2%, mean per-pixel |difference| below 5e-4, and
    under 3% of pixels off by more than 1e-3."""
    import jax

    from raytracing_tpu.models.scenes import build
    from raytracing_tpu.parallel.mesh import make_mesh
    from raytracing_tpu.parallel.shard import render_sharded
    from raytracing_tpu.render.renderer import Renderer

    devs = jax.devices()
    check(len(devs) >= n_dev, f"need {n_dev} devices, have {len(devs)}")
    for mesh_shape, axes, method, s in (
            ((n_dev,), ("dp",), "auto", spp),
            ((2, n_dev // 2), ("dp", "tp"), "brute", max(1, spp // 5))):
        scene, cfg = build("bouncing_spheres", image_width=width,
                           samples_per_pixel=s, max_depth=depth)
        ref = Renderer(cfg).render(scene, seed=7)
        mesh = make_mesh(mesh_shape, axes, devices=devs[:n_dev])
        t0 = time.perf_counter()
        img, segs = render_sharded(scene, cfg, mesh, seed=7,
                                   hit_method=method)
        gap = _image_gap(img, ref.radiance)
        log(json.dumps(dict(mesh=dict(zip(axes, mesh_shape)), hit=method,
                            spp=s, segments=segs, ref_segments=ref.segments,
                            seconds_with_compile=time.perf_counter() - t0,
                            **gap)))
        check(abs(segs - ref.segments) <= ref.segments // 500,
              f"segments {segs} vs {ref.segments}")
        check(gap["mean_abs"] < 5e-4 and gap["frac_above_1e_3"] < 0.03,
              f"sharded image differs: {gap}")

    import __graft_entry__

    __graft_entry__.dryrun_multichip(n_dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded paths")
    args = ap.parse_args(argv)

    import jax

    from bench import card_info
    from raytracing_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {dev.platform})",
              file=sys.stderr)
        return 1
    enable_compile_cache()
    card = card_info()
    log(f"device: {dev.device_kind} x{len(jax.devices())}")
    if args.four:
        four_phase()
    else:
        kernel_phase()
        forward_phase(card.splitlines()[0])
        inverse_phase()
        gpu_tests_phase()
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
