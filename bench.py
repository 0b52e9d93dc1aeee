"""Benchmark harness: rays/s on the final scene (BASELINE.md config 3:
bouncing_spheres, 488 spheres, 400×225 @ 100 spp, depth 20; target
≥ 5e8 rays/s per chip), forward and forward+backward, on one GPU.

    python bench.py                 # one JSON line, forward + fwd+bwd
    python bench.py --devices 4     # dp scaling over 4 GPUs

"rays" = ray-scene intersection queries actually traced (path segments),
counted exactly by the integrator's active-mask sum — the standard
wavefront-path-tracer throughput unit.

Everything runs in this one process. Each measurement compiles ahead of
time, runs once to warm up, then times ``--reps`` runs ended by
``block_until_ready``; it reports the median and the spread
(max - min) / median. Without a GPU the harness exits non-zero: a CPU
number is never reported under a device metric.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

BASELINE_RAYS_PER_S = 5e8
FINAL_SCENE = dict(width=400, spp=100, max_depth=20)


def card_info() -> str:
    """Each card's name and power limit as nvidia-smi reports them, one
    line per card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def device_info() -> dict:
    """Device fields every result line carries; fails without a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {devs[0].platform}")
    return dict(platform=devs[0].platform, device_kind=devs[0].device_kind,
                device_count=len(devs), card=card_info().splitlines()[0])


def timed(fn, reps):
    """(median seconds, spread, last result) of ``reps`` calls of ``fn``
    after one warm-up call; ``fn`` must block on its result."""
    import numpy as np

    out = fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        ts.append(time.perf_counter() - t0)
    med = float(np.median(ts))
    return med, (max(ts) - min(ts)) / med, out


def bench_forward(width=400, spp=100, max_depth=20, seed=7, reps=3):
    """Forward rays/s through the default ``Renderer``."""
    from raytracing_tpu.models.scenes import build
    from raytracing_tpu.render.renderer import Renderer, auto_hit_method

    scene, cfg = build("bouncing_spheres", image_width=width,
                       samples_per_pixel=spp, max_depth=max_depth)
    r = Renderer(cfg)
    t0 = time.perf_counter()
    r.render(scene, seed=seed)  # compiles
    setup = time.perf_counter() - t0
    runs = [r.render(scene, seed=seed) for _ in range(reps)]
    secs = sorted(x.seconds for x in runs)
    med = secs[len(secs) // 2]
    return dict(hit_method=auto_hit_method(scene), segments=runs[0].segments,
                seconds=med, spread=(secs[-1] - secs[0]) / med,
                setup_seconds=setup, rays_per_s=runs[0].segments / med)


def bench_fwd_bwd(width=400, spp=100, max_depth=20, seed=7, spp_chunk=4,
                  reps=3):
    """Forward+backward rays/s: MSE loss of the image against a black
    target and its gradients w.r.t. sphere centers and texture albedos,
    through ``render_replay`` (decision pass with the ``auto`` hit
    function, then the differentiated replay), ``spp_chunk`` samples per
    chunk, all chunks in one jitted ``fori_loop``. Each segment counts
    once, though the decision pass and the replay both trace it."""
    import jax
    import jax.numpy as jnp

    from raytracing_tpu.diff.replay import render_replay
    from raytracing_tpu.models.scenes import build
    from raytracing_tpu.render.renderer import auto_hit_method, pick_hit_fn

    scene, cfg = build("bouncing_spheres", image_width=width,
                       samples_per_pixel=spp, max_depth=max_depth)
    if spp % spp_chunk:
        raise ValueError("spp must divide into whole chunks")
    n_chunks = spp // spp_chunk
    hit_fn = pick_hit_fn(scene, "auto")
    target = jnp.zeros((cfg.image_height, cfg.image_width, 3), jnp.float32)

    def chunk_loss(center, rgb, sample0):
        s = scene.replace(spheres=scene.spheres.replace(center=center),
                          textures=scene.textures.replace(rgb=rgb))
        img, segs = render_replay(s, cfg, seed=seed, hit_fn=hit_fn,
                                  sample_start=sample0, spp=spp_chunk,
                                  return_segments=True)
        return jnp.mean((img - target) ** 2) / n_chunks, segs

    grad_fn = jax.value_and_grad(chunk_loss, argnums=(0, 1), has_aux=True)

    def sweep(center, rgb):
        def body(c, carry):
            lo, gc, gr, segs = carry
            (loss, seg), (g1, g2) = grad_fn(center, rgb, c * spp_chunk)
            return lo + loss, gc + g1, gr + g2, segs + seg

        init = (jnp.zeros(()), jnp.zeros_like(center), jnp.zeros_like(rgb),
                jnp.zeros((), jnp.int32))
        return jax.lax.fori_loop(0, n_chunks, body, init)

    args = (scene.spheres.center, scene.textures.rgb)
    t0 = time.perf_counter()
    compiled = jax.jit(sweep).lower(*args).compile()
    setup = time.perf_counter() - t0
    med, spread, out = timed(
        lambda: jax.block_until_ready(compiled(*args)), reps)
    loss, gc, gr, segs = out
    if not (bool(jnp.isfinite(loss)) and bool(jnp.all(jnp.isfinite(gc)))
            and bool(jnp.all(jnp.isfinite(gr)))):
        raise RuntimeError("non-finite loss or gradients")
    segments = int(segs)
    return dict(hit_method=auto_hit_method(scene), segments=segments,
                seconds=med, spread=spread, setup_seconds=setup,
                rays_per_s=segments / med)


def bench_scaling(n_devices, width=400, spp=100, max_depth=20, seed=7,
                  reps=3):
    """dp weak-scaling: rays/s of the final scene on a dp mesh of
    ``n_devices`` GPUs vs one; efficiency = rate_N / (N · rate_1)."""
    import jax
    import jax.numpy as jnp

    from raytracing_tpu.models.scenes import build
    from raytracing_tpu.parallel.mesh import make_mesh
    from raytracing_tpu.parallel.shard import build_sharded_renderer
    from raytracing_tpu.render.camera import CameraParams

    devs = jax.devices()
    if len(devs) < n_devices:
        raise SystemExit(f"need {n_devices} GPUs, have {len(devs)}")
    scene, cfg = build("bouncing_spheres", image_width=width,
                       samples_per_pixel=spp, max_depth=max_depth)
    params = CameraParams.from_config(cfg)

    def rate(n):
        mesh = make_mesh((n,), ("dp",), devices=devs[:n])
        fn, scene_prep, n_pix_pad = build_sharded_renderer(
            scene, cfg, mesh, hit_method="auto")
        pix = jnp.arange(n_pix_pad, dtype=jnp.int32)
        med, _, (_, seg) = timed(lambda: jax.block_until_ready(
            fn(scene_prep, params, pix, jnp.uint32(seed))), reps)
        return int(seg) / med

    r1, rn = rate(1), rate(n_devices)
    return dict(devices=n_devices, rays_per_s_1dev=r1, rays_per_s_ndev=rn,
                efficiency=rn / (n_devices * r1))


def result_line(info: dict, fwd: dict, bwd: dict) -> dict:
    """The one JSON line ``main`` prints."""
    return {
        "metric": "rays_per_s_fwd_final_scene",
        "value": fwd["rays_per_s"],
        "unit": "rays/s",
        "vs_baseline": fwd["rays_per_s"] / BASELINE_RAYS_PER_S,
        **info,
        "fwd": fwd,
        "rays_per_s_fwd_bwd": bwd["rays_per_s"],
        "fwd_bwd": bwd,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=None,
                    help="run the dp scaling harness on N GPUs")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    from raytracing_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    info = device_info()
    if args.devices is not None:
        print(json.dumps(dict(metric="scaling_efficiency_dp", unit="ratio",
                              **info, **bench_scaling(args.devices,
                                                      reps=args.reps))))
        return
    fwd = bench_forward(**FINAL_SCENE, reps=args.reps)
    bwd = bench_fwd_bwd(**FINAL_SCENE, reps=args.reps)
    print(json.dumps(result_line(info, fwd, bwd)))


if __name__ == "__main__":
    sys.exit(main())
