"""Scaling-efficiency harness (BASELINE.md target: >= 85% rays/s
efficiency 1 card -> N cards).

Measures dp-sharded render throughput across mesh sizes on the devices JAX
finds and reports efficiency = rate_N / (N * rate_1) per size; it fails
when fewer devices are attached than the largest size asks for. Prints one
JSON line per mesh size plus a summary line. The efficiency verdict is
meaningful only on separate cards: virtual CPU devices share the host's
cores, so there it only exercises the collective structure.

Usage:
  python tools/scaling.py --sizes 1 2 4
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4 \
      python tools/scaling.py --sizes 1 2 4     # CPU rehearsal
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def run(sizes, width, spp, depth, seed, hit_method, reps):
    import jax
    import jax.numpy as jnp

    from raytracing_tpu.models.scenes import build
    from raytracing_tpu.parallel.mesh import make_mesh
    from raytracing_tpu.parallel.shard import build_sharded_renderer
    from raytracing_tpu.render.camera import CameraParams

    devs = jax.devices()
    scene, cfg = build("bouncing_spheres", image_width=width,
                       samples_per_pixel=spp, max_depth=depth)

    def rate(n):
        mesh = make_mesh((n,), ("dp",), devices=devs[:n])
        fn, scene_prep, n_pix_pad = build_sharded_renderer(
            scene, cfg, mesh, hit_method=hit_method, mode="scan")
        params = CameraParams.from_config(cfg)
        pix = jnp.arange(n_pix_pad, dtype=jnp.int32)
        jax.block_until_ready(
            fn(scene_prep, params, pix, jnp.uint32(seed)))  # compile
        best = None
        for _ in range(reps):
            t0 = time.perf_counter()
            part, seg = jax.block_until_ready(
                fn(scene_prep, params, pix, jnp.uint32(seed)))
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        return int(seg) / best

    results = []
    r1 = None
    if max(sizes) > len(devs):
        raise SystemExit(f"need {max(sizes)} devices, have {len(devs)}")
    for n in sizes:
        r = rate(n)
        if n == 1:
            r1 = r
        eff = round(r / (n * r1), 4) if r1 else None
        results.append(dict(devices=n, rays_per_s=round(r), efficiency=eff))
        print(json.dumps(results[-1]), flush=True)
    # the >=85% verdict only means something on separate cards (see the
    # module docstring)
    on_hw = jax.default_backend() != "cpu"
    summary = dict(metric="scaling_efficiency_dp",
                   backend=jax.default_backend(),
                   target=0.85, rows=results,
                   ok=(all(r["efficiency"] is None or r["efficiency"] >= 0.85
                           for r in results) if on_hw else None))
    print(json.dumps(summary), flush=True)
    return summary


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="*", default=[1, 2, 4])
    ap.add_argument("--width", type=int, default=200)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--hit", default="auto")
    args = ap.parse_args()
    run(args.sizes, args.width, args.spp, args.depth, args.seed, args.hit,
        args.reps)


if __name__ == "__main__":
    main()
