"""Closest-hit paths on the card: the Triton sweep kernel vs
``closest_hit_brute`` vs ``closest_hit_bvh``.

    python tools/hit_bench.py                 # compile + compare only
    python tools/hit_bench.py --time          # + per-call timings
    python tools/hit_bench.py --time --e2e    # + end-to-end Renderer timings

Ray batches: B = 2^18 (the Renderer's rays per launch) camera rays of the
scene at its bench size, and the same number of rays after one bounce.
Scenes: ``bouncing_spheres`` (final scene, 488 spheres) and ``cornell_box``
(quads at the 555-unit scale). The comparison is
``utils/hit_compare.hit_agreement``; the batches are its
``ray_batches``. Timings are bench.py's ``timed``:
medians of ``--reps`` calls ended by ``block_until_ready`` after a
warm-up call, spread = (max - min) / median. One JSON line per
measurement.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B = 1 << 18
SCENES = {
    "bouncing_spheres": dict(image_width=400, samples_per_pixel=100,
                             max_depth=20),
    "cornell_box": dict(image_width=400, samples_per_pixel=100, max_depth=20,
                        use_bvh=True),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--scenes", default=",".join(SCENES))
    args = ap.parse_args(argv)

    import jax

    from bench import card_info, timed
    from raytracing_tpu.models.scenes import build
    from raytracing_tpu.ops.hit_triton import closest_t_id
    from raytracing_tpu.ops.intersect import closest_hit_brute
    from raytracing_tpu.render.renderer import Renderer, pick_hit_fn
    from raytracing_tpu.utils.compile_cache import enable_compile_cache
    from raytracing_tpu.utils.hit_compare import hit_agreement, ray_batches

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"no GPU: JAX found {dev.platform}")
    base = dict(card=card_info().splitlines()[0], device_kind=dev.device_kind)

    def per_call(fn, *a):
        return timed(lambda: jax.block_until_ready(fn(*a)), args.reps)[:2]
    ok = True
    for name in args.scenes.split(","):
        scene, cfg = build(name, **SCENES[name])
        for bname, rays in ray_batches(scene, cfg, B).items():
            kern = jax.jit(closest_t_id)
            ref = jax.jit(closest_hit_brute)
            mem = kern.lower(scene, *rays).compile().memory_analysis()
            t_k, id_k = kern(scene, *rays)
            h = ref(scene, *rays)
            agree = hit_agreement(scene, *rays, t_k, id_k, h.t, h.prim_id)
            ok &= agree["ok"]
            print(json.dumps(dict(base, scene=name, batch=bname,
                                  phase="compare", **agree,
                                  kernel_memory=str(mem))), flush=True)
            if not args.time:
                continue
            for method in ("triton", "brute", "bvh"):
                fn = jax.jit(pick_hit_fn(scene, method))
                sec, spread = per_call(fn, scene, *rays)
                print(json.dumps(dict(base, scene=name, batch=bname,
                                      phase="hit_fn", method=method,
                                      seconds=sec, spread=spread)),
                      flush=True)
            sec, spread = per_call(kern, scene, *rays)
            print(json.dumps(dict(base, scene=name, batch=bname,
                                  phase="kernel_only", method="triton",
                                  seconds=sec, spread=spread)), flush=True)
        if not args.e2e:
            continue
        for method in ("triton", "brute", "bvh"):
            r = Renderer(cfg, hit_method=method)
            res = [r.render(scene, seed=7) for _ in range(3)][1:]
            secs = sorted(x.seconds for x in res)
            print(json.dumps(dict(
                base, scene=name, phase="renderer", method=method,
                width=cfg.image_width, height=cfg.image_height,
                spp=cfg.samples_per_pixel, depth=cfg.max_depth,
                segments=res[0].segments, seconds=secs,
                rays_per_s=res[0].segments / secs[0])), flush=True)
    print(json.dumps(dict(base, ok=bool(ok))))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
