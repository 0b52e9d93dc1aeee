"""Command-line interface (SURVEY.md §5 config/flag system).

Replaces the reference's recompile-to-select-scene ``switch(7)`` + argv[1]
output path (src/main.cpp:348-397) with a proper flag surface:

    python -m raytracing_tpu.cli render --scene cornell_box \
        --out output/cornell.png --width 600 --spp 100 --depth 50
    python -m raytracing_tpu.cli scenes
    python -m raytracing_tpu.cli bench
"""
from __future__ import annotations

import argparse
import sys


def _add_render_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scene", default="cornell_box", help="registry scene name")
    p.add_argument("--out", default="output/image.ppm", help=".ppm or .png path")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--depth", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hit", default="auto",
                   choices=["auto", "brute", "bvh", "triton"])
    p.add_argument("--mode", default="while", choices=["while", "scan"])
    p.add_argument("--checkpoint", default=None, help="resume/checkpoint file (npz)")
    p.add_argument("--trace-dir", default=None, help="jax.profiler trace output dir")
    p.add_argument("--log", default=None, help="JSONL log path")
    p.add_argument("--devices", type=int, default=0,
                   help="shard over N devices (0 = single-device renderer)")


def cmd_render(args) -> int:
    from .models.scenes import build
    from .render.renderer import Renderer
    from .utils import checkpoint as ckpt
    from .utils.compile_cache import enable_compile_cache
    from .utils.image_io import write_image
    from .utils.logging import JsonlLogger, scene_stats
    from .utils.profiling import trace_to

    overrides = {}
    if args.width:
        overrides["image_width"] = args.width
    if args.spp:
        overrides["samples_per_pixel"] = args.spp
    if args.depth:
        overrides["max_depth"] = args.depth

    enable_compile_cache()
    log = JsonlLogger(args.log)
    scene, cfg = build(args.scene, **overrides)
    log.log("scene_compiled", scene=args.scene, **scene_stats(scene))

    with trace_to(args.trace_dir):
        if args.devices:
            from .parallel.mesh import make_mesh
            from .parallel.shard import render_sharded

            mesh = make_mesh((args.devices,), ("dp",))
            radiance, segments = render_sharded(
                scene, cfg, mesh, seed=args.seed, hit_method=args.hit)
            write_image(args.out, radiance)
            log.log("render_done", out=args.out, segments=segments, devices=args.devices)
        else:
            r = Renderer(cfg, hit_method=args.hit, mode=args.mode)
            resume = ckpt.load_render_state(args.checkpoint) if args.checkpoint else None
            cb = (lambda st: ckpt.save_render_state(args.checkpoint, st)) if args.checkpoint else None
            res = r.render(scene, seed=args.seed, progress=True,
                           resume_state=resume, checkpoint_cb=cb)
            write_image(args.out, res.radiance)
            log.log(
                "render_done", out=args.out, segments=res.segments,
                seconds=res.seconds,
                rays_per_s=res.segments / max(res.seconds, 1e-9),
            )
    print(f"wrote {args.out}")
    return 0


def cmd_scenes(_args) -> int:
    from .models.scenes import SCENES

    for name in sorted(SCENES):
        print(name)
    return 0


def cmd_bench(_args) -> int:
    import runpy
    import os

    runpy.run_path(os.path.join(os.path.dirname(os.path.dirname(__file__)), "bench.py"),
                   run_name="__main__")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="raytracing_tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("render", help="render a registry scene")
    _add_render_args(pr)
    pr.set_defaults(fn=cmd_render)
    ps = sub.add_parser("scenes", help="list registry scenes")
    ps.set_defaults(fn=cmd_scenes)
    pb = sub.add_parser("bench", help="run the benchmark harness")
    pb.set_defaults(fn=cmd_bench)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
