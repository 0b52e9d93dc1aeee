"""Utils subsystems: image IO round trips, checkpoint/resume (including a
simulated mid-render failure), logging, occupancy metrics, CLI."""
import os

import numpy as np
import jax.numpy as jnp
import pytest

from raytracing_tpu.models.scenes import build
from raytracing_tpu.render.renderer import Renderer
from raytracing_tpu.utils import checkpoint as ckpt
from raytracing_tpu.utils import image_io
from raytracing_tpu.utils.logging import JsonlLogger, scene_stats


def _decode_png(data: bytes) -> np.ndarray:
    """Decoder for the writer's own PNGs (8-bit RGB, filter type 0)."""
    import struct
    import zlib

    i, idat = 8, b""
    while i < len(data):
        (n,) = struct.unpack(">I", data[i:i + 4])
        tag, body = data[i + 4:i + 8], data[i + 8:i + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        i += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)


class TestImageIO:
    def test_ppm_round_trip(self, tmp_path):
        from raytracing_tpu.scene.assets import read_ppm

        rad = np.random.default_rng(0).random((7, 5, 3)).astype(np.float32)
        p = str(tmp_path / "img.ppm")
        image_io.write_ppm(p, rad)
        back = read_ppm(p)
        expect = np.asarray(image_io.to_u8_image(jnp.asarray(rad)))
        np.testing.assert_array_equal(back, expect)

    def test_ppm_header_matches_reference_format(self, tmp_path):
        rad = np.zeros((2, 3, 3), np.float32)
        p = str(tmp_path / "img.ppm")
        image_io.write_ppm(p, rad)
        with open(p) as f:
            head = f.read().split("\n")[:3]
        assert head == ["P3", "3 2", "255"]  # camera.hpp:36-37 header

    def test_png(self, tmp_path):
        rad = np.random.default_rng(0).random((4, 5, 3)).astype(np.float32)
        p = str(tmp_path / "img.png")
        image_io.write_png(p, rad)
        back = _decode_png(open(p, "rb").read())
        expect = np.asarray(image_io.to_u8_image(jnp.asarray(rad)))
        np.testing.assert_array_equal(back, expect)

    def test_png_chunks_and_crc(self):
        import struct
        import zlib

        data = image_io.png_bytes(np.zeros((2, 3, 3), np.uint8))
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        tags, i = [], 8
        while i < len(data):
            (n,) = struct.unpack(">I", data[i:i + 4])
            tag, body = data[i + 4:i + 8], data[i + 8:i + 8 + n]
            (crc,) = struct.unpack(">I", data[i + 8 + n:i + 12 + n])
            assert crc == zlib.crc32(tag + body)
            tags.append(tag)
            i += 12 + n
        assert tags == [b"IHDR", b"IDAT", b"IEND"]
        assert struct.unpack(">IIBBBBB", data[16:29]) == (3, 2, 8, 2, 0, 0, 0)


class TestNative:
    def test_native_bvh_matches_numpy(self):
        from raytracing_tpu.native import rt_native

        if not rt_native.available():
            pytest.skip("native toolchain unavailable")
        rng = np.random.default_rng(3)
        n = 127
        c = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
        r = rng.uniform(0.1, 2, n).astype(np.float32)
        bmin, bmax = c - r[:, None], c + r[:, None]
        ids = np.arange(n, dtype=np.int32)
        nat = rt_native.build_bvh_flat(bmin, bmax, ids)
        os.environ["RT_NATIVE"] = "0"
        try:
            # RT_NATIVE=0 must actually disable the native library (it is
            # honored per-call, not cached — see rt_native._load), otherwise
            # this test would compare the native builder to itself.
            assert not rt_native.available()
            from raytracing_tpu.ops.bvh import build_bvh

            fb = build_bvh(
                c, np.zeros_like(c), r,
                np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
                np.zeros((0, 3), np.float32), n,
            )
        finally:
            os.environ["RT_NATIVE"] = "1"
        np.testing.assert_array_equal(nat[2], fb.prim)
        np.testing.assert_array_equal(nat[3], fb.miss)
        np.testing.assert_allclose(nat[0], fb.bbox_min)
        np.testing.assert_allclose(nat[1], fb.bbox_max)

    def test_native_ppm(self, tmp_path):
        from raytracing_tpu.native import rt_native
        from raytracing_tpu.scene.assets import read_ppm

        if not rt_native.available():
            pytest.skip("native toolchain unavailable")
        img = np.random.default_rng(1).integers(0, 256, (5, 4, 3), dtype=np.uint8)
        p = str(tmp_path / "n.ppm")
        assert rt_native.write_ppm(p, img)
        np.testing.assert_array_equal(read_ppm(p), img)


class TestCheckpointResume:
    def test_render_resume_identical(self, tmp_path):
        scene, cfg = build("single_sphere", image_width=32, samples_per_pixel=8, max_depth=4)
        r = Renderer(cfg, max_rays_per_launch=32 * 16 * 2)  # forces 4 sample chunks
        full = r.render(scene, seed=3)

        # simulate a crash: checkpoint every chunk, keep only the 2nd
        states = []
        r2 = Renderer(cfg, max_rays_per_launch=32 * 16 * 2)
        r2.render(scene, seed=3, checkpoint_cb=states.append)
        assert len(states) >= 3
        mid = states[1]
        p = str(tmp_path / "ck.npz")
        ckpt.save_render_state(p, mid)
        loaded = ckpt.load_render_state(p)
        assert loaded["schunk"] == mid["schunk"]

        r3 = Renderer(cfg, max_rays_per_launch=32 * 16 * 2)
        resumed = r3.render(scene, seed=3, resume_state=loaded)
        np.testing.assert_allclose(resumed.radiance, full.radiance, atol=1e-6)

    def test_pytree_checkpoint(self, tmp_path):
        scene, _ = build("single_sphere")
        p = str(tmp_path / "scene.npz")
        ckpt.save_pytree(p, scene.spheres)
        back = ckpt.restore_pytree(p, scene.spheres)
        np.testing.assert_allclose(np.asarray(back.center), np.asarray(scene.spheres.center))


class TestObservability:
    def test_scene_stats_and_logger(self, tmp_path):
        scene, _ = build("quads")
        stats = scene_stats(scene)
        assert stats["n_quads"] >= 5 and stats["n_materials"] == 5
        logp = str(tmp_path / "log.jsonl")
        log = JsonlLogger(logp, echo=False)
        log.log("scene_compiled", **stats)
        log.close()
        import json

        with open(logp) as f:
            rec = json.loads(f.readline())
        assert rec["event"] == "scene_compiled" and rec["n_quads"] >= 5

    def test_occupancy_histogram(self):
        from raytracing_tpu.utils.profiling import occupancy_histogram

        scene, cfg = build("single_sphere", image_width=16, samples_per_pixel=1, max_depth=6)
        occ = np.asarray(occupancy_histogram(scene, cfg))
        assert occ[0] == 1.0
        assert np.all(np.diff(occ) <= 1e-6)  # monotone ray death


class TestCLI:
    def test_render_and_scenes(self, tmp_path, capsys):
        from raytracing_tpu.cli import main

        out = str(tmp_path / "out.ppm")
        rc = main(["render", "--scene", "single_sphere", "--out", out,
                   "--width", "32", "--spp", "2", "--depth", "3"])
        assert rc == 0 and os.path.exists(out)
        rc = main(["scenes"])
        assert rc == 0
        captured = capsys.readouterr()
        assert "cornell_box" in captured.out
