"""``Renderer`` (the chunked XLA wavefront path) against ``render_once``
(one jitted launch, the differentiable reference) on every registry
scene: the same RNG streams give the same image up to f32 rounding, which
XLA fuses differently in the two programs — amplified by the 7-octave
turbulence on noise scenes, and flipping a rare grazing decision (the
outlier allowance)."""
import numpy as np
import pytest

from raytracing_tpu.diff.gradients import render_once
from raytracing_tpu.models.scenes import SCENES, build
from raytracing_tpu.render.renderer import Renderer


@pytest.mark.parametrize("name", sorted(SCENES))
def test_renderer_matches_render_once(name):
    scene, cfg = build(name, image_width=16, samples_per_pixel=3,
                       max_depth=3)
    want, segs = render_once(scene, cfg, seed=4, remat=False,
                             return_segments=True)
    # 2 samples per launch: two sample chunks, the second one ragged
    r = Renderer(cfg, hit_method="brute",
                 max_rays_per_launch=2 * cfg.n_pixels)
    got = r.render(scene, seed=4)
    assert got.launches == 2
    assert abs(got.segments - int(segs)) <= int(segs) // 200
    diff = np.abs(got.radiance - np.asarray(want)).max(axis=-1)
    assert diff.mean() < 2e-4, diff.mean()
    assert (diff > 1e-3).mean() < 0.02, (diff > 1e-3).mean()
