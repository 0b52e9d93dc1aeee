"""raytracing_tpu — a differentiable wavefront path tracer in JAX.

A from-scratch JAX/XLA/Pallas framework with the full capability surface of
the reference C++ ray tracer (jooo0922/raytracing-practice: Ray Tracing in
One Weekend + first half of The Next Week), redesigned for accelerators: SoA
scenes, wavefront integration, flattened-BVH traversal, shard_map scaling
and end-to-end differentiability. It runs on NVIDIA GPUs (H100) and on the
CPU.
"""

__version__ = "0.1.0"

from .render.camera import CameraConfig, CameraParams
from .render.renderer import Renderer, RenderResult, render
from .scene.builder import SceneBuilder
from .scene.types import Scene
from .models.scenes import SCENES, build

__all__ = [
    "CameraConfig",
    "CameraParams",
    "Renderer",
    "RenderResult",
    "render",
    "SceneBuilder",
    "Scene",
    "SCENES",
    "build",
]
