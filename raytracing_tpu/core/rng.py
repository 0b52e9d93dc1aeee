"""Counter-based, stateless RNG for the wavefront path tracer.

The reference uses libc ``std::rand()`` — unseeded, global-state, not
thread-safe (reference: src/common/rtweekend.hpp:23-39). A wavefront
renderer needs the opposite: every random draw must be a *pure function* of
(ray identity, bounce, stream, seed) so that

  * renders are reproducible bit-for-bit for a given seed,
  * sharding is invariant: a ray gets the same sample stream no matter which
    chip or batch slice it lands on,
  * checkpoint/resume mid-accumulation replays identical samples.

We use the PCG4D hash (Jarzynski & Olano, "Hash Functions for GPU Rendering",
JCGT 2020 — public domain construction, standard in GPU path tracers): 4
u32 words in, 4 decorrelated u32 words out, ~12 integer ops. This is
dramatically cheaper than threefry per draw and statistically more than
adequate for Monte Carlo rendering.

Stream layout: draws are indexed by
  (pixel_uid, sample_idx, bounce * N_STREAMS + stream, seed)
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Per-bounce random streams (who consumes which slot of the 4 outputs is up
# to the sampler functions below).
STREAM_RAYGEN = 0    # pixel jitter (x, y), defocus disk (z, w)
STREAM_TIME = 1      # motion-blur ray time
STREAM_SCATTER = 2   # scatter direction (x, y), Fresnel coin (z)
N_STREAMS = 4

# np (not jnp): a module-level jnp scalar would initialize the XLA backend
# at import time, which breaks jax.distributed.initialize in multi-host
# workers (it must run before any backend init). Same f32 dtype semantics.
_INV_2_24 = np.float32(1.0 / (1 << 24))


def pcg4d(a: jnp.ndarray, b: jnp.ndarray, c: jnp.ndarray, d: jnp.ndarray):
    """PCG4D hash: four u32 lanes in, four decorrelated u32 lanes out."""
    v0 = a.astype(jnp.uint32)
    v1 = b.astype(jnp.uint32)
    v2 = c.astype(jnp.uint32)
    v3 = d.astype(jnp.uint32)
    mul = jnp.uint32(1664525)
    add = jnp.uint32(1013904223)
    v0 = v0 * mul + add
    v1 = v1 * mul + add
    v2 = v2 * mul + add
    v3 = v3 * mul + add
    v0 = v0 + v1 * v3
    v1 = v1 + v2 * v0
    v2 = v2 + v0 * v1
    v3 = v3 + v1 * v2
    v0 = v0 ^ (v0 >> 16)
    v1 = v1 ^ (v1 >> 16)
    v2 = v2 ^ (v2 >> 16)
    v3 = v3 ^ (v3 >> 16)
    v0 = v0 + v1 * v3
    v1 = v1 + v2 * v0
    v2 = v2 + v0 * v1
    v3 = v3 + v1 * v2
    return v0, v1, v2, v3


def _to_unit_float(u: jnp.ndarray) -> jnp.ndarray:
    """u32 → f32 uniform in [0, 1) using the top 24 bits (exact in f32)."""
    return (u >> jnp.uint32(8)).astype(jnp.float32) * _INV_2_24


def uniform4(uid: jnp.ndarray, sample: jnp.ndarray, ctr: jnp.ndarray, seed) -> jnp.ndarray:
    """Four independent U[0,1) floats per element; shape ``uid.shape + (4,)``.

    ``uid``: per-ray unique id (e.g. pixel index). ``sample``: sample index.
    ``ctr``: bounce*N_STREAMS + stream. ``seed``: scalar render seed.
    """
    seed = jnp.asarray(seed, jnp.uint32)
    v0, v1, v2, v3 = pcg4d(uid, sample, ctr, jnp.broadcast_to(seed, jnp.shape(uid)))
    return jnp.stack(
        [_to_unit_float(v0), _to_unit_float(v1), _to_unit_float(v2), _to_unit_float(v3)],
        axis=-1,
    )


# ---------------------------------------------------------------------------
# Samplers. The reference uses rejection sampling (vec3.hpp:158-204) which
# cannot vectorize (data-dependent while loops); we use the standard
# analytic transforms which sample the *same distributions* (SURVEY.md §2.1).
# ---------------------------------------------------------------------------

def square_offset(u: jnp.ndarray) -> jnp.ndarray:
    """AA jitter in [-0.5, 0.5)^2 (reference camera.hpp:165-168).

    ``u``: (..., >=2) uniforms. Returns (..., 2).
    """
    return u[..., :2] - 0.5


def unit_disk(u: jnp.ndarray) -> jnp.ndarray:
    """Uniform point on the unit disk via sqrt(r)·(cos, sin)
    (analytic equivalent of vec3.hpp:158-169). Returns (..., 2).
    """
    r = jnp.sqrt(u[..., 0])
    theta = (2.0 * jnp.pi) * u[..., 1]
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)


def unit_vector(u: jnp.ndarray) -> jnp.ndarray:
    """Uniform direction on the unit sphere via z = 1-2u, φ = 2πv
    (analytic equivalent of vec3.hpp:172-184). Returns (..., 3).
    """
    z = 1.0 - 2.0 * u[..., 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = (2.0 * jnp.pi) * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)
