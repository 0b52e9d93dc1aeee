"""Vector math on ``(..., 3)`` arrays — the replacement for the
reference's ``vec3`` class (reference: src/common/vec3.hpp:8-226).

Everything here is shape-polymorphic over leading batch dimensions and pure,
so it vectorizes and is differentiable. There is deliberately no
vec3 *class*: the hot path works on struct-of-arrays batches, and a
3-vector is just the trailing axis of an array.
"""
from __future__ import annotations

import jax.numpy as jnp

# Matches the reference's degenerate-scatter threshold (src/common/vec3.hpp:73)
NEAR_ZERO_EPS = 1e-8


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing axis (vec3.hpp:138-141)."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched cross product (vec3.hpp:144-149)."""
    return jnp.cross(a, b)


def length_squared(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(v * v, axis=-1)


def length(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(length_squared(v))


def normalize(v: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """Unit vector (vec3.hpp:152-155). ``eps`` guards 0-length inputs."""
    n2 = length_squared(v)[..., None]
    return v * jnp.where(n2 > 0, 1.0 / jnp.sqrt(n2 + eps), 0.0) if eps else v / jnp.sqrt(n2)


def near_zero(v: jnp.ndarray, eps: float = NEAR_ZERO_EPS) -> jnp.ndarray:
    """True where all components are tiny.

    NOTE: implements the *correct* ``|c| < eps`` on every component. The
    reference has a bug here (vec3.hpp:76 takes ``fabs`` of a bool for the
    y component) which we deliberately do not reproduce (SURVEY.md §2.8.1).
    """
    return jnp.all(jnp.abs(v) < eps, axis=-1)


def reflect(v: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection ``v - 2 (v·n) n`` (vec3.hpp:207-213)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv: jnp.ndarray, n: jnp.ndarray, etai_over_etat: jnp.ndarray) -> jnp.ndarray:
    """Snell refraction via perpendicular/parallel decomposition
    (vec3.hpp:216-226). ``uv`` must be unit length; ``etai_over_etat`` is the
    relative IOR and may be batched ``(...,)``.

    The sqrt argument is double-``where`` guarded: at the total-internal-
    reflection boundary it is 0, and sqrt's VJP there is ∞ — which would
    poison gradients of rays that *didn't* take this branch (0·∞ = NaN
    through the select in ops/scatter.py).
    """
    cos_theta = jnp.minimum(dot(-uv, n), 1.0)
    r_out_perp = etai_over_etat[..., None] * (uv + cos_theta[..., None] * n)
    k = jnp.abs(1.0 - length_squared(r_out_perp))
    k_pos = k > 0.0
    root = jnp.where(k_pos, jnp.sqrt(jnp.where(k_pos, k, 1.0)), 0.0)
    r_out_parallel = -root[..., None] * n
    return r_out_perp + r_out_parallel


def safe_sqrt(x: jnp.ndarray) -> jnp.ndarray:
    """sqrt clamped at 0 with a finite (zero) gradient at x <= 0 — for
    masked-lane math where sqrt(0)'s infinite VJP would create 0·∞ NaNs."""
    pos = x > 0.0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), 0.0)


def ray_at(origin: jnp.ndarray, direction: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """``P(t) = O + t·D`` (reference: src/common/ray.hpp:22-26)."""
    return origin + t[..., None] * direction


def set_face_normal(ray_dir: jnp.ndarray, outward_normal: jnp.ndarray):
    """Orient the normal against the ray (reference: src/hittable/hittable.hpp:29-35).

    Returns ``(normal, front_face)`` where ``front_face = d·n_out < 0``.
    """
    front_face = dot(ray_dir, outward_normal) < 0.0
    normal = jnp.where(front_face[..., None], outward_normal, -outward_normal)
    return normal, front_face
