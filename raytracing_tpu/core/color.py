"""Color pipeline: linear radiance → gamma-corrected 8-bit
(reference: src/common/color.hpp:14-58).

On device this is a single vectorized pass over the whole image; the host only
sees the final u8 buffer.
"""
from __future__ import annotations

import jax.numpy as jnp


def linear_to_gamma(c: jnp.ndarray) -> jnp.ndarray:
    """γ=2.0 encode: sqrt of positive components, negatives → 0
    (color.hpp:14-23)."""
    return jnp.sqrt(jnp.maximum(c, 0.0))


def quantize_u8(c: jnp.ndarray) -> jnp.ndarray:
    """Gamma-encode, clamp to [0, 0.999], scale by 256 and truncate —
    identical semantics to the reference's write_color (color.hpp:26-58)."""
    g = linear_to_gamma(c)
    g = jnp.clip(g, 0.0, 0.999)
    return (256.0 * g).astype(jnp.uint8)


def to_u8_image(radiance: jnp.ndarray) -> jnp.ndarray:
    """(H, W, 3) mean radiance → (H, W, 3) u8 image."""
    return quantize_u8(radiance)
