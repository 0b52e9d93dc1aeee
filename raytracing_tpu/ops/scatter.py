"""Wavefront material shading: emission + scatter for a batch of hits.

Replaces virtual ``material::scatter``/``emitted`` dispatch
(reference: src/core/material.hpp:21-240) with compute-all-and-select over
the integer material tag. All four material responses are a handful of
elementwise ops each, so evaluating every branch and masking is cheaper than any
form of divergent dispatch.

The reference's three stochastic decisions become mask selects driven by the
per-ray counter RNG:
  * lambertian degenerate-direction fallback (material.hpp:57-60),
  * metal absorb-below-surface (material.hpp:105),
  * dielectric stochastic Fresnel (material.hpp:163-174).
"""
from __future__ import annotations

import jax.numpy as jnp
from ..core import pytree as struct

from ..core import rng as rng_mod
from ..core import vecmath as vm
from ..scene.textures import eval_texture
from ..scene.types import (
    MAT_DIELECTRIC,
    MAT_DIFFUSE_LIGHT,
    MAT_LAMBERTIAN,
    MAT_METAL,
    Scene,
)
from .intersect import HitBatch


@struct.dataclass
class ScatterBatch:
    direction: jnp.ndarray    # (B, 3) scattered ray direction
    attenuation: jnp.ndarray  # (B, 3) throughput multiplier
    emitted: jnp.ndarray      # (B, 3) emitted radiance at the hit
    did_scatter: jnp.ndarray  # (B,) bool — False = path absorbed


def schlick_reflectance(cosine: jnp.ndarray, ref_idx: jnp.ndarray) -> jnp.ndarray:
    """Schlick approximation r0 + (1-r0)(1-cosθ)^5 (material.hpp:198-206)."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def scatter_and_emit(
    scene: Scene,
    d_in: jnp.ndarray,       # (B, 3) incoming ray direction (unnormalized)
    hit: HitBatch,
    uniforms: jnp.ndarray,   # (B, 4) per-ray U[0,1) draws for this bounce
) -> ScatterBatch:
    mats = scene.materials
    mid = hit.mat_id
    mtype = mats.mtype[mid]
    n = hit.normal

    # Texture value: Lambertian albedo (material.hpp:66), metal albedo,
    # dielectric's white solid, or diffuse_light emission (material.hpp:233).
    tex_val = eval_texture(scene, mats.tex_id[mid], hit.u, hit.v, hit.p)

    ruv = rng_mod.unit_vector(uniforms[:, :2])  # shared unit-sphere sample

    # --- lambertian: n + random_unit_vector, degenerate → n (material.hpp:54-60)
    lam_dir = n + ruv
    lam_dir = jnp.where(vm.near_zero(lam_dir)[:, None], n, lam_dir)

    # --- metal: unit(reflect) + fuzz·ruv; absorb below surface (material.hpp:89-105)
    fuzz = mats.fuzz[mid]
    reflected = vm.normalize(vm.reflect(d_in, n)) + fuzz[:, None] * ruv
    metal_ok = vm.dot(reflected, n) > 0.0

    # --- dielectric: stochastic Fresnel reflect/refract (material.hpp:128-174)
    ior = mats.ior[mid]
    ri = jnp.where(hit.front_face, 1.0 / ior, ior)
    unit_d = vm.normalize(d_in)
    cos_theta = jnp.minimum(vm.dot(-unit_d, n), 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    cannot_refract = ri * sin_theta > 1.0
    reflect_coin = schlick_reflectance(cos_theta, ri) > uniforms[:, 2]
    use_reflect = cannot_refract | reflect_coin
    diel_dir = jnp.where(
        use_reflect[:, None],
        vm.reflect(unit_d, n),
        vm.refract(unit_d, n, ri),
    )

    # --- select by material tag
    is_metal = mtype == MAT_METAL
    is_diel = mtype == MAT_DIELECTRIC
    is_light = mtype == MAT_DIFFUSE_LIGHT

    direction = jnp.where(is_metal[:, None], reflected, lam_dir)
    direction = jnp.where(is_diel[:, None], diel_dir, direction)

    white = jnp.ones_like(tex_val)
    attenuation = jnp.where(is_diel[:, None], white, tex_val)  # material.hpp:131
    emitted = jnp.where(is_light[:, None], tex_val, jnp.zeros_like(tex_val))

    did_scatter = jnp.where(is_metal, metal_ok, jnp.ones_like(metal_ok))
    did_scatter = did_scatter & ~is_light  # lights never scatter (material.hpp:36)
    return ScatterBatch(
        direction=direction,
        attenuation=attenuation,
        emitted=emitted,
        did_scatter=did_scatter,
    )
