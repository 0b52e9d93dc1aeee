"""Struct-of-arrays scene schema — the device-side replacement for the
reference's pointer-based object graph (``hittable_list`` of ``shared_ptr``s,
reference: src/hittable/hittable_list.hpp:21-76).

A compiled :class:`Scene` is a pytree of device arrays:

* geometry as flat SoA tables (spheres, quads),
* materials/textures as integer-tagged parameter tables (replacing virtual
  dispatch, reference src/core/material.hpp:21-37 / texture.hpp:11-20),
* Perlin noise tables as constants (reference src/core/perlin.hpp:9-31),
* an optional flattened BVH with skip links (replacing the recursive pointer
  tree, reference src/accelerator/bvh_node.hpp:16-134).

All float leaves are differentiable: gradients flow to sphere centers/radii,
quad corners/edges, albedos, fuzz, IOR and emission.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
from ..core import pytree as struct

# Material type tags (reference classes: material.hpp:42/:80/:122/:223)
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_DIFFUSE_LIGHT = 3

# Texture type tags (reference classes: texture.hpp:25/:47/:91/:127)
TEX_SOLID = 0
TEX_CHECKER = 1
TEX_IMAGE = 2
TEX_NOISE = 3  # the active "marble" variant (texture.hpp:150)

# How many levels of checker-texture nesting we resolve (the reference
# supports arbitrary recursion; real scenes nest exactly one level —
# checker-of-solid, main.cpp:19).
CHECKER_NEST_DEPTH = 2


@struct.dataclass
class Spheres:
    """Static + moving spheres (reference src/hittable/sphere.hpp:7-119).

    ``center`` is the t=0 center; ``velocity`` the per-unit-time offset (the
    reference stores the center *as a ray* for the same purpose,
    sphere.hpp:115). Static spheres have zero velocity. Padded entries have
    ``radius == 0`` and never hit.
    """
    center: jnp.ndarray    # (N, 3) f32
    velocity: jnp.ndarray  # (N, 3) f32
    radius: jnp.ndarray    # (N,)  f32
    mat_id: jnp.ndarray    # (N,)  i32


@struct.dataclass
class Quads:
    """Parallelograms Q + s·u + t·v, s,t ∈ [0,1]
    (reference src/hittable/quad.hpp:8-126). The plane basis (normal, D, w)
    is derived inside the intersection kernel so that gradients flow to
    q/u/v. Padded entries have u = v = 0 and are rejected as parallel.
    """
    q: jnp.ndarray       # (M, 3) f32
    u: jnp.ndarray       # (M, 3) f32
    v: jnp.ndarray       # (M, 3) f32
    mat_id: jnp.ndarray  # (M,)  i32


@struct.dataclass
class Materials:
    """Integer-tagged material table (replaces virtual scatter/emitted
    dispatch, material.hpp:29-36)."""
    mtype: jnp.ndarray   # (K,) i32 — MAT_* tag
    tex_id: jnp.ndarray  # (K,) i32 — albedo (or emission) texture
    fuzz: jnp.ndarray    # (K,) f32 — metal fuzz radius (material.hpp:83)
    ior: jnp.ndarray     # (K,) f32 — dielectric refraction index (material.hpp:122)


@struct.dataclass
class Textures:
    """Integer-tagged texture table (replaces texture::value dispatch,
    texture.hpp:11-20). ``child`` holds (even, odd) sub-texture ids for
    checkers (texture.hpp:50-55); checker indirection is resolved by
    CHECKER_NEST_DEPTH rounds of id rewriting at eval time.
    """
    ttype: jnp.ndarray     # (T,) i32 — TEX_* tag
    rgb: jnp.ndarray       # (T, 3) f32 — solid color / noise tint
    scale: jnp.ndarray     # (T,) f32 — checker inv_scale (texture.hpp:36) or noise scale
    child: jnp.ndarray     # (T, 2) i32 — checker (even, odd) texture ids
    image_id: jnp.ndarray  # (T,) i32 — index into the image atlas


@struct.dataclass
class ImageAtlas:
    """Device-resident texel storage for image textures (replaces the stb
    wrapper, reference src/core/rtw_stb_image.hpp:28-178). Images are stacked
    padded to the max (H, W); ``sizes`` holds the true dims. Texels are f32
    in [0,1], pre-quantized through u8 to match the reference's
    float→byte→float round trip (rtw_stb_image.hpp:154-169,
    texture.hpp:116-117).
    """
    texels: jnp.ndarray  # (n_img, Hmax, Wmax, 3) f32
    sizes: jnp.ndarray   # (n_img, 2) i32 — (height, width)


@struct.dataclass
class PerlinTables:
    """256-entry gradient + permutation tables, generated host-side with a
    seeded PRNG (reference generates them with unseeded rand(),
    perlin.hpp:9-31 — we keep determinism instead)."""
    randvec: jnp.ndarray  # (256, 3) f32 — unit gradient vectors
    perm_x: jnp.ndarray   # (256,) i32
    perm_y: jnp.ndarray   # (256,) i32
    perm_z: jnp.ndarray   # (256,) i32


@struct.dataclass
class BVH:
    """Flattened binary BVH in depth-first preorder with skip links —
    the stackless-traversal form of the reference's recursive pointer tree
    (bvh_node.hpp:25-95).

    For node ``i``: if ``prim[i] >= 0`` it is a leaf over that primitive
    (global primitive index: spheres first, then quads). Otherwise its first
    child is ``i + 1`` (preorder) and ``miss[i]`` is the next node to visit
    when the subtree is skipped (-1 terminates traversal).
    """
    bbox_min: jnp.ndarray  # (K, 3) f32
    bbox_max: jnp.ndarray  # (K, 3) f32
    prim: jnp.ndarray      # (K,) i32 — leaf primitive id or -1
    miss: jnp.ndarray      # (K,) i32 — skip link or -1


class SceneFlags(NamedTuple):
    """Static (hashable) facts about a compiled scene that let jitted code
    skip texture/geometry branches nothing in the scene uses."""
    has_checker: bool = True
    has_image: bool = True
    has_noise: bool = True
    has_moving: bool = True  # any sphere with nonzero velocity (motion blur)
    # Bilinear image filtering: OFF matches the reference's nearest-neighbor
    # fetch (texture.hpp:111-113); ON makes image textures C0-continuous in
    # (u, v) so geometry gradients flow through them (diff/gradients.py).
    image_bilinear: bool = False


@struct.dataclass
class Scene:
    """A fully compiled scene: everything the integrator needs, as one
    pytree of device arrays (plus static ``flags``)."""
    spheres: Spheres
    quads: Quads
    materials: Materials
    textures: Textures
    atlas: ImageAtlas
    perlin: PerlinTables
    bvh: Optional[BVH] = None
    flags: SceneFlags = struct.field(pytree_node=False, default=SceneFlags())

    @property
    def n_spheres(self) -> int:
        return self.spheres.radius.shape[0]

    @property
    def n_quads(self) -> int:
        return self.quads.mat_id.shape[0]

    @property
    def n_primitives(self) -> int:
        return self.n_spheres + self.n_quads
