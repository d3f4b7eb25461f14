"""Texture evaluation: tagged parameter table, compute-all-and-select.

The reference dispatches `texturez::value(u, v, p)` virtually per hit
(`texture.h:8-10`).  Here every texture kind is evaluated for the whole hit
batch as dense vector math and the per-ray kind tag selects the result — with
only six kinds, compute-all-and-select avoids regrouping hits by kind and
keeps the expression fully differentiable w.r.t. the color/atlas params.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import Array
from jax import core as jax_core

from . import perlin as perlin_mod
from .types import (
    Scene,
    TEX_CHECKER,
    TEX_IMAGE,
    TEX_MARBLE,
    TEX_NOISE,
    TEX_SOLID,
    TEX_TURB,
)


def _present_kinds(kind_table) -> set:
    """Texture kinds that can occur, or all of them when `kind` is traced.

    When the scene is baked into the compiled program (`compile_renderer` /
    `compile_param_renderer`), the integer kind table is a concrete constant,
    so the unused texture families prune at trace time — a solid-color scene
    never evaluates 7-octave perlin or the image atlas (huge fwd+bwd saving).
    """
    if isinstance(kind_table, jax_core.Tracer):
        return {TEX_SOLID, TEX_CHECKER, TEX_NOISE, TEX_TURB, TEX_MARBLE,
                TEX_IMAGE}
    return {int(k) for k in np.unique(np.asarray(kind_table))}


def eval_texture(scene: Scene, tex_id: Array, u: Array, v: Array, p: Array) -> Array:
    """Evaluate texture color for each hit.

    tex_id: (N,) int32 indices into scene.textures; u, v: (N,); p: (N, 3).
    Returns (N, 3) linear rgb.
    """
    tx = scene.textures
    present = _present_kinds(tx.kind)
    kind = tx.kind[tex_id]          # (N,)
    c1 = tx.c1[tex_id]          # (N, 3)
    c2 = tx.c2[tex_id]          # (N, 3)
    scale = tx.scale[tex_id]    # (N,)

    # solid_color (reference texture.h:12-23)
    out = jnp.where((kind == TEX_SOLID)[..., None], c1, 0.0)

    if TEX_CHECKER in present:
        # checker_texture: sign of product of sines (reference
        # texture.h:26-46); the reference hardcodes frequency 10 — here it
        # is the scale param.
        sines = (
            jnp.sin(scale * p[..., 0])
            * jnp.sin(scale * p[..., 1])
            * jnp.sin(scale * p[..., 2])
        )
        checker = jnp.where((sines < 0.0)[..., None], c2, c1)
        out = jnp.where((kind == TEX_CHECKER)[..., None], checker, out)

    if present & {TEX_NOISE, TEX_TURB, TEX_MARBLE}:
        # perlin family — gather-free hash-gradient noise (scene/perlin.py)
        turb_val = perlin_mod.turb(scale[..., None] * p, depth=7)
        ones = jnp.ones_like(c1)
        if TEX_NOISE in present:
            noise_val = perlin_mod.noise(scale[..., None] * p)
            # noise_texture (texture.h:49-62): gray 0.5*(1+noise)
            noise_tex = 0.5 * (1.0 + noise_val)[..., None] * ones
            out = jnp.where((kind == TEX_NOISE)[..., None], noise_tex, out)
        if TEX_TURB in present:
            # turbulent_texture (texture.h:65-77)
            out = jnp.where((kind == TEX_TURB)[..., None],
                            turb_val[..., None] * ones, out)
        if TEX_MARBLE in present:
            # marble_texture (texture.h:80-91): sin(scale*z + 10*turb)
            marble = (0.5 * (1.0 + jnp.sin(scale * p[..., 2] + 10.0 * turb_val))
                      )[..., None] * ones
            out = jnp.where((kind == TEX_MARBLE)[..., None], marble, out)

    if TEX_IMAGE in present:
        image_id = tx.image_id[tex_id]  # (N,)
        image = _eval_image(scene, image_id, u, v)
        out = jnp.where((kind == TEX_IMAGE)[..., None], image, out)
    return out


def _eval_image(scene: Scene, image_id: Array, u: Array, v: Array) -> Array:
    """Nearest-neighbor atlas lookup (reference `image_texture::value`,
    `texture.h:144-163`): clamp uv to [0,1], flip v, index the flat array."""
    at = scene.atlas
    w = at.width[image_id]    # (N,)
    h = at.height[image_id]   # (N,)
    off = at.offset[image_id]  # (N,) pixel offset

    uu = jnp.clip(u, 0.0, 1.0)
    vv = 1.0 - jnp.clip(v, 0.0, 1.0)
    i = jnp.minimum((uu * w.astype(jnp.float32)).astype(jnp.int32), w - 1)
    j = jnp.minimum((vv * h.astype(jnp.float32)).astype(jnp.int32), h - 1)
    # Three flat 1-D gathers with plain autodiff: XLA transposes them into
    # scatter-adds into the atlas.
    base = (off + j * w + i) * 3
    rgb = jnp.stack(
        (at.data[base], at.data[base + 1], at.data[base + 2]), axis=-1
    )
    # reference returns cyan for missing data (texture.h:146-147); image_id < 0
    # marks a texture slot with no image bound.
    return jnp.where((image_id >= 0)[..., None], rgb, jnp.array([0.0, 1.0, 1.0]))
