"""Material scatter/emit: tagged table, branchless batched evaluation.

The reference dispatches `material::scatter`/`emitted` virtually per ray
(`material.h:9-14`).  Here every material kind's scatter direction and
attenuation are computed for the whole batch and selected by the per-hit kind
tag (five cheap kinds, so compute-all-and-select stays one fused
expression).  Sampled directions are detached from the autodiff graph
(detached-sampling estimator); attenuation/emission stay differentiable so
image gradients flow into texture/material parameters.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from ..core import rng, vec
from .textures import eval_texture
from .types import (
    DIELECTRIC,
    DIFFUSE_LIGHT,
    ISOTROPIC,
    LAMBERTIAN,
    METAL,
    Scene,
)


class ScatterResult(NamedTuple):
    direction: Array    # (N, 3) new ray direction (not normalized, like reference)
    attenuation: Array  # (N, 3)
    emitted: Array      # (N, 3)
    ok: Array           # (N,) bool — False: absorbed / pure emitter


def scatter_direction(
    scene: Scene,
    key: Array,
    in_dir: Array,      # (N, 3)
    normal: Array,      # (N, 3) faced against the ray
    front_face: Array,  # (N,) bool
    mat_id: Array,      # (N,) int32
):
    """Sample the scattered direction + continuation mask (detached).

    The geometric half of `material::scatter` — direction sampling only, no
    texture evaluation, so the path-walk phase of the differentiable renderer
    runs with zero parameter tangents (detached-sampling estimator).
    """
    mats = scene.materials
    kind = mats.kind[mat_id]
    fuzz = mats.fuzz[mat_id]
    ir = mats.ir[mat_id]

    n = in_dir.shape[:-1]
    k_unit, k_sphere, k_iso, k_refl = jax.random.split(key, 4)
    unit_v = rng.unit_vector(k_unit, n)
    sphere_v = rng.in_unit_sphere(k_sphere, n)
    iso_v = rng.in_unit_sphere(k_iso, n)
    u_refl = rng.uniform(k_refl, n)

    # lambertian (material.h:16-36)
    lam_dir = normal + unit_v
    lam_dir = vec.where(vec.near_zero(lam_dir), normal, lam_dir)

    # metal (material.h:39-56)
    refl = vec.reflect(vec.unit(in_dir), normal)
    metal_dir = refl + fuzz[..., None] * sphere_v
    metal_ok = vec.dot(metal_dir, normal) > 0.0

    # dielectric (material.h:59-104)
    ratio = jnp.where(front_face, 1.0 / ir, ir)
    unit_dir = vec.unit(in_dir)
    cos_theta = jnp.minimum(vec.dot(-unit_dir, normal), 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
    cannot_refract = ratio * sin_theta > 1.0
    reflectance = _schlick(cos_theta, ratio)
    choose_reflect = cannot_refract | (reflectance > u_refl)
    diel_dir = vec.where(
        choose_reflect,
        vec.reflect(unit_dir, normal),
        vec.refract(unit_dir, normal, ratio),
    )

    is_metal = kind == METAL
    is_diel = kind == DIELECTRIC
    is_light = kind == DIFFUSE_LIGHT
    is_iso = kind == ISOTROPIC

    direction = vec.where(is_metal, metal_dir, lam_dir)
    direction = vec.where(is_diel, diel_dir, direction)
    direction = vec.where(is_iso, iso_v, direction)
    direction = jax.lax.stop_gradient(direction)

    ok = jnp.where(is_metal, metal_ok, True) & ~is_light
    return direction, ok


def _fast_shade(scene: Scene, mat_id: Array, p: Array):
    """Table-driven shading fast path, or None when not applicable.

    When the scene's integer structure (material kinds, texture bindings) is
    concrete — always true under `compile_renderer`/`compile_param_renderer`,
    which bake the scene — and every bound texture is solid or checker, the
    whole per-hit shade reduces to one lookup of a per-material feature
    table [c1, c2, scale, is_checker, is_diel, is_light].  The table is
    built from the differentiable texture params with static indices, so
    c1/c2 gradients flow through unchanged.
    """
    mats, tx = scene.materials, scene.textures
    if any(isinstance(a, jax.core.Tracer)
           for a in (mats.kind, mats.tex_id, tx.kind)):
        return None
    import numpy as np
    from .types import TEX_CHECKER, TEX_SOLID

    mkind = np.asarray(mats.kind)
    mtex = np.asarray(mats.tex_id)
    tkind = np.asarray(tx.kind)[mtex]
    if not np.all(np.isin(tkind, (TEX_SOLID, TEX_CHECKER))):
        return None

    if mkind.shape[0] <= 32:
        # Small material tables (Cornell: 4): unrolled per-material select
        # accumulation — M fused compare+multiply-adds over the hit stream
        # with nothing materialized, whose XLA-AD backward is M masked
        # reductions rather than a scatter-add into a few hot rows.  Every
        # per-material branch below is static (kind tables are concrete).
        scale_np = np.asarray(tx.scale)
        att = jnp.zeros(mat_id.shape + (3,), jnp.float32)
        emit = jnp.zeros(mat_id.shape + (3,), jnp.float32)
        for mi in range(mkind.shape[0]):
            mask = (mat_id == mi).astype(jnp.float32)[..., None]
            alb = tx.c1[mtex[mi]]          # (3,) traced param row
            if tkind[mi] == TEX_CHECKER:
                s = float(scale_np[mtex[mi]])
                sines = (jnp.sin(s * p[..., 0]) * jnp.sin(s * p[..., 1])
                         * jnp.sin(s * p[..., 2]))
                odd = (sines < 0.0).astype(jnp.float32)[..., None]
                alb = alb + odd * (tx.c2[mtex[mi]] - alb)
            if mkind[mi] == DIELECTRIC:
                att_m = alb + (1.0 - alb)  # == 1, kept in this form so the
                # c1 gradient stays exactly zero-sum like the gather path
            else:
                att_m = alb
            att = att + mask * att_m
            if mkind[mi] == DIFFUSE_LIGHT:
                emit = emit + mask * alb
        return att, emit

    c1m = tx.c1[mtex]                      # (M, 3) static-index gather
    c2m = tx.c2[mtex]
    sclm = tx.scale[mtex][:, None]
    flags = jnp.asarray(np.stack([
        (tkind == TEX_CHECKER), (mkind == DIELECTRIC),
        (mkind == DIFFUSE_LIGHT),
    ], axis=1).astype(np.float32))         # (M, 3)
    table = jnp.concatenate([c1m, c2m, sclm, flags], axis=1)  # (M, 10)

    feats = table[mat_id]                  # (N, 10) — the only per-hit lookup
    c1, c2, scale = feats[..., 0:3], feats[..., 3:6], feats[..., 6]
    is_chk, is_diel, is_light = feats[..., 7:8], feats[..., 8:9], feats[..., 9:10]

    # mask-multiply, not jnp.where: the flags are exactly 0/1, and f32
    # arithmetic keeps the AD residuals out of bit-packed pred tilings
    # (see integrator.shade_radiance).  The checker branch is gated on the
    # STATIC texture-kind table: checker-free scenes otherwise pay a
    # (D,N,1)-stacked sines residual per bounce (is_chk rides the traced
    # feature lookup, so XLA cannot fold it away on its own).
    if np.any(tkind == TEX_CHECKER):
        sines = (jnp.sin(scale * p[..., 0]) * jnp.sin(scale * p[..., 1])
                 * jnp.sin(scale * p[..., 2]))
        odd = is_chk * (sines < 0.0).astype(feats.dtype)[..., None]
        albedo = c1 + odd * (c2 - c1)
    else:
        albedo = c1
    attenuation = albedo + is_diel * (1.0 - albedo)
    emitted = is_light * albedo
    return attenuation, emitted


def shade(scene: Scene, mat_id: Array, u: Array, v: Array, p: Array):
    """Differentiable shading half: (attenuation, emitted) per hit.

    All texture/material parameter gradients flow through here — the texture
    table colors, the image atlas, and (via the emission texture) the emitter
    radiance (`material::scatter` attenuation + `material::emitted`).
    """
    fast = _fast_shade(scene, mat_id, p)
    if fast is not None:
        return fast
    mats = scene.materials
    kind = mats.kind[mat_id]
    tex_color = eval_texture(scene, mats.tex_id[mat_id], u, v, p)
    # f32 mask-multiplies keep the AD residuals of the enclosing scans in
    # efficiently-tiled f32 stacks (see integrator.shade_radiance)
    is_diel = (kind == DIELECTRIC).astype(tex_color.dtype)[..., None]
    is_light = (kind == DIFFUSE_LIGHT).astype(tex_color.dtype)[..., None]
    attenuation = tex_color + is_diel * (1.0 - tex_color)
    emitted = is_light * tex_color
    return attenuation, emitted


def scatter(
    scene: Scene,
    key: Array,
    in_dir: Array,   # (N, 3) incoming ray direction
    p: Array,        # (N, 3) hit point
    normal: Array,   # (N, 3) shading normal (already faced against the ray)
    front_face: Array,  # (N,) bool
    u: Array,
    v: Array,
    mat_id: Array,   # (N,) int32
) -> ScatterResult:
    """Full `material::scatter` + `emitted` (`material.h:16-138`): direction
    sampling (detached) composed with differentiable shading."""
    direction, ok = scatter_direction(scene, key, in_dir, normal, front_face, mat_id)
    attenuation, emitted = shade(scene, mat_id, u, v, p)
    return ScatterResult(direction, attenuation, emitted, ok)


def _schlick(cosine: Array, ref_idx: Array) -> Array:
    """Schlick reflectance approximation (reference `material.h:97-103`)."""
    sqrt_r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = sqrt_r0 * sqrt_r0
    return r0 + (1.0 - r0) * jnp.power(jnp.maximum(1.0 - cosine, 0.0), 5.0)
