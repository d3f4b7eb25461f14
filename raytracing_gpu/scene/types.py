"""Scene representation: structure-of-arrays pytrees.

The reference builds its scene as a graph of device-side `new`-ed polymorphic
objects with virtual `hit`/`scatter`/`value` dispatch (`scenes.h:82-100`,
`hittable.h:25-28`, `material.h:9-14`, `texture.h:8-10`).  Here instead the
whole scene is a pytree of packed arrays:

- one SoA table per primitive *type* (spheres, axis-aligned rects, boxes,
  triangles) with an integer material id per primitive,
- a material parameter table (kind tag + texture id + fuzz + ior),
- a texture parameter table (kind tag + colors + scale + image id) over a flat
  image atlas — the same flat-array indexing scheme as the reference's
  `image_texture` (`texture.h:125-142`), but in float32.
  (Perlin noise is table-free here — hash-gradient, see scene/perlin.py —
  so the reference's table set `perlin.h:63-76` has no pytree counterpart.)

so "virtual dispatch" becomes masked select / gather over tags, and the whole
scene is replicated per device while ray batches are sharded.

Moving spheres (`moving_sphere.h`) are folded into the sphere table as
(center0, center1, time0, time1) with static spheres having center0 == center1.
Instance transforms translate/rotate_y (`hittable.h:31-143`) are baked into
triangle vertices at build time and stored per-box as (cos, sin, offset) for
boxes (the only primitives the reference composes them onto that cannot be
baked).  Constant media (`constant_medium.h`) are flags + neg_inv_density on
their convex boundary primitive (sphere or box).

Every table is padded; `active` masks padding rows.  All float arrays are
float32.  The material/texture/atlas tables are the differentiable parameter
pytree: gradients of a rendered image flow into them.
"""

from __future__ import annotations

from typing import Any, Optional

from ..core import struct
from jax import Array

# Primitive type tags (order matters: used by closest-hit dispatch)
SPHERE, RECT, BOX, TRIANGLE = 0, 1, 2, 3

# Material kind tags (reference material.h classes)
LAMBERTIAN, METAL, DIELECTRIC, DIFFUSE_LIGHT, ISOTROPIC = 0, 1, 2, 3, 4

# Texture kind tags (reference texture.h classes)
TEX_SOLID, TEX_CHECKER, TEX_NOISE, TEX_TURB, TEX_MARBLE, TEX_IMAGE = 0, 1, 2, 3, 4, 5

# Rect orientation tags: the constant axis (reference yz_rect / xz_rect / xy_rect)
RECT_YZ, RECT_XZ, RECT_XY = 0, 1, 2


@struct.dataclass
class Spheres:
    """Sphere + moving-sphere table (reference `sphere.h`, `moving_sphere.h`).

    A negative radius gives the reference's hollow-sphere trick
    (`scenes.h:119-121`): the squared radius in the quadratic is unchanged but
    the outward normal `(p - center)/radius` flips.
    """

    center0: Array          # (S, 3) center at time0
    center1: Array          # (S, 3) center at time1 (== center0 when static)
    time0: Array            # (S,)
    time1: Array            # (S,)
    radius: Array           # (S,) signed
    mat_id: Array           # (S,) int32
    active: Array           # (S,) bool — False for padding rows
    medium: Array           # (S,) bool — constant-medium boundary
    neg_inv_density: Array  # (S,) -1/density for medium rows, 0 otherwise
    u_off: Array            # (S,) texture-u phase in turns — a rotate_y
    #                         instance (`hittable.h:64-143`) computes uv in
    #                         object space, so rotating a sphere by theta
    #                         shifts u by -theta/360; baked here instead of a
    #                         wrapper object


@struct.dataclass
class Rects:
    """Axis-aligned rectangles (reference `aarect.h`).

    `axis` is the constant coordinate: RECT_YZ -> x = k, RECT_XZ -> y = k,
    RECT_XY -> z = k.  (a0, a1) x (b0, b1) bound the two varying coordinates in
    ascending axis order: yz -> (y, z), xz -> (x, z), xy -> (x, y) — matching
    the reference's uv conventions (`aarect.h:63-150`).
    """

    axis: Array    # (R,) int32 in {0, 1, 2}
    a0: Array      # (R,)
    a1: Array      # (R,)
    b0: Array      # (R,)
    b1: Array      # (R,)
    k: Array       # (R,)
    mat_id: Array  # (R,) int32
    active: Array  # (R,) bool


@struct.dataclass
class Boxes:
    """Axis-aligned boxes with an optional rotate_y + translate instance
    transform (reference `box.h` + `hittable.h:31-143`).

    The reference decomposes a box into 6 rects inside a hittable_list
    (`box.h:14-27`); here a box is a single slab-test primitive — one fused
    interval test instead of 6 plane tests — with the transform applied to the
    ray (world -> object: p' = R(-theta) (p - offset)), exactly the math of
    `translate::hit`/`rotate_y::hit`.
    """

    bmin: Array             # (B, 3) object-space min corner
    bmax: Array             # (B, 3)
    cos_t: Array            # (B,) cos(theta) of rotate_y
    sin_t: Array            # (B,) sin(theta)
    offset: Array           # (B, 3) translate offset
    mat_id: Array           # (B,) int32
    active: Array           # (B,) bool
    medium: Array           # (B,) bool
    neg_inv_density: Array  # (B,)


@struct.dataclass
class Triangles:
    """Triangle table (reference `triangle.h`).

    Stored as v0 + two edges (e1 = v1 - v0, e2 = v2 - v0) ready for
    Moller-Trumbore.  Vertex normals/uvs are interpolated barycentrically at
    shading time (`triangle.h:101-116,165-174`).  Instance transforms are baked
    into the vertices at build time.
    """

    v0: Array      # (T, 3)
    e1: Array      # (T, 3) vertex1 - vertex0
    e2: Array      # (T, 3) vertex2 - vertex0
    n0: Array      # (T, 3) vertex normals (face normal replicated if absent)
    n1: Array      # (T, 3)
    n2: Array      # (T, 3)
    uv0: Array     # (T, 2)
    uv1: Array     # (T, 2)
    uv2: Array     # (T, 2)
    has_vn: Array  # (T,) bool — use vertex-normal interpolation
    mat_id: Array  # (T,) int32
    active: Array  # (T,) bool


@struct.dataclass
class Materials:
    """Material parameter table (reference `material.h:16-138`).

    kind: LAMBERTIAN / METAL / DIELECTRIC / DIFFUSE_LIGHT / ISOTROPIC.
    tex_id indexes Textures and is the albedo for lambertian/metal/isotropic
    and the emission for diffuse_light.
    """

    kind: Array    # (M,) int32
    tex_id: Array  # (M,) int32
    fuzz: Array    # (M,) metal fuzz
    ir: Array      # (M,) dielectric index of refraction


@struct.dataclass
class Textures:
    """Texture parameter table (reference `texture.h:12-164`).

    c1/c2: solid color & checker even/odd colors.  scale: checker frequency
    (reference hardcodes 10) and perlin scale.  image_id indexes the atlas.
    """

    kind: Array      # (K,) int32
    c1: Array        # (K, 3)
    c2: Array        # (K, 3)
    scale: Array     # (K,)
    image_id: Array  # (K,) int32


@struct.dataclass
class ImageAtlas:
    """Flat image-texture atlas (reference `texture.h:97-164`, `make_image`).

    All images concatenated into one float32 rgb array; per-image offset/width/
    height — the reference's start-index scheme (`texture.h:131-139`) with
    float pixels instead of bytes.
    """

    data: Array    # (total_pixels * 3,) float32 in [0, 1]
    offset: Array  # (I,) int32 start pixel index of image i
    width: Array   # (I,) int32
    height: Array  # (I,) int32


@struct.dataclass
class Scene:
    """The whole packed scene — a single pytree, replicated across devices."""

    spheres: Spheres
    rects: Rects
    boxes: Boxes
    triangles: Triangles
    materials: Materials
    textures: Textures
    atlas: ImageAtlas
    background: Array  # (3,) miss color (reference `scenes.h:69-78`)
    tri_bvh: Optional[Any] = None  # accel.bvh.FlatBVH over triangles
    sphere_bvh: Optional[Any] = None  # accel.bvh.FlatBVH over spheres
    # Static structure flags (not traced; selecting them specializes the
    # compiled program): whether any constant-medium boundaries exist, so
    # media-free scenes skip the per-bounce free-path sampling entirely.
    has_sphere_media: bool = struct.static_field(default=True)
    has_box_media: bool = struct.static_field(default=True)
