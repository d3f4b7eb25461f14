"""Scene registry: every reference scene, rebuilt on this renderer.

One function per reference scene struct (`scenes.h:82-621`), each returning a
SceneDef(scene pytree, camera, aspect).  Camera parameters, material constants
and geometry are transcribed from the cited reference lines; the procedural
`big_scene1` uses numpy RNG with the reference's seed (1984) so its layout is
statistically identical (curand sequences cannot be replayed bit-exact and the
reference's own published images predate code changes — see SURVEY §4).

Reference quirks deliberately NOT replicated (SURVEY §4 list): the backpack
scene's mesh-overwritten-by-ground bug (quirk 8) and the sphere second-root
bug (quirk 1).
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, NamedTuple, Optional

import numpy as np

from ..core.camera import Camera
from ..scene.builder import BLACK, SKY, SceneBuilder
from ..scene.types import Scene

REFERENCE_ROOT = os.environ.get("RT_REFERENCE_ASSETS", "/root/reference")


class SceneDef(NamedTuple):
    scene: Scene
    camera: Camera
    aspect: float


_REGISTRY: dict[str, Callable[..., SceneDef]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def names() -> list[str]:
    return sorted(_REGISTRY)


def get(name: str, **kw) -> SceneDef:
    return _REGISTRY[name](**kw)


def _cam(lookfrom, lookat, vfov, aspect, aperture=0.0, focus=10.0) -> Camera:
    return Camera.make(lookfrom, lookat, (0, 1, 0), vfov, aspect, aperture,
                       focus, 0.0, 1.0)


@register("basic")
def basic_scene(**kw) -> SceneDef:
    """reference `create_basic_world` (`scenes.h:82-100`)."""
    b = SceneBuilder(background=SKY)
    b.sphere((0, 0, -1), 0.5, b.lambertian((0, 1, 0)))
    b.sphere((0, -100.5, -1), 100, b.lambertian((0, 0, 1)))
    return SceneDef(b.build(**kw), _cam((0, 0, -3), (0, 0, 0), 40, 16 / 9), 16 / 9)


@register("first")
def first_scene(**kw) -> SceneDef:
    """reference `create_first_world` (`scenes.h:106-137`), incl. the hollow
    glass sphere via negative radius."""
    b = SceneBuilder(background=SKY)
    ground = b.lambertian((0.8, 0.8, 0.0))
    center = b.lambertian((0.1, 0.2, 0.3))
    left = b.dielectric(2.5)
    right = b.metal((0.8, 0.6, 0.2), 0.2)
    front = b.dielectric(2.0)
    b.sphere((0.0, -100.5, -1.0), 100.0, ground)
    b.sphere((0.0, 0.0, -1.0), 0.5, center)
    b.sphere((-1.0, 0.0, -1.0), 0.5, left)
    b.sphere((1.0, 0.0, -1.0), 0.5, right)
    b.sphere((0.0, 1.0, -0.75), 0.25, front)
    b.sphere((0.0, 1.0, -0.75), -0.25, front)
    return SceneDef(b.build(**kw), _cam((-2, 2, -3), (0, 0, -1), 20, 16 / 9), 16 / 9)


@register("big_scene1")
def big_scene1(**kw) -> SceneDef:
    """RTOW cover scene, reference `create_big_world1` (`scenes.h:140-222`):
    checkered ground + 22x22 random spheres (80% moving lambertian, 15% metal,
    5% glass) + three hero spheres, thin-lens camera with aperture 0.1."""
    b = SceneBuilder(background=SKY)
    rng = np.random.default_rng(b.seed)
    checker = b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.sphere((0, -1000, 0), 1000, b.lambertian(checker))
    for a in range(-11, 11):
        for c in range(-11, 11):
            choose = rng.random()
            center = np.array([a + 0.9 * rng.random(), 0.2, c + 0.9 * rng.random()])
            if np.sum((center - np.array([4, 0.2, 0])) ** 2) <= 0.9 * 0.9:
                continue  # reference fills a dummy micro-sphere here (quirk 7)
            if choose < 0.8:
                albedo = rng.random(3) * rng.random(3)
                center2 = center + np.array([0, rng.uniform(0, 0.5), 0])
                b.moving_sphere(center, center2, 0.0, 1.0, 0.2, b.lambertian(albedo))
            elif choose < 0.95:
                albedo = rng.uniform(0.5, 1.0, 3)
                b.sphere(center, 0.2, b.metal(albedo, rng.uniform(0, 0.5)))
            else:
                b.sphere(center, 0.2, b.dielectric(1.5))
    b.sphere((0, 1, 0), 1.0, b.dielectric(1.5))
    b.sphere((-4, 1, 0), 1.0, b.lambertian((0.4, 0.2, 0.1)))
    b.sphere((4, 1, 0), 1.0, b.metal((0.7, 0.6, 0.5), 0.0))
    cam = _cam((13, 2, -3), (0, 0, 0), 20, 16 / 9, aperture=0.1)
    return SceneDef(b.build(**kw), cam, 16 / 9)


@register("two_spheres")
def two_spheres(**kw) -> SceneDef:
    """reference `create_two_spheres_world` (`scenes.h:225-243`)."""
    b = SceneBuilder(background=SKY)
    checker = b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    mat = b.lambertian(checker)
    b.sphere((0, -10, 0), 10, mat)
    b.sphere((0, 10, 0), 10, mat)
    cam = _cam((13, 2, 3), (0, 0, 0), 20, 16 / 9, aperture=0.1)
    return SceneDef(b.build(**kw), cam, 16 / 9)


@register("two_perlin_spheres")
def two_perlin_spheres(**kw) -> SceneDef:
    """reference `create_two_perlin_spheres_world` (`scenes.h:248-274`)."""
    b = SceneBuilder(background=SKY)
    b.sphere((0, -1000, 0), 1000, b.lambertian(b.marble(4.0)))
    b.sphere((0, 2, 0), 2, b.lambertian(b.turbulence(5.0)))
    cam = _cam((13, 2, 3), (0, 0, 0), 20, 16 / 9, aperture=0.1)
    return SceneDef(b.build(**kw), cam, 16 / 9)


@register("earth")
def earth(**kw) -> SceneDef:
    """reference `create_earth_world` (`scenes.h:278-320`): earthmap-textured
    sphere + emissive rect, black background."""
    b = SceneBuilder(background=BLACK)
    tex_path = os.path.join(REFERENCE_ROOT, "textures", "earthmap.jpg")
    earth_tex = b.image(tex_path) if os.path.exists(tex_path) else b.solid((0, 1, 1))
    b.sphere((0, 0, 0), 2, b.lambertian(earth_tex))
    b.rect("xy", -5, 5, -3, 3, 6, b.diffuse_light((4.0, 4.0, 4.0)))
    cam = _cam((13, 0, 3), (0, 0, 0), 20, 16 / 9, aperture=0.1)
    return SceneDef(b.build(**kw), cam, 16 / 9)


def _cornell_walls(b: SceneBuilder, light_rect) -> None:
    """Walls + light shared by the Cornell scenes (`scenes.h:323-345`)."""
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    light = b.diffuse_light((15.0, 15.0, 15.0))
    b.rect("yz", 0, 555, 0, 555, 555, green)   # left wall
    b.rect("yz", 0, 555, 0, 555, 0, red)       # right wall
    b.rect("xz", *light_rect, 554, light)      # roof light
    b.rect("xz", 0, 555, 0, 555, 0, white)     # floor
    b.rect("xz", 0, 555, 0, 555, 555, white)   # roof
    b.rect("xy", 0, 555, 0, 555, 555, white)   # back wall
    return white


@register("cornell_box")
def cornell_box(**kw) -> SceneDef:
    """reference `create_cornell_box_world` (`scenes.h:323-360`)."""
    b = SceneBuilder(background=BLACK)
    white = _cornell_walls(b, (213, 343, 227, 332))
    b.box((0, 0, 0), (165, 330, 165), white, rotate_y=15, translate=(265, 0, 295))
    b.box((0, 0, 0), (165, 165, 165), white, rotate_y=-18, translate=(130, 0, 65))
    cam = _cam((278, 278, -800), (278, 278, 0), 40, 1.0)
    return SceneDef(b.build(**kw), cam, 1.0)


@register("cornell_smoke")
def cornell_smoke(**kw) -> SceneDef:
    """reference `create_cornell_smoke_box_world` (`scenes.h:365-404`)."""
    b = SceneBuilder(background=BLACK)
    _cornell_walls(b, (113, 443, 127, 432))
    b.box_medium((0, 0, 0), (165, 330, 165), 0.01, (0, 0, 0),
                 rotate_y=15, translate=(265, 0, 295))
    b.box_medium((0, 0, 0), (165, 165, 165), 0.01, (1, 1, 1),
                 rotate_y=-18, translate=(130, 0, 65))
    cam = _cam((278, 278, -800), (278, 278, 0), 40, 1.0)
    return SceneDef(b.build(**kw), cam, 1.0)


@register("triangle")
def triangle_scene(**kw) -> SceneDef:
    """reference `create_triangle_world` (`scenes.h:409-428`)."""
    b = SceneBuilder(background=SKY)
    b.triangle((-0.5, 0, 0), (0, 1, 10), (0.0, 0, 0), b.lambertian((0, 1, 0)),
               uv0=(0, 0), uv1=(0, 1), uv2=(1, 0))
    b.sphere((0, -100.5, -1), 100, b.lambertian((0, 0, 1)))
    return SceneDef(b.build(**kw), _cam((0, 0, -3), (0, 0, 0), 40, 16 / 9), 16 / 9)


@register("triangles")
def triangles_scene(**kw) -> SceneDef:
    """reference `create_triangles_world` (`scenes.h:432-475`)."""
    b = SceneBuilder(background=SKY)
    uv = dict(uv0=(0, 0), uv1=(0, 1), uv2=(1, 0))
    b.triangle((-0.5, 0, 0), (0, 1, 10), (0.5, 0, 0), b.lambertian((0, 1, 0)), **uv)
    b.triangle((0.5, 0, 0), (0, 1, 10), (0.5, 1, 0), b.lambertian((1, 1, 0)), **uv)
    b.triangle((1.5, 0, 0), (0, 2, 10), (1.5, 1, 0), b.lambertian((1, 1, 1)), **uv)
    b.triangle((1.5, 0, 0), (1.5, 1, 10), (1.5, 0, 2), b.lambertian((1, 1, 1)), **uv)
    b.sphere((0, -100.5, -1), 100, b.lambertian((0, 0, 1)))
    return SceneDef(b.build(**kw), _cam((0, 0, -3), (0, 0, 0), 40, 16 / 9), 16 / 9)


def _add_obj(b: SceneBuilder, path: str, fallback: str, scale: float = 1.0,
             standin_res=(224, 224), standin_scale: float = 1.0) -> None:
    """Load an OBJ into the builder, one lambertian + image texture per submesh
    (the reference's one-diffuse-texture-per-mesh pipeline,
    `triangle_mesh.h:147-204`).  When the OBJ itself is unavailable (large
    blobs stripped from the reference mount), substitutes a procedural
    stand-in mesh textured with the asset's real diffuse map.

    standin_res (224, 224) gives 2*224*224 = 100,352 triangles — matching the
    ~100k-triangle scale of the real backpack/cup assets (BASELINE config 5),
    so the BVH depth (~17 levels) and traversal cost are exercised even with
    the OBJ blobs stripped from the reference mount."""
    from ..io.obj import load_obj

    if os.path.exists(path):
        model = load_obj(path)
        for sub in model.submeshes:
            if sub.diffuse_texture is not None:
                mat = b.lambertian(b.image(sub.diffuse_texture))
            else:
                mat = b.lambertian(sub.diffuse_color)
            b.mesh(sub.vertices, sub.faces, mat, uvs=sub.uvs,
                   normals=sub.normals, scale=scale)
    else:
        warnings.warn(f"{path} missing (stripped asset); using procedural stand-in")
        if os.path.exists(fallback):
            from ..io.images import load_image

            img = load_image(fallback)
            # cap the stand-in's texture at 1024 on a side: cup's 4096^2
            # diffuse map decodes to a ~201 MB f32 atlas, which busts the
            # remote-compile payload when baked as an XLA constant; the
            # stand-in geometry is synthetic anyway, so a 1k map keeps the
            # image-texture path exercised at 1/16 the constant weight
            step = max(1, (max(img.shape[:2]) + 1023) // 1024)
            tex = b.image(img[::step, ::step])
        else:
            tex = b.solid((0.8, 0.2, 0.2))
        v, f, uvs, n = _uv_sphere(*standin_res)
        # size the stand-in to the scene's camera framing (the real assets
        # were modeled at the scale the reference cameras expect) and rest
        # it on the y=0 ground plane instead of half-burying it
        v = v * standin_scale
        v[:, 1] += standin_scale
        b.mesh(v, f, b.lambertian(tex), uvs=uvs, normals=n, scale=scale)


def _uv_sphere(n_lat: int, n_lon: int, radius: float = 1.0):
    """Procedural UV-sphere mesh (stand-in for stripped OBJ assets)."""
    lat = np.linspace(0, np.pi, n_lat + 1)
    lon = np.linspace(0, 2 * np.pi, n_lon + 1)
    tt, pp = np.meshgrid(lat, lon, indexing="ij")
    x = radius * np.sin(tt) * np.cos(pp)
    y = radius * np.cos(tt)
    z = radius * np.sin(tt) * np.sin(pp)
    v = np.stack((x, y, z), -1).reshape(-1, 3)
    uvs = np.stack((pp / (2 * np.pi), 1.0 - tt / np.pi), -1).reshape(-1, 2)
    normals = v / radius
    idx = np.arange((n_lat + 1) * (n_lon + 1)).reshape(n_lat + 1, n_lon + 1)
    faces = []
    for i in range(n_lat):
        for j in range(n_lon):
            a, c = idx[i, j], idx[i + 1, j + 1]
            faces.append((a, idx[i + 1, j], c))
            faces.append((a, c, idx[i, j + 1]))
    return v.astype(np.float32), np.asarray(faces), uvs.astype(np.float32), normals.astype(np.float32)


@register("door")
def door_scene(**kw) -> SceneDef:
    """reference `door_scene` (`scenes.h:478-523`): door.obj mesh + ground."""
    b = SceneBuilder(background=SKY)
    _add_obj(b, os.path.join(REFERENCE_ROOT, "assets", "door", "door.obj"),
             os.path.join(REFERENCE_ROOT, "assets", "door", "Door_C.jpg"))
    b.sphere((0, -100, -1), 100, b.lambertian((0, 1, 0)))
    return SceneDef(b.build(**kw), _cam((-3, 4, -5), (0, 1, 0), 20, 16 / 9), 16 / 9)


@register("backpack")
def backpack_scene(**kw) -> SceneDef:
    """reference `backpack_scene` (`scenes.h:526-572`).  The reference build
    overwrites the mesh with the ground sphere (SURVEY quirk 8); this builds
    the intended mesh + ground."""
    b = SceneBuilder(background=SKY)
    _add_obj(b, os.path.join(REFERENCE_ROOT, "assets", "backpack", "backpack.obj"),
             os.path.join(REFERENCE_ROOT, "assets", "backpack", "diffuse.jpg"),
             standin_scale=0.45)
    b.sphere((0, -100, -1), 100, b.lambertian((0, 1, 0)))
    return SceneDef(b.build(**kw), _cam((0, 0, -3), (0, 0, 0), 20, 16 / 9), 16 / 9)


@register("cup")
def cup_scene(**kw) -> SceneDef:
    """reference `cup_scene` (`scenes.h:576-621`)."""
    b = SceneBuilder(background=SKY)
    _add_obj(b, os.path.join(REFERENCE_ROOT, "assets", "cup", "cup.obj"),
             os.path.join(REFERENCE_ROOT, "assets", "cup",
                          "MaryRoseTankard_100kMesh.jpg"),
             standin_scale=0.12)
    b.sphere((0, -100, -1), 100, b.lambertian((0, 1, 0)))
    return SceneDef(b.build(**kw), _cam((0, 0, -1), (0, 0, 0), 20, 16 / 9), 16 / 9)
