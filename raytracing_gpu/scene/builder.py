"""Host-side scene construction.

The reference constructs scenes with `<<<1,1>>>` device kernels that `new`
polymorphic objects (`scenes.h:82-100` and friends) because its object graph
must live in GPU memory.  Here everything is built on host
with numpy — textures, materials, primitive tables, Perlin tables, the image
atlas — and ships one packed pytree of device arrays.  The builder API mirrors
the reference's constructors one-to-one so every reference scene transcribes
directly (see `models/scenes.py`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import numpy as np
import jax
import jax.numpy as jnp

from .types import (
    BOX,
    DIELECTRIC,
    DIFFUSE_LIGHT,
    ISOTROPIC,
    LAMBERTIAN,
    METAL,
    RECT_XY,
    RECT_XZ,
    RECT_YZ,
    TEX_CHECKER,
    TEX_IMAGE,
    TEX_MARBLE,
    TEX_NOISE,
    TEX_SOLID,
    TEX_TURB,
    Boxes,
    ImageAtlas,
    Materials,
    Rects,
    Scene,
    Spheres,
    Textures,
    Triangles,
)

SKY = (0.7, 0.8, 1.0)      # reference `scenes.h:71`
BLACK = (0.0, 0.0, 0.0)    # reference `scenes.h:73`

ColorLike = Union[tuple, list, np.ndarray]
_PAD = 4  # pad primitive tables to a multiple of this


def _rot_y(p: np.ndarray, degrees: float) -> np.ndarray:
    """Rotate a point about the y axis (reference `hittable.h:107-121` world
    transform: x' = cos*x + sin*z, z' = -sin*x + cos*z)."""
    if degrees % 360.0 == 0.0:
        return np.asarray(p, np.float32)
    th = math.radians(degrees)
    c, s = math.cos(th), math.sin(th)
    x, y, z = (float(v) for v in np.asarray(p, np.float64))
    return np.asarray([c * x + s * z, y, -s * x + c * z], np.float32)


def _v3(x) -> np.ndarray:
    return np.asarray(x, np.float32).reshape(3)


@dataclass
class SceneBuilder:
    background: tuple = SKY
    seed: int = 1984  # reference world seed (`scenes.h:30`)

    # texture table rows
    _tex: list = field(default_factory=list)
    # material table rows
    _mat: list = field(default_factory=list)
    # primitive rows
    _spheres: list = field(default_factory=list)
    _rects: list = field(default_factory=list)
    _boxes: list = field(default_factory=list)
    _tris: list = field(default_factory=list)
    # columnar triangle blocks (dict of arrays) appended by mesh() — 100k-tri
    # meshes must not pay a python dict-append per face
    _tri_blocks: list = field(default_factory=list)
    # image atlas
    _images: list = field(default_factory=list)

    # -- textures (reference texture.h) ------------------------------------

    def solid(self, color: ColorLike) -> int:
        return self._add_tex(TEX_SOLID, c1=_v3(color))

    def checker(self, even: ColorLike, odd: ColorLike, scale: float = 10.0) -> int:
        # the reference hardcodes frequency 10 (`texture.h:40`)
        return self._add_tex(TEX_CHECKER, c1=_v3(even), c2=_v3(odd), scale=scale)

    def noise(self, scale: float = 1.0) -> int:
        return self._add_tex(TEX_NOISE, scale=scale)

    def turbulence(self, scale: float = 1.0) -> int:
        return self._add_tex(TEX_TURB, scale=scale)

    def marble(self, scale: float = 1.0) -> int:
        return self._add_tex(TEX_MARBLE, scale=scale)

    def image(self, img: Union[str, np.ndarray]) -> int:
        """Image texture from a path or an (H, W, 3) array in [0, 1]."""
        if isinstance(img, str):
            from ..io import images as _images

            img = _images.load_image(img)
        img = np.asarray(img, np.float32)
        if img.ndim != 3 or img.shape[2] < 3:
            raise ValueError(f"image texture must be (H, W, >=3), got {img.shape}")
        self._images.append(np.ascontiguousarray(img[..., :3]))
        return self._add_tex(TEX_IMAGE, image_id=len(self._images) - 1)

    def _add_tex(self, kind, c1=None, c2=None, scale=1.0, image_id=-1) -> int:
        self._tex.append(
            dict(
                kind=kind,
                c1=_v3(c1 if c1 is not None else (0, 0, 0)),
                c2=_v3(c2 if c2 is not None else (0, 0, 0)),
                scale=float(scale),
                image_id=int(image_id),
            )
        )
        return len(self._tex) - 1

    def _as_tex(self, t: Union[int, ColorLike]) -> int:
        """Accept either a texture id or a color (auto solid), mirroring the
        reference's color/texture constructor overloads."""
        if isinstance(t, (int, np.integer)):
            return int(t)
        return self.solid(t)

    # -- materials (reference material.h) ----------------------------------

    def lambertian(self, albedo: Union[int, ColorLike]) -> int:
        return self._add_mat(LAMBERTIAN, tex_id=self._as_tex(albedo))

    def metal(self, albedo: Union[int, ColorLike], fuzz: float = 0.0) -> int:
        return self._add_mat(METAL, tex_id=self._as_tex(albedo), fuzz=fuzz)

    def dielectric(self, ir: float) -> int:
        return self._add_mat(DIELECTRIC, ir=ir)

    def diffuse_light(self, emit: Union[int, ColorLike]) -> int:
        return self._add_mat(DIFFUSE_LIGHT, tex_id=self._as_tex(emit))

    def isotropic(self, albedo: Union[int, ColorLike]) -> int:
        return self._add_mat(ISOTROPIC, tex_id=self._as_tex(albedo))

    def _add_mat(self, kind, tex_id=0, fuzz=0.0, ir=1.0) -> int:
        self._mat.append(dict(kind=kind, tex_id=tex_id, fuzz=float(fuzz), ir=float(ir)))
        return len(self._mat) - 1

    # -- primitives --------------------------------------------------------

    def sphere(self, center, radius: float, mat: int,
               rotate_y: float = 0.0, translate=(0.0, 0.0, 0.0)) -> None:
        """reference `sphere.h`; negative radius = hollow-sphere trick.

        rotate_y/translate are the general instance wrappers
        (`hittable.h:31-143`) baked at build time: the center is rotated
        about y then offset, and the spherical-uv phase shift the reference
        gets from object-space uv is stored as a per-sphere u offset.
        """
        c = _rot_y(_v3(center), rotate_y) + _v3(translate)
        self._spheres.append(
            dict(c0=c, c1=c, t0=0.0, t1=1.0, r=float(radius), mat=mat,
                 medium=False, nid=0.0, u_off=-rotate_y / 360.0)
        )

    def moving_sphere(self, center0, center1, time0, time1, radius, mat: int,
                      rotate_y: float = 0.0, translate=(0.0, 0.0, 0.0)) -> None:
        """reference `moving_sphere.h` (+ baked instance transform)."""
        off = _v3(translate)
        self._spheres.append(
            dict(c0=_rot_y(_v3(center0), rotate_y) + off,
                 c1=_rot_y(_v3(center1), rotate_y) + off,
                 t0=float(time0), t1=float(time1),
                 r=float(radius), mat=mat, medium=False, nid=0.0,
                 u_off=-rotate_y / 360.0)
        )

    def rect(self, orientation: str, a0, a1, b0, b1, k, mat: int,
             rotate_y: float = 0.0, translate=(0.0, 0.0, 0.0)) -> None:
        """reference `aarect.h`: orientation in {"xy", "xz", "yz"}.

        Argument order matches the reference ctors, e.g. xy_rect(x0,x1,y0,y1,k).
        rotate_y/translate bake the instance wrappers (`hittable.h:31-143`):
        a pure translation keeps the rect axis-aligned (offset bounds);
        a rotation lowers it to two exact triangles carrying the rect's uv
        parameterization and rotated normal.
        """
        axis = {"yz": RECT_YZ, "xz": RECT_XZ, "xy": RECT_XY}[orientation]
        tx, ty, tz = (float(x) for x in np.asarray(translate, np.float64))
        if rotate_y % 360.0 == 0.0:
            da, db, dk = {RECT_YZ: (ty, tz, tx), RECT_XZ: (tx, tz, ty),
                          RECT_XY: (tx, ty, tz)}[axis]
            self._rects.append(
                dict(axis=axis, a0=float(a0) + da, a1=float(a1) + da,
                     b0=float(b0) + db, b1=float(b1) + db, k=float(k) + dk,
                     mat=mat)
            )
            return
        # rotated rect -> 2 triangles (no longer axis-aligned); uv corners
        # follow the reference order u=(a-a0)/(a1-a0), v=(b-b0)/(b1-b0)
        def pt(a, b):
            p = {RECT_YZ: (k, a, b), RECT_XZ: (a, k, b),
                 RECT_XY: (a, b, k)}[axis]
            return _rot_y(_v3(p), rotate_y) + _v3(translate)

        p00, p10 = pt(a0, b0), pt(a1, b0)
        p11, p01 = pt(a1, b1), pt(a0, b1)
        n = _rot_y(np.eye(3, dtype=np.float32)[axis], rotate_y)
        self.triangle(p00, p11, p10, mat, uv0=(0, 0), uv1=(1, 1), uv2=(1, 0),
                      normals=(n, n, n))
        self.triangle(p00, p01, p11, mat, uv0=(0, 0), uv1=(0, 1), uv2=(1, 1),
                      normals=(n, n, n))

    def box(self, p0, p1, mat: int, rotate_y: float = 0.0,
            translate=(0.0, 0.0, 0.0)) -> None:
        """reference `box.h` composed with rotate_y/translate instance wrappers
        (`hittable.h:31-143`, used by the Cornell scenes)."""
        self._add_box(p0, p1, mat, rotate_y, translate, medium=False, density=0.0)

    def box_medium(self, p0, p1, density: float, albedo: Union[int, ColorLike],
                   rotate_y: float = 0.0, translate=(0.0, 0.0, 0.0)) -> None:
        """reference `constant_medium` with a box boundary (`scenes.h:383-394`)."""
        mat = self.isotropic(albedo)
        self._add_box(p0, p1, mat, rotate_y, translate, medium=True, density=density)

    def sphere_medium(self, center, radius: float, density: float,
                      albedo: Union[int, ColorLike],
                      rotate_y: float = 0.0, translate=(0.0, 0.0, 0.0)) -> None:
        """reference `constant_medium` with a sphere boundary."""
        mat = self.isotropic(albedo)
        c = _rot_y(_v3(center), rotate_y) + _v3(translate)
        self._spheres.append(
            dict(c0=c, c1=c, t0=0.0, t1=1.0, r=float(radius),
                 mat=mat, medium=True, nid=-1.0 / float(density), u_off=0.0)
        )

    def _add_box(self, p0, p1, mat, rotate_y, translate, medium, density):
        theta = math.radians(rotate_y)
        self._boxes.append(
            dict(bmin=np.minimum(_v3(p0), _v3(p1)), bmax=np.maximum(_v3(p0), _v3(p1)),
                 cos=math.cos(theta), sin=math.sin(theta), off=_v3(translate),
                 mat=mat, medium=medium,
                 nid=(-1.0 / float(density)) if medium else 0.0)
        )

    def triangle(self, v0, v1, v2, mat: int, uv0=(0, 0), uv1=(0, 0), uv2=(0, 0),
                 normals: Optional[Sequence] = None) -> None:
        """reference `triangle.h` ctors (with or without vertex normals)."""
        v0, v1, v2 = _v3(v0), _v3(v1), _v3(v2)
        if normals is None:
            n = np.cross(v2 - v0, v1 - v0)  # reference face normal order
            n0 = n1 = n2 = n
            has_vn = False
        else:
            n0, n1, n2 = (_v3(x) for x in normals)
            has_vn = True
        self._tris.append(
            dict(v0=v0, e1=v1 - v0, e2=v2 - v0, n0=n0, n1=n1, n2=n2,
                 uv0=np.asarray(uv0, np.float32), uv1=np.asarray(uv1, np.float32),
                 uv2=np.asarray(uv2, np.float32), has_vn=has_vn, mat=mat)
        )

    def mesh(self, vertices: np.ndarray, faces: np.ndarray, mat: int,
             uvs: Optional[np.ndarray] = None,
             normals: Optional[np.ndarray] = None,
             rotate_y: float = 0.0, translate=(0.0, 0.0, 0.0),
             scale: float = 1.0) -> None:
        """Triangle mesh; the instance transform is baked into the vertices
        (replacing the reference's wrapper objects — host-side data prep
        mirroring `create_meshes_d`, `triangle_mesh.h:147-204`)."""
        vertices = np.asarray(vertices, np.float32) * scale
        faces = np.asarray(faces, np.int64)
        if rotate_y:
            th = math.radians(rotate_y)
            c, s = math.cos(th), math.sin(th)
            x, y, z = vertices[:, 0].copy(), vertices[:, 1], vertices[:, 2].copy()
            vertices = np.stack((c * x + s * z, y, -s * x + c * z), axis=-1)
        vertices = vertices + _v3(translate)
        if normals is not None:
            normals = np.asarray(normals, np.float32)
            if rotate_y:
                th = math.radians(rotate_y)
                c, s = math.cos(th), math.sin(th)
                nx, ny, nz = normals[:, 0].copy(), normals[:, 1], normals[:, 2].copy()
                normals = np.stack((c * nx + s * nz, ny, -s * nx + c * nz), axis=-1)
        # columnar block — one fancy-index per column instead of a python
        # dict-append per face (100k-tri meshes build in milliseconds)
        i, j, k = faces[:, 0], faces[:, 1], faces[:, 2]
        v0 = vertices[i]
        e1 = vertices[j] - v0
        e2 = vertices[k] - v0
        if normals is None:
            n = np.cross(e2, e1).astype(np.float32)  # reference face normal order
            n0 = n1 = n2 = n
            has_vn = np.zeros(len(faces), bool)
        else:
            n0, n1, n2 = normals[i], normals[j], normals[k]
            has_vn = np.ones(len(faces), bool)
        z2 = np.zeros((len(faces), 2), np.float32)
        self._tri_blocks.append(dict(
            v0=v0, e1=e1, e2=e2, n0=n0, n1=n1, n2=n2,
            uv0=uvs[i].astype(np.float32) if uvs is not None else z2,
            uv1=uvs[j].astype(np.float32) if uvs is not None else z2,
            uv2=uvs[k].astype(np.float32) if uvs is not None else z2,
            has_vn=has_vn,
            mat=np.full(len(faces), mat, np.int32),
        ))

    def _tri_columns(self) -> dict:
        """All triangles (per-triangle rows + mesh blocks) as one columnar
        dict of arrays, in insertion order: rows first, then blocks."""
        cols = ("v0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
                "has_vn", "mat")
        blocks = []
        if self._tris:
            rows = self._tris
            blocks.append(dict(
                v0=np.stack([t["v0"] for t in rows]),
                e1=np.stack([t["e1"] for t in rows]),
                e2=np.stack([t["e2"] for t in rows]),
                n0=np.stack([t["n0"] for t in rows]),
                n1=np.stack([t["n1"] for t in rows]),
                n2=np.stack([t["n2"] for t in rows]),
                uv0=np.stack([t["uv0"] for t in rows]),
                uv1=np.stack([t["uv1"] for t in rows]),
                uv2=np.stack([t["uv2"] for t in rows]),
                has_vn=np.asarray([t["has_vn"] for t in rows], bool),
                mat=np.asarray([t["mat"] for t in rows], np.int32),
            ))
        blocks.extend(self._tri_blocks)
        if not blocks:
            return {c: None for c in cols}
        out = {c: np.concatenate([b[c] for b in blocks]) for c in cols}
        for c in cols:
            if c not in ("has_vn", "mat"):
                out[c] = out[c].astype(np.float32)
        return out

    @property
    def n_tris(self) -> int:
        return len(self._tris) + sum(len(b["mat"]) for b in self._tri_blocks)

    # -- packing -----------------------------------------------------------

    def build(self, bvh: str = "auto", bvh_threshold: int = 64,
              leaf_size: int = 4) -> Scene:
        """Pack everything into the Scene pytree.

        bvh: "auto" builds a triangle BVH when the triangle count exceeds
        bvh_threshold (and a sphere BVH likewise); "always"/"never" force it.
        """
        if not self._mat:
            self.lambertian((0.5, 0.5, 0.5))
        if not self._tex:
            self.solid((0.5, 0.5, 0.5))


        tri_cols = self._tri_columns()
        spheres = self._pack_spheres()
        rects = self._pack_rects()
        boxes = self._pack_boxes()
        tris = self._pack_tris(tri_cols)
        materials = Materials(
            kind=np.asarray([m["kind"] for m in self._mat], jnp.int32),
            tex_id=np.asarray([m["tex_id"] for m in self._mat], jnp.int32),
            fuzz=np.asarray([m["fuzz"] for m in self._mat], jnp.float32),
            ir=np.asarray([m["ir"] for m in self._mat], jnp.float32),
        )
        textures = Textures(
            kind=np.asarray([t["kind"] for t in self._tex], jnp.int32),
            c1=np.asarray(np.stack([t["c1"] for t in self._tex]), jnp.float32),
            c2=np.asarray(np.stack([t["c2"] for t in self._tex]), jnp.float32),
            scale=np.asarray([t["scale"] for t in self._tex], jnp.float32),
            image_id=np.asarray([t["image_id"] for t in self._tex], jnp.int32),
        )
        atlas = self._pack_atlas()

        scene = Scene(
            spheres=spheres, rects=rects, boxes=boxes, triangles=tris,
            materials=materials, textures=textures, atlas=atlas,
            background=np.asarray(self.background, jnp.float32),
            tri_bvh=None, sphere_bvh=None,
            has_sphere_media=any(s["medium"] for s in self._spheres),
            has_box_media=any(b["medium"] for b in self._boxes),
        )

        n_tris = self.n_tris
        n_sph = len(self._spheres)
        want_tri_bvh = n_tris > 0 and (
            bvh == "always" or (bvh == "auto" and n_tris > bvh_threshold)
        )
        # sphere BVH at the same threshold as triangles: big_scene1 (~484
        # spheres) must not dense-scan in the XLA engine (the kernel already
        # BVHs at 64; measured on the CPU oracle the walk beats the dense
        # O(N*S) scan well below this count)
        want_sph_bvh = n_sph > 1 and (
            bvh == "always" or (bvh == "auto" and n_sph > bvh_threshold)
        )
        if want_tri_bvh or want_sph_bvh:
            from ..accel import bvh as bvh_mod

            if want_tri_bvh:
                scene = scene.replace(
                    tri_bvh=bvh_mod.build_triangle_bvh(tri_cols, leaf_size))
            if want_sph_bvh:
                sph_bvh, _ = bvh_mod.build_sphere_bvh(self._spheres, leaf_size)
                scene = scene.replace(sphere_bvh=sph_bvh)

        # One bulk host->device upload; the numpy-leaf snapshot rides along on
        # the device scene so host consumers (utils.checkpoint.fingerprint)
        # read it without a device->host transfer per leaf.
        # (.replace() drops the attribute; consumers fall back to device_get.)
        host = scene
        scene = jax.tree.map(jnp.asarray, host)
        object.__setattr__(scene, "_host_np", host)
        return scene

    def _pack_spheres(self) -> Spheres:
        rows = self._spheres
        n = _padded(len(rows))
        c0 = np.zeros((n, 3), np.float32)
        c1 = np.zeros((n, 3), np.float32)
        t0 = np.zeros(n, np.float32)
        t1 = np.ones(n, np.float32)
        r = np.full(n, 1.0, np.float32)
        mat = np.zeros(n, np.int32)
        act = np.zeros(n, bool)
        med = np.zeros(n, bool)
        nid = np.zeros(n, np.float32)
        uo = np.zeros(n, np.float32)
        for i, s in enumerate(rows):
            c0[i], c1[i], t0[i], t1[i] = s["c0"], s["c1"], s["t0"], s["t1"]
            r[i], mat[i], act[i] = s["r"], s["mat"], True
            med[i], nid[i] = s["medium"], s["nid"]
            uo[i] = s.get("u_off", 0.0)
        return Spheres(
            center0=np.asarray(c0), center1=np.asarray(c1),
            time0=np.asarray(t0), time1=np.asarray(t1), radius=np.asarray(r),
            mat_id=np.asarray(mat), active=np.asarray(act),
            medium=np.asarray(med), neg_inv_density=np.asarray(nid),
            u_off=np.asarray(uo),
        )

    def _pack_rects(self) -> Rects:
        rows = self._rects
        n = _padded(len(rows))
        axis = np.zeros(n, np.int32)
        a0 = np.zeros(n, np.float32)
        a1 = np.ones(n, np.float32)
        b0 = np.zeros(n, np.float32)
        b1 = np.ones(n, np.float32)
        k = np.zeros(n, np.float32)
        mat = np.zeros(n, np.int32)
        act = np.zeros(n, bool)
        for i, rc in enumerate(rows):
            axis[i], a0[i], a1[i] = rc["axis"], rc["a0"], rc["a1"]
            b0[i], b1[i], k[i] = rc["b0"], rc["b1"], rc["k"]
            mat[i], act[i] = rc["mat"], True
        return Rects(
            axis=np.asarray(axis), a0=np.asarray(a0), a1=np.asarray(a1),
            b0=np.asarray(b0), b1=np.asarray(b1), k=np.asarray(k),
            mat_id=np.asarray(mat), active=np.asarray(act),
        )

    def _pack_boxes(self) -> Boxes:
        rows = self._boxes
        n = _padded(len(rows))
        bmin = np.zeros((n, 3), np.float32)
        bmax = np.ones((n, 3), np.float32)
        cos = np.ones(n, np.float32)
        sin = np.zeros(n, np.float32)
        off = np.zeros((n, 3), np.float32)
        mat = np.zeros(n, np.int32)
        act = np.zeros(n, bool)
        med = np.zeros(n, bool)
        nid = np.zeros(n, np.float32)
        for i, b in enumerate(rows):
            bmin[i], bmax[i], cos[i], sin[i] = b["bmin"], b["bmax"], b["cos"], b["sin"]
            off[i], mat[i], act[i] = b["off"], b["mat"], True
            med[i], nid[i] = b["medium"], b["nid"]
        return Boxes(
            bmin=np.asarray(bmin), bmax=np.asarray(bmax), cos_t=np.asarray(cos),
            sin_t=np.asarray(sin), offset=np.asarray(off), mat_id=np.asarray(mat),
            active=np.asarray(act), medium=np.asarray(med),
            neg_inv_density=np.asarray(nid),
        )

    def _pack_tris(self, cols: dict) -> Triangles:
        k = 0 if cols["mat"] is None else len(cols["mat"])
        n = _padded(k)
        z3 = np.zeros((n, 3), np.float32)
        z2 = np.zeros((n, 2), np.float32)
        v0, e1, e2 = z3.copy(), z3.copy(), z3.copy()
        n0, n1, n2 = z3.copy(), z3.copy(), z3.copy()
        uv0, uv1, uv2 = z2.copy(), z2.copy(), z2.copy()
        has_vn = np.zeros(n, bool)
        mat = np.zeros(n, np.int32)
        act = np.zeros(n, bool)
        e1[:, 0] = 1.0  # degenerate-safe padding
        e2[:, 1] = 1.0
        if k:
            v0[:k], e1[:k], e2[:k] = cols["v0"], cols["e1"], cols["e2"]
            n0[:k], n1[:k], n2[:k] = cols["n0"], cols["n1"], cols["n2"]
            uv0[:k], uv1[:k], uv2[:k] = cols["uv0"], cols["uv1"], cols["uv2"]
            has_vn[:k], mat[:k], act[:k] = cols["has_vn"], cols["mat"], True
        return Triangles(
            v0=np.asarray(v0), e1=np.asarray(e1), e2=np.asarray(e2),
            n0=np.asarray(n0), n1=np.asarray(n1), n2=np.asarray(n2),
            uv0=np.asarray(uv0), uv1=np.asarray(uv1), uv2=np.asarray(uv2),
            has_vn=np.asarray(has_vn), mat_id=np.asarray(mat),
            active=np.asarray(act),
        )

    def _pack_atlas(self) -> ImageAtlas:
        """Concatenate images into the flat atlas (reference `make_image`,
        `texture.h:166-203`)."""
        if not self._images:
            return ImageAtlas(
                data=jnp.zeros(3, jnp.float32),
                offset=jnp.zeros(1, jnp.int32),
                width=jnp.ones(1, jnp.int32),
                height=jnp.ones(1, jnp.int32),
            )
        offsets, widths, heights, chunks = [], [], [], []
        cursor = 0
        for img in self._images:
            h, w, _ = img.shape
            offsets.append(cursor)
            widths.append(w)
            heights.append(h)
            chunks.append(img.reshape(-1))
            cursor += h * w
        return ImageAtlas(
            data=np.asarray(np.concatenate(chunks), jnp.float32),
            offset=np.asarray(offsets, jnp.int32),
            width=np.asarray(widths, jnp.int32),
            height=np.asarray(heights, jnp.int32),
        )


def _padded(n: int) -> int:
    return max(_PAD, ((n + _PAD - 1) // _PAD) * _PAD)
