"""Host-side scene graph and compile-to-arrays.

Capability parity with the reference's node layer (ref:
src/akari/core/nodes/scenegraph.h:43-84 Node/commit, nodes/scene.cpp:43-95
SceneNode::compile, nodes/material.cpp:27-160 material nodes). The
reference compiles nodes into arena-allocated kernel objects wired by
pointers; here ``Scene.compile()`` lowers the graph into the flat
``SceneArrays`` pytree (scene/arrays.py): pointers become integer ids,
meshes are merged and BVH-reordered, emissive triangles become the light
table with a power CDF (ref: nodes/scene.cpp:55-92).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..bvh.build import build_bvh
from ..core.distribution import build_cdf
from ..core.spectrum import luminance
from ..core import vecmath as vm
from .arrays import (
    BVHArrays,
    LightTable,
    MAT_DIFFUSE,
    MAT_EMISSIVE,
    MAT_GLASS,
    MAT_GLOSSY,
    MAT_MIRROR,
    MAT_MIX,
    MaterialTable,
    SceneArrays,
    TEX_CONSTANT,
    TEX_IMAGE,
    TextureTable,
)


# --------------------------------------------------------------------------
# Texture nodes (ref: kernel/texture.h + nodes/material.cpp resolve_texture)
# --------------------------------------------------------------------------

@dataclass
class ConstantTexture:
    value: tuple  # rgb

    @staticmethod
    def coerce(v):
        """Scalar/3-tuple/texture -> texture (ref: material.cpp:73-89)."""
        if isinstance(v, (ConstantTexture, ImageTexture)):
            return v
        if np.isscalar(v):
            return ConstantTexture((float(v),) * 3)
        v = tuple(float(x) for x in np.asarray(v).reshape(-1)[:3])
        return ConstantTexture(v)


@dataclass
class ImageTexture:
    image: np.ndarray  # [H, W, 3] linear float32
    multiplier: tuple = (1.0, 1.0, 1.0)
    path: Optional[str] = None  # source file, for .akari round-trips

    @staticmethod
    def load(path):
        from ..core.image import read_image

        return ImageTexture(read_image(path), path=os.path.abspath(path))


# --------------------------------------------------------------------------
# Material nodes (ref: kernel/material.h variants + nodes/material.cpp)
# --------------------------------------------------------------------------

@dataclass
class DiffuseMaterial:
    color: object = (0.8, 0.8, 0.8)


@dataclass
class GlossyMaterial:
    color: object = (1.0, 1.0, 1.0)
    roughness: object = 0.1


@dataclass
class EmissiveMaterial:
    color: object = (1.0, 1.0, 1.0)
    double_sided: bool = False


@dataclass
class MirrorMaterial:
    """Perfect mirror (delta reflection with a tint). New closure vs the
    reference, whose data ships a CornellBox-Mirror scene but whose code has
    no specular BSDF (kernel/material.h has Diffuse+Microfacet only)."""

    color: object = (0.9, 0.9, 0.9)


@dataclass
class GlassMaterial:
    """Smooth dielectric (delta reflect + refract, Fresnel-weighted).
    Completes the reference's declared-but-unused dielectric surface
    (ref: kernel/bsdf-funcs.h fr_dielectric/refract are defined yet no
    closure consumes them)."""

    color: object = (1.0, 1.0, 1.0)
    ior: float = 1.5


@dataclass
class MixMaterial:
    fraction: object  # texture/scalar; prob of picking material B
    material_a: object = None
    material_b: object = None


@dataclass
class EnvMapLight:
    """Infinite environment (dome) light — beyond the reference's surface
    (it has no infinite lights). ``image`` is an equirectangular linear
    radiance map: an [H,W,3] array, an ImageTexture, or a path (.hdr /
    .png / .npy via core/image.read_image); ``scale`` multiplies it."""

    image: object
    scale: float = 1.0

    def load_image(self):
        img = self.image
        if isinstance(img, ImageTexture):
            img = img.image
        elif isinstance(img, str):
            from ..core.image import read_image

            img = read_image(img)
        img = np.asarray(img, np.float32) * np.float32(self.scale)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        return np.ascontiguousarray(img[..., :3])


# --------------------------------------------------------------------------
# Shape node (ref: nodes/mesh.cpp AkariMesh + kernel/instance.h MeshInstance)
# --------------------------------------------------------------------------

@dataclass
class Mesh:
    """Triangle mesh: indexed vertices with optional per-vertex attributes.

    ``material_ids`` maps each face to an entry of ``materials``.
    """

    vertices: np.ndarray            # [V, 3]
    indices: np.ndarray             # [F, 3] int
    materials: list = field(default_factory=list)
    material_ids: Optional[np.ndarray] = None  # [F] int into materials
    normals: Optional[np.ndarray] = None       # [V, 3] per-vertex
    uvs: Optional[np.ndarray] = None           # [V, 2] per-vertex
    # Per-corner variants override the per-vertex ones when given:
    corner_normals: Optional[np.ndarray] = None  # [F, 3, 3]
    corner_uvs: Optional[np.ndarray] = None      # [F, 3, 2]
    transform: Optional[np.ndarray] = None       # [4, 4]


@dataclass
class Instance:
    """A placement of a prototype ``Mesh`` with its own transform.

    Extends the reference's two-level BVH (per-mesh BVH + top-level BVH,
    kernel/bvh-accelerator.h:551-683) with true geometry sharing: all
    instances of one prototype share one BLAS and one set of triangle /
    attribute arrays; the TLAS stores per-instance transforms. The
    reference's MeshInstance has no transforms — this is a superset.

    ``materials`` overrides the prototype's material list (a distinct
    override list makes a distinct prototype variant, since face->material
    ids live in shared storage).
    """

    mesh: Mesh
    transform: np.ndarray                  # [4, 4] object -> world
    materials: Optional[list] = None


# --------------------------------------------------------------------------
# Scene node + compile (ref: nodes/scene.{h,cpp})
# --------------------------------------------------------------------------

@dataclass
class Scene:
    shapes: list = field(default_factory=list)   # [Mesh]
    camera: object = None                        # arrays.Camera
    integrator: object = None                    # integrators config
    environment: object = None                   # EnvMapLight or None
    output: str = "out.png"

    def compile(self, intersector="bvh"):
        return compile_scene(
            self.shapes, intersector=intersector,
            environment=self.environment,
        )


def _flatten_mesh(mesh):
    """Mesh -> per-triangle (p0,p1,p2, corner normals, corner uvs)."""
    from ..core import transform as xform

    verts = np.asarray(mesh.vertices, dtype=np.float32)
    idx = np.asarray(mesh.indices, dtype=np.int64).reshape(-1, 3)
    if mesh.transform is not None:
        verts = xform.apply_point(np.asarray(mesh.transform, np.float32), verts)
    p = verts[idx]  # [F, 3, 3]

    if mesh.corner_normals is not None:
        n = np.asarray(mesh.corner_normals, dtype=np.float32)
        if mesh.transform is not None:
            n = xform.apply_normal(mesh.transform, n.reshape(-1, 3)).reshape(n.shape)
    elif mesh.normals is not None:
        nv = np.asarray(mesh.normals, dtype=np.float32)
        if mesh.transform is not None:
            nv = xform.apply_normal(mesh.transform, nv)
        n = nv[idx]
    else:
        e1 = p[:, 1] - p[:, 0]
        e2 = p[:, 2] - p[:, 0]
        ng = np.cross(e1, e2)
        norm = np.linalg.norm(ng, axis=-1, keepdims=True)
        ng = ng / np.where(norm > 0, norm, 1.0)
        n = np.repeat(ng[:, None, :], 3, axis=1)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = (n / np.where(norm > 0, norm, 1.0)).astype(np.float32)

    if mesh.corner_uvs is not None:
        uv = np.asarray(mesh.corner_uvs, dtype=np.float32)
    elif mesh.uvs is not None:
        uv = np.asarray(mesh.uvs, dtype=np.float32)[idx]
    else:
        uv = np.zeros((idx.shape[0], 3, 2), dtype=np.float32)

    mat_ids = (
        np.zeros(idx.shape[0], dtype=np.int64)
        if mesh.material_ids is None
        else np.asarray(mesh.material_ids, dtype=np.int64)
    )
    return p, n, uv, mat_ids


class _TableBuilder:
    """Assigns ids while deduplicating by object identity."""

    def __init__(self):
        self.ids = {}
        self.items = []

    def add(self, obj):
        key = id(obj)
        if key not in self.ids:
            self.ids[key] = len(self.items)
            self.items.append(obj)
        return self.ids[key]


def _compile_textures_materials(materials):
    """Walk material graph -> (MaterialTable, TextureTable) numpy dicts."""
    mats = _TableBuilder()
    texs = _TableBuilder()
    images = []  # list of np arrays

    def tex_id(t):
        t = ConstantTexture.coerce(t)
        i = texs.add(t)
        return i

    def mat_id(m):
        i = mats.add(m)
        return i

    # Seed: walk mix graphs to register everything.
    pending = list(materials)
    seen = set()
    while pending:
        m = pending.pop()
        if id(m) in seen:
            continue
        seen.add(id(m))
        mat_id(m)
        if isinstance(m, MixMaterial):
            pending.append(m.material_a)
            pending.append(m.material_b)

    M = len(mats.items)
    kind = np.zeros(M, np.int32)
    color_tex = np.zeros(M, np.int32)
    roughness_tex = np.zeros(M, np.int32)
    fraction_tex = np.zeros(M, np.int32)
    mix_a = np.zeros(M, np.int32)
    mix_b = np.zeros(M, np.int32)
    double_sided = np.zeros(M, bool)
    ior = np.full(M, 1.5, np.float32)

    for i, m in enumerate(list(mats.items)):
        if isinstance(m, DiffuseMaterial):
            kind[i] = MAT_DIFFUSE
            color_tex[i] = tex_id(m.color)
        elif isinstance(m, GlossyMaterial):
            kind[i] = MAT_GLOSSY
            color_tex[i] = tex_id(m.color)
            roughness_tex[i] = tex_id(m.roughness)
        elif isinstance(m, EmissiveMaterial):
            kind[i] = MAT_EMISSIVE
            color_tex[i] = tex_id(m.color)
            double_sided[i] = bool(m.double_sided)
        elif isinstance(m, MirrorMaterial):
            kind[i] = MAT_MIRROR
            color_tex[i] = tex_id(m.color)
        elif isinstance(m, GlassMaterial):
            kind[i] = MAT_GLASS
            color_tex[i] = tex_id(m.color)
            ior[i] = float(m.ior)
        elif isinstance(m, MixMaterial):
            kind[i] = MAT_MIX
            fraction_tex[i] = tex_id(m.fraction)
            mix_a[i] = mats.ids[id(m.material_a)]
            mix_b[i] = mats.ids[id(m.material_b)]
        else:
            raise TypeError(f"unknown material node {type(m)}")

    X = len(texs.items)
    t_kind = np.zeros(X, np.int32)
    t_value = np.ones((X, 3), np.float32)
    t_image = np.zeros(X, np.int32)
    for i, t in enumerate(texs.items):
        if isinstance(t, ConstantTexture):
            t_kind[i] = TEX_CONSTANT
            t_value[i] = np.asarray(t.value, np.float32)
        else:
            t_kind[i] = TEX_IMAGE
            t_value[i] = np.asarray(t.multiplier, np.float32)
            t_image[i] = len(images)
            images.append(np.asarray(t.image, np.float32))

    if images:
        hm = max(im.shape[0] for im in images)
        wm = max(im.shape[1] for im in images)
        stack = np.zeros((len(images), hm, wm, 3), np.float32)
        sizes = np.zeros((len(images), 2), np.int32)
        for i, im in enumerate(images):
            stack[i, : im.shape[0], : im.shape[1]] = im[..., :3]
            sizes[i] = (im.shape[0], im.shape[1])
    else:
        stack = np.zeros((1, 1, 1, 3), np.float32)
        sizes = np.ones((1, 2), np.int32)

    mat_table = MaterialTable(
        kind=kind, color_tex=color_tex, roughness_tex=roughness_tex,
        fraction_tex=fraction_tex, mix_a=mix_a, mix_b=mix_b,
        double_sided=double_sided, ior=ior,
        has_mix=bool((kind == MAT_MIX).any()),
    )
    tex_table = TextureTable(
        kind=t_kind, value=t_value, image_id=t_image,
        images=stack, image_sizes=sizes,
        has_images=bool(images),
    )
    return mats, mat_table, tex_table, texs


def _texture_mean(texs, tex_idx):
    """Host-side mean radiance of a texture (for light power weighting;
    ref: async texture integrals, nodes/scene.cpp:62-88 + ImageTexture
    integral(), kernel/texture.h)."""
    t = texs.items[tex_idx]
    if isinstance(t, ConstantTexture):
        return float(luminance(np.asarray(t.value, np.float32)))
    mean_rgb = t.image.reshape(-1, 3).mean(axis=0) * np.asarray(t.multiplier)
    return float(luminance(mean_rgb.astype(np.float32)))


# Up to this many (flattened) triangles the GPU route is the dense
# all-pairs intersector; above it, the BVH walk. On an H100 (400 W limit),
# closest-hit of 2^20 camera + bounce rays on terrain meshes: the dense
# kernel takes 0.50 / 13.7 / 54.7 / 106 / 217 ms at 36 / 4k / 16k / 32k /
# 65k triangles, the XLA BVH walk 6.9 / 80.7 / 121 / 125 / 147 ms.
DENSE_MAX_TRIS = 32768

# Which dense intersector the GPU route uses: the Triton kernel
# (ops/pallas_intersect.py), which beat XLA's compilation of the plain
# all-pairs sweep (ops/intersect._brute_closest) end to end on the H100:
# 4.90 vs 6.31 ms per bench fwd+bwd step, 0.106 vs 0.227 s per 1024^2
# 16 spp frame.
GPU_DENSE_INTERSECTOR = "pallas"


def _auto_intersector(n_tris):
    """Resolve intersector="auto" from the JAX backend and the scene's
    flattened triangle count.

    The one routing table (ref keeps Embree-vs-BVH selection behind one
    interface the same way: nodes/scene.cpp:127-134):

    - cpu: "bvh" (compiled Pallas kernels do not run there);
    - gpu: the dense intersector up to DENSE_MAX_TRIS triangles, "bvh"
      above it (an instanced scene then keeps its two-level layout);
    - any other platform: an error.
    """
    import jax

    platform = jax.default_backend()
    if platform == "cpu":
        return "bvh"
    if platform == "gpu":
        return "bvh" if n_tris > DENSE_MAX_TRIS else GPU_DENSE_INTERSECTOR
    raise ValueError(
        f"no intersector route for JAX platform {platform!r}; "
        "supported: 'cpu', 'gpu'"
    )


def _flatten_instances(shapes):
    """Expand Instances into transformed Mesh copies (world space).

    Material objects are shared (not copied), so the texture/material
    tables dedupe across instances exactly as in the two-level compile.
    """
    import dataclasses as _dc

    out = []
    for s in shapes:
        if not isinstance(s, Instance):
            out.append(s)
            continue
        m = s.mesh
        base = np.eye(4) if m.transform is None else np.asarray(m.transform, np.float64)
        combined = np.asarray(s.transform, np.float64) @ base
        out.append(
            _dc.replace(
                m,
                transform=combined.astype(np.float32),
                materials=list(s.materials) if s.materials is not None
                else m.materials,
            )
        )
    return out


def _compile_env(environment, area_power_total):
    """EnvMapLight -> (env_image, env_cdf, env_pmf, env_p_select).

    Texel weights are luminance * sin(theta) (the equirect area measure);
    the flattened CDF gives one-searchsorted importance sampling
    (shading/soa.py env_sample). The NEE strategy mixture picks the env
    with probability env_power / (env_power + area_power) — any p in
    (0,1) is unbiased under MIS; power-proportional keeps variance low
    for both env-lit and emitter-lit scenes."""
    from ..core.spectrum import luminance as _lum

    img = environment.load_image()
    he, we = img.shape[0], img.shape[1]
    lum = (
        img[..., 0] * 0.2126 + img[..., 1] * 0.7152 + img[..., 2] * 0.0722
    ).astype(np.float64)
    sin_t = np.sin((np.arange(he, dtype=np.float64) + 0.5) / he * np.pi)
    weight = lum * sin_t[:, None]
    pmf, cdf = build_cdf(weight.reshape(-1))
    # total env power ~ mean radiance integrated over the sphere
    env_power = float((lum * sin_t[:, None]).mean() * 2.0 * np.pi * np.pi)
    p_sel = 1.0 if area_power_total <= 0.0 else env_power / (
        env_power + float(area_power_total)
    )
    p_sel = float(np.clip(p_sel, 0.05, 1.0 if area_power_total <= 0 else 0.95))
    return (
        img.astype(np.float32),
        cdf.astype(np.float32),
        pmf.astype(np.float32),
        np.float32(p_sel),
    )


def compile_scene(shapes, intersector="bvh", environment=None):
    """Merge meshes, build materials/lights/BVH -> SceneArrays (numpy leaves).

    Call ``jax.device_put`` (or just use under jit) to move to the device.
    Shapes may mix ``Mesh`` and ``Instance``. Instanced scenes compile
    two-level (TLAS/BLAS, `_compile_instanced`) when the intersector is,
    or resolves to, "bvh"; the dense intersectors ("brute", "pallas")
    need world-space triangles, so for them instances are flattened.
    """
    if any(isinstance(s, Instance) for s in shapes):
        if intersector == "auto":
            total = sum(
                len(np.asarray(
                    s.mesh.indices if isinstance(s, Instance) else s.indices
                ))
                for s in shapes
            )
            intersector = _auto_intersector(total)
        if intersector == "bvh":
            return _compile_instanced(shapes, environment=environment)
        shapes = _flatten_instances(shapes)
    all_p, all_n, all_uv, all_mid = [], [], [], []
    global_materials = []
    for mesh in shapes:
        p, n, uv, mid = _flatten_mesh(mesh)
        base = len(global_materials)
        global_materials.extend(mesh.materials or [DiffuseMaterial()])
        all_p.append(p)
        all_n.append(n)
        all_uv.append(uv)
        all_mid.append(mid + base)
    p = np.concatenate(all_p) if all_p else np.zeros((0, 3, 3), np.float32)
    n = np.concatenate(all_n)
    uv = np.concatenate(all_uv)
    mid = np.concatenate(all_mid)

    mats, mat_table, tex_table, texs = _compile_textures_materials(global_materials)
    # map per-face material object index -> table id (identity already matches
    # registration order for the top-level list, but resolve defensively)
    top_ids = np.asarray([mats.ids[id(m)] for m in global_materials], np.int32)
    face_mat = top_ids[mid]

    bvh, order = build_bvh(p[:, 0], p[:, 1], p[:, 2])
    order = np.asarray(order, np.int64)
    n_orig = p.shape[0]
    # With SBVH spatial splits a triangle may occupy several storage slots
    # (len(order) >= n_orig, duplicate entries). Lights must be enumerated
    # over ORIGINAL triangles — enumerating storage slots would double-count
    # a duplicated emitter's power and split its selection pdf across copies
    # (ref: nodes/scene.cpp:55-92 scans each triangle once).
    emissive_orig = mat_table.kind[face_mat] == MAT_EMISSIVE  # original space
    light_orig = np.nonzero(emissive_orig)[0]
    # canonical (first) storage copy of each original triangle, for gathers
    first_copy = np.full(n_orig, -1, np.int64)
    rev = np.arange(order.shape[0] - 1, -1, -1, dtype=np.int64)
    first_copy[order[rev]] = rev
    p, n, uv, face_mat = p[order], n[order], uv[order], face_mat[order]

    if intersector == "auto":
        intersector = _auto_intersector(p.shape[0])

    v0 = p[:, 0]
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]

    # Light table: every emissive-material triangle is an area light, with
    # power = emission_mean * area (ref: nodes/scene.cpp:55-92). tri_id is
    # the canonical storage copy; tri_to_light maps EVERY storage copy to
    # the same light so the MIS light-pdf of a BSDF hit is copy-invariant.
    light_tris = first_copy[light_orig].astype(np.int32)
    if light_tris.size > 0:
        areas = 0.5 * np.linalg.norm(
            np.cross(e1[light_tris], e2[light_tris]), axis=-1
        )
        power = np.asarray(
            [
                _texture_mean(texs, mat_table.color_tex[face_mat[t]])
                for t in light_tris
            ]
        ) * areas
        pdf, cdf = build_cdf(power)
        area_power_total = float(power.sum())
        light_of_orig = np.full(n_orig, -1, np.int32)
        light_of_orig[light_orig] = np.arange(light_orig.size, dtype=np.int32)
        tri_to_light = light_of_orig[order]
        lights = LightTable(
            tri_id=light_tris, cdf=cdf, pdf=pdf,
            tri_to_light=tri_to_light,
            n_lights=int(light_tris.size),
        )
    else:
        area_power_total = 0.0
        lights = LightTable(
            tri_id=np.zeros(1, np.int32),
            cdf=np.asarray([0.0, 1.0], np.float32),
            pdf=np.ones(1, np.float32),
            tri_to_light=np.full(max(v0.shape[0], 1), -1, np.int32),
            n_lights=0,
        )

    env_image = env_cdf = env_pmf = env_p = None
    if environment is not None:
        env_image, env_cdf, env_pmf, env_p = _compile_env(
            environment, area_power_total
        )

    # Fat shading table: all per-hit attributes behind ONE aligned gather
    # (see arrays.SceneArrays.prim_table for the column layout).
    t_count = v0.shape[0]
    light_sel_pdf = np.where(
        lights.tri_to_light >= 0,
        np.asarray(lights.pdf)[np.maximum(lights.tri_to_light, 0)],
        0.0,
    ).astype(np.float32)
    prim_table = np.zeros((t_count, 32), np.float32)
    prim_table[:, 0:3] = v0
    prim_table[:, 3:6] = e1
    prim_table[:, 6:9] = e2
    prim_table[:, 9:18] = n.reshape(t_count, 9)
    prim_table[:, 18:24] = uv.reshape(t_count, 6)
    prim_table[:, 24] = face_mat.astype(np.float32)  # exact for < 2^24 mats
    prim_table[:, 25] = light_sel_pdf

    return SceneArrays(
        tri_v0=v0.astype(np.float32),
        tri_e1=e1.astype(np.float32),
        tri_e2=e2.astype(np.float32),
        prim_table=prim_table,
        normals=n.astype(np.float32),
        uvs=uv.astype(np.float32),
        mat_id=face_mat,
        materials=mat_table,
        textures=tex_table,
        lights=lights,
        bvh=BVHArrays(**bvh),
        prim_to_orig=order.astype(np.int32),
        env_image=env_image,
        env_cdf=env_cdf,
        env_pmf=env_pmf,
        env_p_select=env_p,
        n_tris=int(v0.shape[0]),
        n_materials=len(mats.items),
        intersector=intersector,
    )


def _compile_instanced(shapes, environment=None):
    """Two-level compile: shared prototype BLASes + a TLAS over instances.

    Capability superset of the reference's two-level BVH
    (ref: kernel/bvh-accelerator.h:551-683 — per-mesh MeshBVH + top-level
    BVH; the reference duplicates nothing but also shares nothing across
    "instances" and has no transforms). Layout: see arrays.InstanceTable.

    Every shape becomes an instance (plain ``Mesh`` = identity transform).
    Prototypes are keyed by (mesh identity, materials-override identity):
    all instances of a prototype share triangle/attribute storage and one
    BLAS. Lights are enumerated per (instance, emissive prototype
    triangle) with world-space areas, so emissive instances each get their
    own power-CDF entries (ref: nodes/scene.cpp:55-92 scans triangles of
    every mesh the same way).
    """
    from ..bvh.build import build_aabb_bvh, build_bvh
    from .arrays import InstanceTable

    insts = []  # (mesh, materials_override_or_None, o2w [4,4])
    for s in shapes:
        if isinstance(s, Instance):
            insts.append(
                (s.mesh, s.materials, np.asarray(s.transform, np.float64))
            )
        else:
            insts.append((s, None, np.eye(4)))

    # ---- prototypes -------------------------------------------------
    proto_key_to_idx = {}
    protos = []  # dicts of per-prototype compiled data
    global_materials = []
    inst_proto = np.zeros(len(insts), np.int64)
    for i, (mesh, mats_over, _) in enumerate(insts):
        key = (id(mesh), id(mats_over) if mats_over is not None else None)
        if key not in proto_key_to_idx:
            p, n, uv, mid = _flatten_mesh(mesh)
            mats = list(mats_over if mats_over is not None
                        else (mesh.materials or [DiffuseMaterial()]))
            base = len(global_materials)
            global_materials.extend(mats)
            proto_key_to_idx[key] = len(protos)
            protos.append(dict(p=p, n=n, uv=uv, mid=mid + base))
        inst_proto[i] = proto_key_to_idx[key]

    mats, mat_table, tex_table, texs = _compile_textures_materials(
        global_materials
    )
    top_ids = np.asarray([mats.ids[id(m)] for m in global_materials], np.int32)

    # ---- per-prototype BLAS + reordered storage ---------------------
    blas_nodes = []      # list of bvh dicts (local links)
    proto_tri_base = []  # storage base per prototype
    proto_n_storage = []
    proto_lights = []    # per proto: dict(local_canonical, e1, e2, mean, count)
    all_v0, all_e1, all_e2 = [], [], []
    all_n, all_uv, all_mid, all_t2l, all_p2o = [], [], [], [], []
    tri_cursor = 0
    for pr in protos:
        p, nrm_c, uv, mid = pr["p"], pr["n"], pr["uv"], pr["mid"]
        face_mat = top_ids[mid]
        bvh, order = build_bvh(p[:, 0], p[:, 1], p[:, 2])
        order = np.asarray(order, np.int64)
        n_orig = p.shape[0]
        emissive_orig = mat_table.kind[face_mat] == MAT_EMISSIVE
        light_orig = np.nonzero(emissive_orig)[0]
        first_copy = np.full(n_orig, -1, np.int64)
        rev = np.arange(order.shape[0] - 1, -1, -1, dtype=np.int64)
        first_copy[order[rev]] = rev
        p_s, n_s, uv_s, fm_s = p[order], nrm_c[order], uv[order], face_mat[order]
        v0 = p_s[:, 0]
        e1 = p_s[:, 1] - p_s[:, 0]
        e2 = p_s[:, 2] - p_s[:, 0]
        light_of_orig = np.full(n_orig, -1, np.int32)
        light_of_orig[light_orig] = np.arange(light_orig.size, dtype=np.int32)
        canon = first_copy[light_orig]  # proto-local storage slot per light
        mean_l = np.asarray(
            [
                _texture_mean(texs, mat_table.color_tex[fm_s[c]])
                for c in canon
            ],
            np.float64,
        ) if canon.size else np.zeros(0)
        pr_l = dict(
            canon=canon.astype(np.int64),
            e1=e1[canon].astype(np.float64) if canon.size else np.zeros((0, 3)),
            e2=e2[canon].astype(np.float64) if canon.size else np.zeros((0, 3)),
            mean=mean_l,
            count=int(canon.size),
        )
        proto_lights.append(pr_l)
        blas_nodes.append(bvh)
        proto_tri_base.append(tri_cursor)
        proto_n_storage.append(int(v0.shape[0]))
        tri_cursor += int(v0.shape[0])
        all_v0.append(v0); all_e1.append(e1); all_e2.append(e2)
        all_n.append(n_s); all_uv.append(uv_s); all_mid.append(fm_s)
        all_t2l.append(light_of_orig[order])
        all_p2o.append(order.astype(np.int32))

    v0 = np.concatenate(all_v0).astype(np.float32)
    e1 = np.concatenate(all_e1).astype(np.float32)
    e2 = np.concatenate(all_e2).astype(np.float32)
    normals = np.concatenate(all_n).astype(np.float32)
    uvs = np.concatenate(all_uv).astype(np.float32)
    mat_id = np.concatenate(all_mid)
    tri_to_light = np.concatenate(all_t2l)
    prim_to_orig = np.concatenate(all_p2o)

    # ---- instance tables -------------------------------------------
    n_inst = len(insts)
    o2w34 = np.zeros((n_inst, 3, 4), np.float32)
    w2o34 = np.zeros((n_inst, 3, 4), np.float32)
    nrm33 = np.zeros((n_inst, 3, 3), np.float32)
    prim_base = np.zeros(n_inst + 1, np.int64)
    for i, (_, _, M) in enumerate(insts):
        Minv = np.linalg.inv(M)
        o2w34[i] = M[:3, :4]
        w2o34[i] = Minv[:3, :4]
        nrm33[i] = Minv[:3, :3].T
        prim_base[i + 1] = prim_base[i] + proto_n_storage[inst_proto[i]]
    tri_offset = np.asarray(
        [proto_tri_base[inst_proto[i]] - prim_base[i] for i in range(n_inst)],
        np.int32,
    )

    # ---- lights over (instance, proto light) ------------------------
    light_base = np.zeros(n_inst, np.int32)
    lt_tri, lt_power = [], []
    cursor = 0
    for i in range(n_inst):
        light_base[i] = cursor
        pl = proto_lights[inst_proto[i]]
        if pl["count"] == 0:
            continue
        R = o2w34[i, :, :3].astype(np.float64)
        we1 = pl["e1"] @ R.T
        we2 = pl["e2"] @ R.T
        areas = 0.5 * np.linalg.norm(np.cross(we1, we2), axis=-1)
        lt_tri.append(prim_base[i] + pl["canon"])
        lt_power.append(pl["mean"] * areas)
        cursor += pl["count"]
    if lt_tri:
        light_tris = np.concatenate(lt_tri).astype(np.int32)
        power = np.concatenate(lt_power)
        pdf, cdf = build_cdf(power)
        area_power_total = float(power.sum())
        lights = LightTable(
            tri_id=light_tris, cdf=cdf, pdf=pdf,
            tri_to_light=tri_to_light,
            n_lights=int(light_tris.size),
        )
    else:
        area_power_total = 0.0
        lights = LightTable(
            tri_id=np.zeros(1, np.int32),
            cdf=np.asarray([0.0, 1.0], np.float32),
            pdf=np.ones(1, np.float32),
            tri_to_light=np.full(max(v0.shape[0], 1), -1, np.int32),
            n_lights=0,
        )

    # Environment light: shared with the flat compile — env sampling /
    # evaluation is geometry-representation-agnostic (escaped rays +
    # the NEE strategy mixture), so instanced scenes use the same tables
    # (closes the r4 env-x-instancing NotImplementedError).
    env_image = env_cdf = env_pmf = env_p = None
    if environment is not None:
        env_image, env_cdf, env_pmf, env_p = _compile_env(
            environment, area_power_total
        )

    # ---- TLAS over instance world AABBs -----------------------------
    ilo = np.zeros((n_inst, 3)); ihi = np.zeros((n_inst, 3))
    for i in range(n_inst):
        b = blas_nodes[inst_proto[i]]
        lo, hi = b["node_lo"][0].astype(np.float64), b["node_hi"][0].astype(np.float64)
        corners = np.stack(
            np.meshgrid(*[(lo[k], hi[k]) for k in range(3)], indexing="ij"),
            axis=-1,
        ).reshape(8, 3)
        wc = corners @ o2w34[i, :, :3].astype(np.float64).T + o2w34[i, :, 3]
        ilo[i], ihi[i] = wc.min(axis=0), wc.max(axis=0)
    tlas, tlas_order = build_aabb_bvh(ilo, ihi, max_leaf=1)
    n_tlas = tlas["node_lo"].shape[0]

    # ---- merge node arrays: [TLAS | BLAS_0 | BLAS_1 ...] ------------
    node_base = []
    cur = n_tlas
    for b in blas_nodes:
        node_base.append(cur)
        cur += b["node_lo"].shape[0]
    merged = {}
    for k in ("node_lo", "node_hi"):
        merged[k] = np.concatenate([tlas[k]] + [b[k] for b in blas_nodes])
    merged["count"] = np.concatenate(
        [tlas["count"]] + [b["count"] for b in blas_nodes]
    )
    merged["first"] = np.concatenate(
        [tlas["first"]]
        + [b["first"] + proto_tri_base[p] for p, b in enumerate(blas_nodes)]
    )
    merged["miss"] = np.concatenate(
        [tlas["miss"]]
        + [np.where(b["miss"] >= 0, b["miss"] + node_base[p], -1)
           for p, b in enumerate(blas_nodes)]
    )
    blas_root = np.asarray(
        [node_base[inst_proto[i]] for i in range(n_inst)], np.int32
    )

    instances = InstanceTable(
        o2w=o2w34, w2o=w2o34, nrm=nrm33,
        blas_root=blas_root,
        tri_offset=tri_offset,
        prim_ends=prim_base[1:].astype(np.int32),
        light_base=light_base,
        tlas_inst=np.asarray(tlas_order, np.int32),
        n_instances=n_inst,
    )

    return SceneArrays(
        tri_v0=v0, tri_e1=e1, tri_e2=e2,
        normals=normals, uvs=uvs, mat_id=mat_id,
        materials=mat_table, textures=tex_table, lights=lights,
        bvh=BVHArrays(**merged),
        prim_to_orig=prim_to_orig,
        instances=instances,
        env_image=env_image,
        env_cdf=env_cdf,
        env_pmf=env_pmf,
        env_p_select=env_p,
        n_tris=int(prim_base[-1]),
        n_materials=len(mats.items),
        intersector="bvh",
    )
