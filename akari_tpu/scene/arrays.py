"""Device scene representation: flat SoA arrays in a pytree.

Redesign of the reference's pointer-based compiled scene
(``Scene<C>`` aggregate of BufferViews + Material*/Texture* pointers,
ref: src/akari/kernel/scene.h:50-91 and nodes/scene.cpp:43-95 compile).
Every pointer becomes an integer id into a flat table; every AoS buffer
becomes per-field arrays (the reference generates SoA code with akari-soac —
here arrays are already SoA, SURVEY.md §7).

The whole ``SceneArrays`` is a JAX pytree: it can be donated to jit,
replicated across a device mesh, and differentiated (albedo / emission
gradients flow into ``TextureTable.value`` / ``.images``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import jax
import numpy as np

# Material kinds (ref: Material variant, kernel/material.h:249)
MAT_DIFFUSE = 0
MAT_GLOSSY = 1
MAT_EMISSIVE = 2
MAT_MIX = 3
MAT_MIRROR = 4
MAT_GLASS = 5

# Texture kinds (ref: Texture variant, kernel/texture.h:57)
TEX_CONSTANT = 0
TEX_IMAGE = 1

# How many nested Mix levels select_material unrolls (ref walks a pointer
# chain, kernel/material.h:255-271; we unroll a fixed depth).
MAX_MIX_DEPTH = 4


def pytree_dataclass(cls=None, *, meta=()):
    """Register a dataclass as a JAX pytree with the given static fields."""

    def wrap(c):
        c = dataclass(c)
        data_fields = [f.name for f in dataclasses.fields(c) if f.name not in meta]
        jax.tree_util.register_dataclass(
            c, data_fields=data_fields, meta_fields=list(meta)
        )
        return c

    return wrap(cls) if cls is not None else wrap


@pytree_dataclass(meta=("has_images",))
class TextureTable:
    """All textures in the scene, SoA.

    kind[i] selects constant vs image; ``value`` doubles as the constant RGB
    and as a multiplier for image textures. Images are padded to a common
    [Hm, Wm] and stacked (static shapes for XLA).
    ref: kernel/texture.h:30-66 (ConstantTexture / ImageTexture variant).

    ``has_images`` is static: False lets shading skip the bilinear image
    path entirely at trace time (constant-only scenes resolve textures to
    a flat [X,3] value table).
    """

    kind: jax.Array      # [X] int32
    value: jax.Array     # [X, 3] float32 (constant color / image multiplier)
    image_id: jax.Array  # [X] int32 (index into images; 0 if unused)
    images: jax.Array    # [I, Hm, Wm, 3] float32 (at least I=1 dummy)
    image_sizes: jax.Array  # [I, 2] int32 (h, w actually used)
    has_images: bool = False


@pytree_dataclass(meta=("has_mix",))
class MaterialTable:
    """All materials, SoA (ref: Material variant, kernel/material.h:249-299).

    kind: MAT_*; color_tex / roughness_tex / fraction_tex are texture ids;
    mix_a / mix_b are material ids (for MAT_MIX); double_sided for emissive.

    ``has_mix`` is static: False skips the MAX_MIX_DEPTH selection walk at
    trace time (most scenes have no Mix materials).
    """

    kind: jax.Array          # [M] int32
    color_tex: jax.Array     # [M] int32
    roughness_tex: jax.Array # [M] int32
    fraction_tex: jax.Array  # [M] int32
    mix_a: jax.Array         # [M] int32
    mix_b: jax.Array         # [M] int32
    double_sided: jax.Array  # [M] bool
    # [M] float32 index of refraction (MAT_GLASS); None = all-1.5 default
    # (kept optional so hand-built tables stay valid).
    ior: jax.Array = None
    has_mix: bool = False


@pytree_dataclass(meta=("n_lights",))
class LightTable:
    """Emissive-triangle area lights + power CDF.

    ref: AreaLight buffer + power Distribution1D built at scene compile
    (nodes/scene.cpp:55-92, kernel/light.h:47-76).
    """

    tri_id: jax.Array   # [L] int32 triangle index of each light
    cdf: jax.Array      # [L+1] float32 power CDF
    pdf: jax.Array      # [L] float32 selection pmf
    tri_to_light: jax.Array  # [T] int32 (-1 if triangle is not a light) — for MIS
    n_lights: int = 0   # static: 0 => no lights (arrays are padded >= 1)


@pytree_dataclass
class BVHArrays:
    """Threaded (stackless) BVH: DFS-ordered nodes with skip links.

    Redesign of the reference's stack-based two-level SBVH traversal
    (ref: kernel/bvh-accelerator.h:488-547). A per-lane traversal stack is
    hostile to vector machines; instead nodes carry an implicit "hit" link
    (DFS next = node+1) and an explicit ``miss`` link, so per-ray state is a
    single node pointer and the traversal is a branchless while-loop.

    Triangles are reordered so each leaf's primitives are contiguous:
    first[i]..first[i]+count[i] index the *reordered* triangle arrays.
    """

    node_lo: jax.Array  # [N, 3] float32
    node_hi: jax.Array  # [N, 3] float32
    first: jax.Array    # [N] int32 (leaf: offset into reordered tris)
    count: jax.Array    # [N] int32 (0 for inner nodes)
    miss: jax.Array     # [N] int32 (-1 terminates)


@pytree_dataclass(meta=("n_instances",))
class InstanceTable:
    """Two-level (TLAS/BLAS) instancing tables.

    Extension of the reference's two-level BVH
    (ref: kernel/bvh-accelerator.h:551-683 — per-mesh MeshBVH + top-level
    BVH over BVHHandles; the reference shares no geometry between
    instances and has no transforms, so this is a strict superset).

    Node layout: ``SceneArrays.bvh`` holds ``[TLAS | BLAS_0 | BLAS_1 ...]``
    in one threaded array set. TLAS leaves hold exactly ONE instance:
    ``first`` indexes ``tlas_inst``. BLAS leaves index global *storage*
    triangles; BLAS miss links are globalized (terminator stays -1 =
    "exit this BLAS").

    Prim-id encoding: hits carry a **virtual** flattened triangle id so the
    Hit record and all integrators stay instance-agnostic. Instance ``i``
    owns virtual ids ``[prim_ends[i-1], prim_ends[i])``;
    ``storage_id = virtual + tri_offset[inst]``. Decode = one searchsorted
    over [I] + a gather (scene/geom.py).
    """

    o2w: jax.Array        # [I, 3, 4] object->world (rows; translate in col 3)
    w2o: jax.Array        # [I, 3, 4] world->object
    nrm: jax.Array        # [I, 3, 3] normal matrix (= w2o rotation^T)
    blas_root: jax.Array  # [I] int32 global node index of the instance's BLAS
    tri_offset: jax.Array # [I] int32: virtual prim + offset = storage prim
    prim_ends: jax.Array  # [I] int32 exclusive ends of virtual prim ranges
    light_base: jax.Array # [I] int32 first light id of this instance
    tlas_inst: jax.Array  # [I] int32: TLAS leaf order -> instance id
    n_instances: int = 0


@pytree_dataclass(meta=("n_tris", "n_materials", "intersector"))
class SceneArrays:
    """The compiled scene. Triangle storage is in BVH-reordered order.

    tri_v0/e1/e2: Moeller-Trumbore-ready vertices (v0, v1-v0, v2-v0).
    normals/uvs: per-corner shading attributes [T, 3, ...].
    """

    tri_v0: jax.Array    # [T, 3]
    tri_e1: jax.Array    # [T, 3]
    tri_e2: jax.Array    # [T, 3]
    normals: jax.Array   # [T, 3, 3] per-corner shading normals
    uvs: jax.Array       # [T, 3, 2]
    mat_id: jax.Array    # [T] int32
    materials: MaterialTable
    textures: TextureTable
    lights: LightTable
    bvh: BVHArrays
    # Environment (dome) light — beyond the reference's surface (it has
    # no infinite lights): equirectangular radiance map + a flattened
    # luminance*sin(theta) CDF for importance sampling (one searchsorted
    # per NEE draw), and the NEE strategy-mixture probability of picking
    # the env over the area lights. None = no environment.
    env_image: jax.Array = None     # [He, We, 3] f32 linear radiance
    env_cdf: jax.Array = None       # [He*We + 1] f32 flattened texel CDF
    env_pmf: jax.Array = None       # [He*We] f32 texel pmf
    env_p_select: jax.Array = None  # [] f32 P(pick env | NEE)
    # [T, 32] fat per-triangle shading-attribute table (flat scenes): one
    # row gather (ops/gather.py) replaces ~10 narrow gathers per bounce. Columns: v0(0:3) e1(3:6) e2(6:9)
    # normals(9:18) uvs(18:24) mat_id(24) light_sel_pdf(25) pad(26:32).
    # Derived from the same storage as tri_v0/normals/uvs at compile.
    prim_table: jax.Array = None
    # [T] int32: storage slot -> original triangle id. With SBVH spatial
    # splits a triangle occupies several storage slots; this recovers the
    # physical identity (duplicate copies share one original id).
    prim_to_orig: jax.Array = None
    # Two-level instancing (None = flat scene; triangle storage is then in
    # world space and prim ids are storage ids directly).
    instances: InstanceTable = None
    n_tris: int = 0
    n_materials: int = 0
    intersector: str = "bvh"  # "brute" | "bvh" | "pallas"


@pytree_dataclass(meta=("width", "height", "lens_radius", "focal_distance"))
class Camera:
    """Perspective pinhole/thin-lens camera (ref: kernel/camera.h:37-99).

    Looks down local -Z; fov is the vertical field of view in radians
    (applied to the smaller image dimension like the reference's r2c chain,
    camera.h:45-61, but with the standard tan(fov/2) plane scale).
    Lens parameters are static (they gate a trace-time branch).
    """

    c2w: jax.Array          # [4, 4]
    tan_half_fov: jax.Array # [] float32
    width: int = 0
    height: int = 0
    lens_radius: float = 0.0
    focal_distance: float = 0.0


def make_camera(c2w, fov_deg, width, height, lens_radius=0.0, focal_distance=0.0):
    import numpy as np

    return Camera(
        c2w=np.asarray(c2w, dtype=np.float32),
        tan_half_fov=np.float32(np.tan(np.radians(fov_deg) / 2.0)),
        width=int(width),
        height=int(height),
        lens_radius=float(lens_radius),
        focal_distance=float(focal_distance),
    )


def tri_vertices(scene, xp=None):
    """Recover (p0, p1, p2) [T,3] each from the v0/e1/e2 storage."""
    v0, e1, e2 = scene.tri_v0, scene.tri_e1, scene.tri_e2
    return v0, v0 + e1, v0 + e2


def tri_geometric_normal(scene):
    """Unnormalized geometric normal = cross(e1, e2) (winding convention:
    counter-clockwise front faces, matching ref kernel/shape.h ng())."""
    from ..core.vecmath import cross

    return cross(scene.tri_e1, scene.tri_e2)


def tri_area(scene):
    from ..core.vecmath import length

    return 0.5 * length(tri_geometric_normal(scene))
