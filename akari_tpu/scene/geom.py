"""Instance-aware geometry gathers: virtual prim id -> world-space data.

With two-level instancing (arrays.InstanceTable) a hit carries a VIRTUAL
flattened triangle id; triangle storage holds object-space prototype
geometry shared by all instances. These helpers decode the virtual id to
(storage id, instance) and apply the instance transform, so every
integrator stays instance-agnostic. For flat scenes (``scene.instances is
None``) they reduce to the plain gathers — a static (trace-time) branch
with zero overhead on the flat path.

ref: the reference's two-level BVH returns (geom_id, prim_id) and the
caller re-assembles a Triangle from the MeshInstance buffers
(kernel/scene.cpp:26-45, instance.h:84-97); here geom_id == instance and
the re-assembly includes the transform the reference lacks.

Backend-generic (jnp / np) like the integrators.
"""

from __future__ import annotations

from ..core.vecmath import _xp, einsum


def decode_prim(scene, prim, xp=None):
    """Virtual prim id -> (storage id, instance id). Flat: (prim, None).

    ``prim`` must be pre-clamped to >= 0 (missed lanes are masked by the
    caller's ``valid``).
    """
    it = scene.instances
    if it is None:
        return prim, None
    xp = xp or _xp(prim)
    inst = xp.searchsorted(it.prim_ends, prim, side="right").astype(xp.int32)
    inst = xp.minimum(inst, it.prim_ends.shape[0] - 1)
    sid = prim + xp.take(it.tri_offset, inst)
    return sid, inst


def _apply_affine(m, p, xp):
    """[N,3,4] affine rows @ [N,3] points."""
    return einsum("nij,nj->ni", m[:, :, :3], p, xp=xp) + m[:, :, 3]


def _apply_linear(m, v, xp):
    return einsum("nij,nj->ni", m[:, :, :3], v, xp=xp)


def tri_world(scene, prim, xp=None):
    """(v0, e1, e2) of triangle ``prim`` in WORLD space. [N,3] each."""
    xp = xp or _xp(prim)
    sid, inst = decode_prim(scene, prim, xp)
    v0 = xp.take(scene.tri_v0, sid, axis=0)
    e1 = xp.take(scene.tri_e1, sid, axis=0)
    e2 = xp.take(scene.tri_e2, sid, axis=0)
    if inst is not None:
        o2w = xp.take(scene.instances.o2w, inst, axis=0)  # [N,3,4]
        v0 = _apply_affine(o2w, v0, xp)
        e1 = _apply_linear(o2w, e1, xp)
        e2 = _apply_linear(o2w, e2, xp)
    return v0, e1, e2


def mat_of_prim(scene, prim, xp=None):
    """Material table id of triangle ``prim``."""
    xp = xp or _xp(prim)
    sid, _ = decode_prim(scene, prim, xp)
    return xp.take(scene.mat_id, sid)


def uvs_of_prim(scene, prim, xp=None):
    """Per-corner texture coords [N,3,2]."""
    xp = xp or _xp(prim)
    sid, _ = decode_prim(scene, prim, xp)
    return xp.take(scene.uvs, sid, axis=0)


def normals_world(scene, prim, xp=None):
    """Per-corner shading normals [N,3,3] rotated to world (unnormalized
    under non-uniform scale — callers normalize after interpolation)."""
    xp = xp or _xp(prim)
    sid, inst = decode_prim(scene, prim, xp)
    ns_c = xp.take(scene.normals, sid, axis=0)  # [N,3,3]
    if inst is not None:
        nrm = xp.take(scene.instances.nrm, inst, axis=0)  # [N,3,3]
        ns_c = einsum("nij,ncj->nci", nrm, ns_c, xp=xp)
    return ns_c


def light_of_prim(scene, prim, xp=None):
    """Light id of triangle ``prim`` (-1 if not emissive).

    Flat scenes: a direct per-storage-triangle map. Instanced scenes:
    per-prototype light index + the instance's light base (every storage
    copy of an SBVH-duplicated emitter maps to the same light, and every
    instance gets its own run of light ids).
    """
    xp = xp or _xp(prim)
    it = scene.instances
    if it is None:
        return xp.take(scene.lights.tri_to_light, prim)
    sid, inst = decode_prim(scene, prim, xp)
    local = xp.take(scene.lights.tri_to_light, sid)
    base = xp.take(it.light_base, inst)
    return xp.where(local >= 0, base + local, -1)
