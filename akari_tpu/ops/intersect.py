"""Ray-scene intersection ops with detached-gradient custom VJPs.

Capability parity with ``Scene::intersect`` / ``Scene::occlude``
(ref: src/akari/kernel/scene.cpp:26-63) and the Moeller-Trumbore test in
``MeshInstance::intersect`` (ref: src/akari/kernel/instance.h:43-81) —
vectorized over the whole ray batch and dispatched to one of three
interchangeable backends (ref keeps Embree vs custom-BVH behind the same
interface; here the backends are an A/B oracle for each other):

- ``brute``  : all-rays x all-triangles, tiled, in plain XLA. O(N*T)
               dense compute with no divergence; the correctness oracle.
- ``bvh``    : stackless threaded-BVH while-loop in plain XLA.
- ``pallas`` : the dense all-pairs Pallas kernel for the GPU
               (ops/pallas_intersect.py).

Differentiation: visibility is discontinuous, so the hit record (t, prim,
uv) is detached (zero VJP) — gradients flow through *shading* at the hit
point, which covers albedo/emission/roughness recovery (BASELINE config 4).
Reparameterized geometry gradients are a planned extension (diff/).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

HIT_EPS = 1e-9
T_MAX = np.float32(1e30)


class Hit(NamedTuple):
    """SoA hit record (ref: Intersection, kernel/scene.h:40-49)."""

    t: jax.Array      # [N] float32 (T_MAX when missed)
    prim: jax.Array   # [N] int32 (-1 when missed)
    uv: jax.Array     # [N, 2] barycentric (u, v); p = v0 + u*e1 + v*e2
    valid: jax.Array  # [N] bool


def moller_trumbore(o, d, v0, e1, e2, t_min, t_max):
    """Batched Moeller-Trumbore. All inputs broadcast; returns (hit, t, u, v).

    ref: instance.h:43-81 — same algorithm, branchless over lanes.
    Works with numpy or jax.numpy inputs (oracle shares it).
    """
    from ..core.vecmath import _xp, cross, dot

    xp = _xp(o, v0)
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    safe_det = xp.where(xp.abs(det) < HIT_EPS, 1.0, det)
    inv_det = 1.0 / safe_det
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = (
        (xp.abs(det) >= HIT_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    return hit, t, u, v


def _brute_closest(scene, o, d, t_min, t_max, tri_chunk=256):
    """All-pairs intersection, tiled over triangles via lax.scan.

    Dense [N, chunk] compute with no divergence — slow asymptotically but a
    bit-exact oracle. The chunk shrinks to the scene (a 36-triangle scene
    is one 36-wide chunk, with no padded triangles).
    """
    n = o.shape[0]
    t_count = scene.tri_v0.shape[0]
    tri_chunk = max(1, min(tri_chunk, t_count))
    pad = (-t_count) % tri_chunk
    v0 = jnp.pad(scene.tri_v0, ((0, pad), (0, 0)))
    e1 = jnp.pad(scene.tri_e1, ((0, pad), (0, 0)))
    # pad e2 with zeros => degenerate tris never hit
    e2 = jnp.pad(scene.tri_e2, ((0, pad), (0, 0)))
    n_chunks = (t_count + pad) // tri_chunk
    v0c = v0.reshape(n_chunks, tri_chunk, 3)
    e1c = e1.reshape(n_chunks, tri_chunk, 3)
    e2c = e2.reshape(n_chunks, tri_chunk, 3)

    def body(carry, chunk):
        best_t, best_prim, best_u, best_v, base = carry
        cv0, ce1, ce2 = chunk
        hit, t, u, v = moller_trumbore(
            o[:, None, :], d[:, None, :], cv0[None], ce1[None], ce2[None],
            t_min[:, None], best_t[:, None],
        )
        t = jnp.where(hit, t, T_MAX)
        k = jnp.argmin(t, axis=1)
        tk = jnp.take_along_axis(t, k[:, None], axis=1)[:, 0]
        closer = tk < best_t
        prim = base + k.astype(jnp.int32)
        best_t = jnp.where(closer, tk, best_t)
        best_prim = jnp.where(closer, prim, best_prim)
        best_u = jnp.where(closer, jnp.take_along_axis(u, k[:, None], 1)[:, 0], best_u)
        best_v = jnp.where(closer, jnp.take_along_axis(v, k[:, None], 1)[:, 0], best_v)
        return (best_t, best_prim, best_u, best_v, base + tri_chunk), None

    init = (
        jnp.minimum(jnp.broadcast_to(t_max, (n,)), T_MAX),
        jnp.full((n,), -1, dtype=jnp.int32),
        jnp.zeros((n,), jnp.float32),
        jnp.zeros((n,), jnp.float32),
        jnp.int32(0),
    )
    (best_t, best_prim, best_u, best_v, _), _ = jax.lax.scan(
        body, init, (v0c, e1c, e2c)
    )
    valid = best_prim >= 0
    return Hit(best_t, best_prim, jnp.stack([best_u, best_v], -1), valid)


def _intersect_impl(scene, o, d, t_min, t_max, any_hit=False):
    if scene.instances is not None:
        # Two-level instanced scenes: the XLA TLAS/BLAS while-loop.
        from ..bvh import traverse

        return traverse.intersect_instanced(scene, o, d, t_min, t_max, any_hit)
    if scene.intersector == "brute":
        if any_hit:
            h = _brute_closest(scene, o, d, t_min, t_max)
            return h.valid
        return _brute_closest(scene, o, d, t_min, t_max)
    if scene.intersector == "pallas":
        from . import pallas_intersect

        return pallas_intersect.intersect_pallas(scene, o, d, t_min, t_max, any_hit)
    from ..bvh import traverse

    return traverse.intersect_bvh(scene, o, d, t_min, t_max, any_hit)


def _intersect_detached(scene, o, d, t_min, t_max):
    """Run the intersector on fully detached inputs.

    Visibility is piecewise-constant in scene/ray parameters, so the hit
    record carries no tangents ("detached hit" convention). Detaching the
    *inputs* (rather than a custom_vjp) also keeps reverse-mode AD from ever
    tracing into the lax.while_loop traversal, which is not reverse-
    differentiable. Gradients to scene parameters flow through shading at
    the (detached) hit point instead.
    """
    sg = jax.lax.stop_gradient
    scene = jax.tree_util.tree_map(sg, scene)
    h = _intersect_impl(scene, sg(o), sg(d), sg(t_min), sg(t_max), any_hit=False)
    return (h.t, h.prim, h.uv, h.valid)


def intersect(scene, o, d, t_min=None, t_max=None):
    """Closest-hit query. o, d: [N,3]. Returns Hit. Gradients detached."""
    n = o.shape[0]
    if t_min is None:
        t_min = jnp.zeros((n,), jnp.float32)
    else:
        t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,))
    if t_max is None:
        t_max = jnp.full((n,), T_MAX, jnp.float32)
    else:
        t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    t, prim, uv, valid = _intersect_detached(scene, o, d, t_min, t_max)
    return Hit(t, prim, uv, valid)


def occlude(scene, o, d, t_min, t_max):
    """Any-hit (shadow ray) query. Returns [N] bool occluded mask.

    Detached by construction (bool output has no tangent).
    """
    n = o.shape[0]
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    scene_sg = jax.tree_util.tree_map(jax.lax.stop_gradient, scene)
    return _intersect_impl(scene_sg, o, d, t_min, t_max, any_hit=True)


# ---------------------------------------------------------------------------
# Component-SoA entry points (the hot wavefront path, core/v3.py layout):
# V3 origins/directions in, [N] component results out. The Pallas backend
# is natively SoA (eight [N] ray components); the bvh/brute backends adapt
# through the AoS interface.


class HitSoA(NamedTuple):
    t: jax.Array      # [N] float32 (T_MAX when missed)
    prim: jax.Array   # [N] int32 (-1 when missed)
    u: jax.Array      # [N] barycentric u; p = v0 + u*e1 + v*e2
    v: jax.Array      # [N] barycentric v
    valid: jax.Array  # [N] bool


def _soa_impl(scene, o3, d3, t_min, t_max, any_hit):
    if scene.intersector == "pallas" and scene.instances is None:
        from . import pallas_intersect

        return pallas_intersect.intersect_pallas_soa(
            scene, o3, d3, t_min, t_max, any_hit
        )
    o = jnp.stack(jnp.broadcast_arrays(o3.x, o3.y, o3.z), axis=-1)
    d = jnp.stack(jnp.broadcast_arrays(d3.x, d3.y, d3.z), axis=-1)
    res = _intersect_impl(scene, o, d, t_min, t_max, any_hit)
    if any_hit:
        return res
    return res.t, res.prim, res.uv[..., 0], res.uv[..., 1], res.valid


def intersect_soa(scene, o3, d3, t_min=None, t_max=None):
    """Closest-hit query on V3 rays -> HitSoA. Gradients detached."""
    n = o3.x.shape[0]
    t_min = (
        jnp.zeros((n,), jnp.float32) if t_min is None
        else jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,))
    )
    t_max = (
        jnp.full((n,), T_MAX, jnp.float32) if t_max is None
        else jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    )
    sg = jax.lax.stop_gradient
    scene = jax.tree_util.tree_map(sg, scene)
    o3 = jax.tree_util.tree_map(sg, o3)
    d3 = jax.tree_util.tree_map(sg, d3)
    return HitSoA(
        *_soa_impl(scene, o3, d3, sg(t_min), sg(t_max), False)
    )


def occlude_soa(scene, o3, d3, t_min, t_max):
    """Any-hit query on V3 rays -> [N] bool occluded."""
    n = o3.x.shape[0]
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    sg = jax.lax.stop_gradient
    scene = jax.tree_util.tree_map(sg, scene)
    o3 = jax.tree_util.tree_map(sg, o3)
    d3 = jax.tree_util.tree_map(sg, d3)
    return _soa_impl(scene, o3, d3, t_min, t_max, True)
