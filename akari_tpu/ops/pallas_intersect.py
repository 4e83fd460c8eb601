"""Dense ray-stream intersection: a Pallas kernel for Hopper (Triton route).

All-pairs Moeller-Trumbore for small scenes (the Cornell box): every ray
tests every triangle, so there is no traversal, no gather and no
divergence. One program owns ``RAY_BLOCK`` rays, one ray per thread. A
loop inside the program walks the triangles in index order; each
triangle's nine floats are loaded as scalars and broadcast to every lane,
and the running closest hit ``(t, u, v, prim)`` stays in registers until
one store at the end. A hit must be strictly closer than the best so far
to replace it, so among equal-t hits the lowest triangle index wins: the
tie rule of the brute-force oracle (``ops/intersect._brute_closest``), so
``prim`` matches it exactly.

Scenes above the dense threshold (``scene/nodes.DENSE_MAX_TRIS``) take the
XLA BVH walk (bvh/traverse.py) instead.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..core.v3 import V3
from .intersect import HIT_EPS, T_MAX, Hit

# One ray per thread: 128 rays = 4 warps. Blocks are small so that a
# 2^22-ray launch spreads over every SM many times.
RAY_BLOCK = 128
NUM_WARPS = 4
NUM_STAGES = 1
_BIG = np.float32(T_MAX)

# Set True to run the kernel in the Pallas interpreter (CPU test suites).
INTERPRET = False


def _mt(ray, tri, best_t):
    """Moeller-Trumbore of [R] ray components against one triangle given
    as nine scalars; returns (hit, t, u, v) as [R] arrays."""
    ox, oy, oz, dx, dy, dz, tmin = ray
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = 1.0 / jnp.where(jnp.abs(det) < HIT_EPS, 1.0, det)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (
        (jnp.abs(det) >= HIT_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > tmin)
        & (t < best_t)
    )
    return hit, t, u, v


def _kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, tmin_ref,
            tmax_ref, tris_ref, *out_refs, n_tris, any_hit):
    ray = tuple(
        r[...] for r in (ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
                         tmin_ref)
    )
    t_max = jnp.minimum(tmax_ref[...], _BIG)

    def tri(i):
        return tuple(tris_ref[i, k] for k in range(9))

    if any_hit:
        def body(i, occ):
            hit, _, _, _ = _mt(ray, tri(i), t_max)
            return occ | hit.astype(jnp.int32)

        (occ_ref,) = out_refs
        occ_ref[...] = jax.lax.fori_loop(
            0, n_tris, body, jnp.zeros_like(t_max, jnp.int32)
        )
        return

    def body(i, carry):
        best_t, best_u, best_v, best_p = carry
        hit, t, u, v = _mt(ray, tri(i), best_t)
        return (
            jnp.where(hit, t, best_t),
            jnp.where(hit, u, best_u),
            jnp.where(hit, v, best_v),
            jnp.where(hit, i, best_p),
        )

    zero = jnp.zeros_like(t_max)
    init = (t_max, zero, zero, jnp.full(t_max.shape, -1, jnp.int32))
    best_t, best_u, best_v, best_p = jax.lax.fori_loop(0, n_tris, body, init)
    t_ref, u_ref, v_ref, p_ref = out_refs
    t_ref[...] = best_t
    u_ref[...] = best_u
    v_ref[...] = best_v
    p_ref[...] = best_p


def pack_tris(tri_v0, tri_e1, tri_e2):
    """[T,3] x3 -> [T, 16] rows (v0 e1 e2, then 7 pad floats): 64-byte
    rows, so one triangle's scalars share a cache line."""
    t = tri_v0.shape[0]
    return jnp.concatenate(
        [tri_v0, tri_e1, tri_e2, jnp.zeros((t, 7), jnp.float32)], axis=1
    )


@functools.partial(jax.jit, static_argnames=("any_hit", "interpret"))
def _run(rays, tris, any_hit, interpret=False):
    """``rays``: eight [N] arrays (ox oy oz dx dy dz tmin tmax), N a
    multiple of RAY_BLOCK. Returns [N] int32 occlusion, or (t, u, v, prim)."""
    n = rays[0].shape[0]
    ray_spec = pl.BlockSpec((RAY_BLOCK,), lambda i: (i,))
    if any_hit:
        out_shape = jax.ShapeDtypeStruct((n,), jnp.int32)
        out_specs = ray_spec
    else:
        out_shape = (
            jax.ShapeDtypeStruct((n,), jnp.float32),
            jax.ShapeDtypeStruct((n,), jnp.float32),
            jax.ShapeDtypeStruct((n,), jnp.float32),
            jax.ShapeDtypeStruct((n,), jnp.int32),
        )
        out_specs = (ray_spec,) * 4
    kernel = functools.partial(
        _kernel, n_tris=int(tris.shape[0]), any_hit=any_hit
    )
    return pl.pallas_call(
        kernel,
        grid=(n // RAY_BLOCK,),
        in_specs=[ray_spec] * 8 + [pl.no_block_spec],
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        interpret=interpret,
        name="dense_intersect_anyhit" if any_hit else "dense_intersect",
    )(*rays, tris)


def intersect_pallas_soa(scene, o, d, t_min, t_max, any_hit=False):
    """Component-SoA entry: V3 o/d, [N] t_min/t_max.

    Returns ``occluded [N] bool`` (any_hit) or ``(t, prim, u, v, valid)``
    all [N]. Padded rays have d = 0, so det = 0 and they never hit.
    """
    n = o.x.shape[0]
    pad = (-n) % RAY_BLOCK
    rays = [
        jnp.broadcast_to(jnp.asarray(a, jnp.float32), (n,))
        for a in (o.x, o.y, o.z, d.x, d.y, d.z, t_min, t_max)
    ]
    if pad:
        rays = [jnp.pad(a, (0, pad)) for a in rays]
    tris = pack_tris(scene.tri_v0, scene.tri_e1, scene.tri_e2)
    out = _run(tuple(rays), tris, any_hit, interpret=INTERPRET)
    if any_hit:
        return out[:n] > 0
    t, u, v, prim = (a[:n] for a in out)
    valid = prim >= 0
    return jnp.where(valid, t, _BIG), prim, u, v, valid


def intersect_pallas(scene, o, d, t_min, t_max, any_hit=False):
    """AoS wrapper ([N,3] o/d -> Hit) for the generic dispatch
    (ops.intersect) and the AoS integrators (BDPT/AO)."""
    o3 = V3(o[..., 0], o[..., 1], o[..., 2])
    d3 = V3(d[..., 0], d[..., 1], d[..., 2])
    res = intersect_pallas_soa(scene, o3, d3, t_min, t_max, any_hit)
    if any_hit:
        return res
    t, prim, u, v, valid = res
    return Hit(t, prim, jnp.stack([u, v], -1), valid)
