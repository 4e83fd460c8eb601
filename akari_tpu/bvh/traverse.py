"""Stackless BVH traversal in plain XLA (the general-path intersector).

Redesign of the reference's stack-based traversal
(ref: src/akari/kernel/bvh-accelerator.h:488-547: 64-deep local stack,
near/far child ordering by ray sign). On a vector machine a per-lane stack
thrashes; the threaded layout (bvh/build.py) reduces per-ray state to one
node pointer and the whole batch steps in lockstep inside one
``lax.while_loop``:

    node = where(aabb_hit & inner, node + 1,      # descend (DFS next)
                 miss_link[node])                  # skip subtree / pop

Leaf primitive tests are a fixed MAX_LEAF-way unrolled masked gather, so
there is no data-dependent inner loop. All memory access is gathers, which
XLA vectorizes over the ray batch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.vecmath import einsum
from ..ops.intersect import Hit, T_MAX, moller_trumbore
from .build import MAX_LEAF


def _gather3(arr, idx):
    return jnp.take(arr, idx, axis=0)


def intersect_bvh(scene, o, d, t_min, t_max, any_hit=False):
    """Batched closest-hit (or any-hit) traversal. o, d: [N,3]."""
    bvh = scene.bvh
    n = o.shape[0]

    safe_d = jnp.where(jnp.abs(d) < 1e-12, jnp.where(d < 0, -1e-12, 1e-12), d)
    inv_d = 1.0 / safe_d

    # Hard trip bound: the threaded skip-link pointer is strictly
    # increasing (descend = +1, miss links jump forward), so any ray
    # finishes within n_nodes steps. The explicit bound turns a
    # corrupted-layout hang into a bounded run.
    max_steps = jnp.int32(bvh.node_lo.shape[0] + 8)

    def cond(state):
        step, node, *_ = state
        return (step < max_steps) & jnp.any(node >= 0)

    def body(state):
        step, node, best_t, best_prim, best_u, best_v = state
        active = node >= 0
        ni = jnp.maximum(node, 0)
        lo = _gather3(bvh.node_lo, ni)
        hi = _gather3(bvh.node_hi, ni)
        first = jnp.take(bvh.first, ni)
        count = jnp.take(bvh.count, ni)
        miss = jnp.take(bvh.miss, ni)

        # slab test against current best_t (shrinking t_max prunes)
        t0 = (lo - o) * inv_d
        t1 = (hi - o) * inv_d
        near = jnp.maximum(jnp.max(jnp.minimum(t0, t1), axis=-1), t_min)
        far = jnp.minimum(jnp.min(jnp.maximum(t0, t1), axis=-1), best_t)
        hit_box = (near <= far) & active

        is_leaf = count > 0
        at_leaf = hit_box & is_leaf

        # Unrolled leaf primitive tests (reordered tris are leaf-contiguous).
        for k in range(MAX_LEAF):
            pid = first + k
            lane = at_leaf & (k < count)
            pid_s = jnp.where(lane, pid, 0)
            v0 = _gather3(scene.tri_v0, pid_s)
            e1 = _gather3(scene.tri_e1, pid_s)
            e2 = _gather3(scene.tri_e2, pid_s)
            h, t, u, v = moller_trumbore(o, d, v0, e1, e2, t_min, best_t)
            h = h & lane
            best_prim = jnp.where(h, pid, best_prim)
            best_u = jnp.where(h, u, best_u)
            best_v = jnp.where(h, v, best_v)
            best_t = jnp.where(h, t, best_t)

        descend = hit_box & ~is_leaf
        next_node = jnp.where(descend, node + 1, miss)
        next_node = jnp.where(active, next_node, -1)
        if any_hit:
            next_node = jnp.where(best_prim >= 0, -1, next_node)
        return (step + 1, next_node, best_t, best_prim, best_u, best_v)

    init = (
        jnp.int32(0),
        jnp.zeros((n,), jnp.int32),
        jnp.minimum(jnp.broadcast_to(t_max, (n,)), T_MAX),
        jnp.full((n,), -1, jnp.int32),
        jnp.zeros((n,), jnp.float32),
        jnp.zeros((n,), jnp.float32),
    )
    _, node, best_t, best_prim, best_u, best_v = jax.lax.while_loop(
        cond, body, init
    )
    valid = best_prim >= 0
    if any_hit:
        return valid
    return Hit(best_t, best_prim, jnp.stack([best_u, best_v], -1), valid)


def intersect_instanced(scene, o, d, t_min, t_max, any_hit=False):
    """Two-level (TLAS -> BLAS) stackless traversal with instance transforms.

    Redesign of the reference's two-level BVH traversal
    (ref: kernel/bvh-accelerator.h:551-683 top/bottom intersect): both
    levels live in ONE threaded node array set ([TLAS | BLAS...]) and one
    ``lax.while_loop`` steps all rays in lockstep. Per-ray state is a TLAS
    continuation pointer + a BLAS pointer: entering an instance at a TLAS
    leaf parks the TLAS at its miss link, transforms the ray into object
    space (affine, so the t parameter is shared across levels and best-t
    pruning works globally), and walks the BLAS until its -1 terminator
    pops back to the parked TLAS pointer. No stack, no divergence beyond
    lane masking. Hits record VIRTUAL prim ids (arrays.InstanceTable).
    """
    bvh = scene.bvh
    it = scene.instances
    n = o.shape[0]

    def safe_inv(v):
        return 1.0 / jnp.where(jnp.abs(v) < 1e-12, jnp.where(v < 0, -1e-12, 1e-12), v)

    # Trip bound (see intersect_bvh): both level pointers walk strictly
    # forward through the shared [TLAS | BLAS...] node array, so a ray
    # can take at most one step per node plus one per instance entry.
    max_steps = jnp.int32(bvh.node_lo.shape[0] + it.blas_root.shape[0] + 8)

    def cond(state):
        step, tnode, bnode, *_ = state
        return (step < max_steps) & jnp.any((tnode >= 0) | (bnode >= 0))

    def body(state):
        (step, tnode, bnode, inst, oo, od,
         best_t, best_prim, best_u, best_v) = state
        in_blas = bnode >= 0
        active = in_blas | (tnode >= 0)
        ni = jnp.where(in_blas, bnode, jnp.maximum(tnode, 0))
        lo = _gather3(bvh.node_lo, ni)
        hi = _gather3(bvh.node_hi, ni)
        first = jnp.take(bvh.first, ni)
        count = jnp.take(bvh.count, ni)
        miss = jnp.take(bvh.miss, ni)

        ro = jnp.where(in_blas[:, None], oo, o)
        rd = jnp.where(in_blas[:, None], od, d)
        inv_rd = safe_inv(rd)
        t0 = (lo - ro) * inv_rd
        t1 = (hi - ro) * inv_rd
        near = jnp.maximum(jnp.max(jnp.minimum(t0, t1), axis=-1), t_min)
        far = jnp.minimum(jnp.min(jnp.maximum(t0, t1), axis=-1), best_t)
        hit_box = (near <= far) & active
        is_leaf = count > 0

        # BLAS leaf: unrolled triangle tests in object space.
        at_tri_leaf = hit_box & is_leaf & in_blas
        voff = jnp.take(it.tri_offset, jnp.maximum(inst, 0))
        for k in range(MAX_LEAF):
            pid = first + k  # global storage id
            lane = at_tri_leaf & (k < count)
            pid_s = jnp.where(lane, pid, 0)
            v0 = _gather3(scene.tri_v0, pid_s)
            e1 = _gather3(scene.tri_e1, pid_s)
            e2 = _gather3(scene.tri_e2, pid_s)
            h, t, u, v = moller_trumbore(ro, rd, v0, e1, e2, t_min, best_t)
            h = h & lane
            best_prim = jnp.where(h, pid - voff, best_prim)  # virtual id
            best_u = jnp.where(h, u, best_u)
            best_v = jnp.where(h, v, best_v)
            best_t = jnp.where(h, t, best_t)

        # TLAS leaf hit: enter the (single) instance; park TLAS at miss.
        tlas_enter = hit_box & is_leaf & ~in_blas
        inst_new = jnp.take(it.tlas_inst, jnp.where(tlas_enter, first, 0))
        inst = jnp.where(tlas_enter, inst_new, inst)
        w2o = jnp.take(it.w2o, jnp.maximum(inst, 0), axis=0)  # [N, 3, 4]
        oo_new = (
            einsum("nij,nj->ni", w2o[:, :, :3], o, xp=jnp) + w2o[:, :, 3]
        )
        od_new = einsum("nij,nj->ni", w2o[:, :, :3], d, xp=jnp)
        oo = jnp.where(tlas_enter[:, None], oo_new, oo)
        od = jnp.where(tlas_enter[:, None], od_new, od)

        # next pointers
        blas_step = jnp.where(hit_box & ~is_leaf, bnode + 1, miss)
        bnode_next = jnp.where(
            in_blas, blas_step,
            jnp.where(tlas_enter, jnp.take(it.blas_root, jnp.maximum(inst, 0)), bnode),
        )
        tlas_step = jnp.where(hit_box & ~is_leaf & ~tlas_enter, tnode + 1, miss)
        tnode_next = jnp.where(in_blas | (tnode < 0), tnode, tlas_step)
        if any_hit:
            found = best_prim >= 0
            bnode_next = jnp.where(found, -1, bnode_next)
            tnode_next = jnp.where(found, -1, tnode_next)
        return (step + 1, tnode_next, bnode_next, inst, oo, od,
                best_t, best_prim, best_u, best_v)

    init = (
        jnp.int32(0),
        jnp.zeros((n,), jnp.int32),            # tnode
        jnp.full((n,), -1, jnp.int32),         # bnode
        jnp.zeros((n,), jnp.int32),            # inst
        o, d,                                  # object-space ray (lazily set)
        jnp.minimum(jnp.broadcast_to(t_max, (n,)), T_MAX),
        jnp.full((n,), -1, jnp.int32),
        jnp.zeros((n,), jnp.float32),
        jnp.zeros((n,), jnp.float32),
    )
    (_, _, _, _, _, _, best_t, best_prim, best_u, best_v) = jax.lax.while_loop(
        cond, body, init
    )
    valid = best_prim >= 0
    if any_hit:
        return valid
    return Hit(best_t, best_prim, jnp.stack([best_u, best_v], -1), valid)
