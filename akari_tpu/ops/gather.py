"""Per-lane row gathers from small tables via one-hot matmuls.

``one_hot(ids) @ table`` instead of ``jnp.take(table, ids)``. The reason
is the backward pass: the VJP of ``take`` is a scatter-add of every lane's
cotangent into a table of a few dozen rows (texture values, materials),
which serializes on contention; the VJP of the one-hot product is again a
matmul. On an H100 (400 W limit) the bench fwd+bwd step (Cornell 256^2,
4 spp, depth 5) takes 4.90 ms with these gathers and 9.19 ms with
``jnp.take`` — though a forward-only 1024^2 16 spp frame is faster with
``take`` (0.064 vs 0.106 s).

This is the renderer's analog of the reference's SoA gathers in
``MeshInstance``/``Material`` lookups (ref: src/akari/kernel/instance.h:84-97,
kernel/material.h:285-297).

Exactness: the one-hot operand is exactly {0.0, 1.0} and each output row
sums exactly one product, so with HIGHEST precision (full float32; the
GPU would otherwise use TF32) the result is bit-exact for finite f32
table values. The CPU backend's f32 dot is exact as well, so golden tests
vs the NumPy oracle are unaffected.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Above this row count the [N, T] one-hot operand's memory traffic
# exceeds what a native gather costs; fall back to jnp.take.
ONEHOT_MAX_ROWS = 2048


def _round_up(x, m):
    return (x + m - 1) // m * m


def gather_rows(table, ids, max_onehot_rows=ONEHOT_MAX_ROWS):
    """``table[ids]`` for a 2-D f32 table and int ids of any shape.

    Dispatches between a one-hot matmul (small tables) and jnp.take
    (large tables / non-jax inputs). Out-of-range ids return zeros
    (one-hot has no hot lane), which callers mask anyway.
    """
    if isinstance(table, np.ndarray) and not isinstance(ids, jax.Array):
        return np.take(table, np.asarray(ids), axis=0)
    table = jnp.asarray(table)
    ids = jnp.asarray(ids)
    t, c = table.shape
    if t > max_onehot_rows:
        return jnp.take(table, ids, axis=0)
    tp = _round_up(max(t, 8), 8)
    if tp != t:
        table = jnp.pad(table, ((0, tp - t), (0, 0)))
    flat = ids.reshape(-1)
    oh = (
        flat[:, None] == jax.lax.broadcasted_iota(jnp.int32, (1, tp), 1)
    ).astype(jnp.float32)
    out = jax.lax.dot_general(
        oh,
        table,
        dimension_numbers=(((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    return out.reshape(*ids.shape, c)


def gather_rows_t(table, ids, max_onehot_rows=ONEHOT_MAX_ROWS):
    """Transposed gather: ``table[ids].T`` -> [C, N].

    The hot-path variant (core/v3.py layout): the one-hot operand is built
    as [Tpad, N] and the matmul is ``table.T @ one_hot`` so the result
    lands as [C, N]. Row slices ``out[i]`` then feed the component-SoA
    shading directly, each a contiguous [N] array.
    """
    if isinstance(table, np.ndarray) and not isinstance(ids, jax.Array):
        return np.take(table, np.asarray(ids), axis=0).T
    table = jnp.asarray(table)
    ids = jnp.asarray(ids)
    t, c = table.shape
    if t > max_onehot_rows:
        return jnp.take(table, ids, axis=0).T
    tp = _round_up(max(t, 8), 8)
    if tp != t:
        table = jnp.pad(table, ((0, tp - t), (0, 0)))
    flat = ids.reshape(-1)
    oh = (
        flat[None, :] == jax.lax.broadcasted_iota(jnp.int32, (tp, 1), 0)
    ).astype(jnp.float32)
    out = jax.lax.dot_general(
        table,
        oh,
        dimension_numbers=(((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    return out


def gather_cols(fat, spec):
    """Split a fat gathered [..., C] block back into named pieces.

    ``spec`` is a list of (name, width); returns dict name -> [..., width]
    (width 1 squeezes the last axis).
    """
    out = {}
    off = 0
    for name, width in spec:
        sl = fat[..., off : off + width]
        out[name] = sl[..., 0] if width == 1 else sl
        off += width
    return out
