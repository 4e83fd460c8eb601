"""ops/gather.py: one-hot gathers must match jnp.take bit-exactly."""

import jax
import jax.numpy as jnp
import numpy as np

from akari_tpu.ops.gather import ONEHOT_MAX_ROWS, gather_cols, gather_rows


def test_gather_rows_matches_take_exactly():
    rng = np.random.default_rng(0)
    for t, c in [(1, 1), (7, 3), (36, 32), (129, 26), (300, 17)]:
        table = rng.standard_normal((t, c)).astype(np.float32) * 1e3
        ids = rng.integers(0, t, size=(1000,)).astype(np.int32)
        got = np.asarray(gather_rows(jnp.asarray(table), jnp.asarray(ids)))
        want = table[ids]
        np.testing.assert_array_equal(got, want)


def test_gather_rows_under_jit_and_grad():
    table = jnp.arange(24.0, dtype=jnp.float32).reshape(8, 3)
    ids = jnp.asarray([0, 7, 3], jnp.int32)

    @jax.jit
    def f(tab):
        return gather_rows(tab, ids).sum()

    g = jax.grad(f)(table)
    # transpose of the one-hot gather is the scatter-add of ones
    want = np.zeros((8, 3), np.float32)
    for i in np.asarray(ids):
        want[i] += 1.0
    np.testing.assert_array_equal(np.asarray(g), want)


def test_gather_rows_large_table_fallback():
    rng = np.random.default_rng(1)
    t = ONEHOT_MAX_ROWS + 1
    table = rng.standard_normal((t, 4)).astype(np.float32)
    ids = rng.integers(0, t, size=(64,)).astype(np.int32)
    got = np.asarray(gather_rows(jnp.asarray(table), jnp.asarray(ids)))
    np.testing.assert_array_equal(got, table[ids])


def test_gather_rows_numpy_backend():
    table = np.arange(12.0, dtype=np.float32).reshape(4, 3)
    ids = np.asarray([2, 0], np.int32)
    got = gather_rows(table, ids)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, table[ids])


def test_gather_rows_nd_ids():
    table = jnp.arange(20.0, dtype=jnp.float32).reshape(5, 4)
    ids = jnp.asarray([[0, 1], [4, 2]], jnp.int32)
    got = gather_rows(table, ids)
    assert got.shape == (2, 2, 4)
    np.testing.assert_array_equal(
        np.asarray(got), np.asarray(table)[np.asarray(ids)]
    )


def test_gather_cols_spec():
    fat = jnp.arange(2 * 6.0, dtype=jnp.float32).reshape(2, 6)
    out = gather_cols(fat, [("a", 3), ("b", 1), ("c", 2)])
    assert out["a"].shape == (2, 3)
    assert out["b"].shape == (2,)
    assert out["c"].shape == (2, 2)
    np.testing.assert_array_equal(np.asarray(out["b"]), [3.0, 9.0])
