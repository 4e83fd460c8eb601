"""Tests that need a CUDA device: the dense Pallas kernel compiled for the
card (it has no CPU lowering outside interpret mode) and the GPU routing
table on real hardware. They skip, from a fixture, where JAX finds no GPU;
run them on a GPU machine with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from akari_tpu.ops.intersect import intersect, occlude
from akari_tpu.scene.builtin import cornell_box, terrain_scene
from akari_tpu.scene.nodes import DENSE_MAX_TRIS, GPU_DENSE_INTERSECTOR

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA device")


def _rays(n, seed=0):
    r = np.random.default_rng(seed)
    o = r.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], size=(n, 3))
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


def test_compiled_dense_kernel_matches_brute(gpu):
    scene = cornell_box(16, 16).compile(intersector="pallas")
    brute = dataclasses.replace(scene, intersector="brute")
    o, d = _rays(1 << 16)
    hp, hb = intersect(scene, o, d), intersect(brute, o, d)
    vp, vb = np.asarray(hp.valid), np.asarray(hb.valid)
    same = (vp == vb) & (np.asarray(hp.prim) == np.asarray(hb.prim))
    # float32 rounding may flip a handful of rays grazing an edge
    assert same.mean() > 0.999
    ok = same & vb
    np.testing.assert_allclose(
        np.asarray(hp.t)[ok], np.asarray(hb.t)[ok], rtol=1e-5
    )
    t_max = jnp.full((1 << 16,), 1.0, jnp.float32)
    op = np.asarray(occlude(scene, o, d, 0.0, t_max))
    ob = np.asarray(occlude(brute, o, d, 0.0, t_max))
    assert (op == ob).mean() > 0.999


def test_auto_routes_on_gpu(gpu):
    small = cornell_box(8, 8).compile(intersector="auto")
    assert small.intersector == GPU_DENSE_INTERSECTOR
    big = terrain_scene(8, 8, n=182).compile(intersector="auto")
    assert big.n_tris > DENSE_MAX_TRIS and big.intersector == "bvh"
