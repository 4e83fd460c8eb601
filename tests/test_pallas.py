"""Dense Pallas intersection kernel (interpreter mode on CPU; the kernel
compiled for the GPU is checked by tests/test_gpu.py and chip_smoke.py),
and the XLA BVH walk that serves scenes above the dense threshold."""

import numpy as np
import jax.numpy as jnp
import pytest

import akari_tpu.ops.pallas_intersect as pi
from akari_tpu.ops.intersect import intersect, occlude
from akari_tpu.scene.builtin import cornell_box


@pytest.fixture(autouse=True)
def interpret_mode():
    old = pi.INTERPRET
    pi.INTERPRET = True
    yield
    pi.INTERPRET = old


def _orig_prim(scene, hit):
    """Storage prim ids -> original triangle ids (SBVH copies collapse)."""
    prim = np.asarray(hit.prim)
    mapped = np.asarray(scene.prim_to_orig)[np.maximum(prim, 0)]
    return np.where(np.asarray(hit.valid), mapped, -1)


def _rays(n, seed=3):
    r = np.random.default_rng(seed)
    o = np.asarray([0.0, 1.0, 4.0], np.float32) + r.normal(
        scale=0.2, size=(n, 3)
    ).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_pallas_matches_brute():
    scene_p = cornell_box(16, 16).compile(intersector="pallas")
    scene_b = cornell_box(16, 16).compile(intersector="brute")
    o, d = _rays(300)
    hp = intersect(scene_p, o, d)
    hb = intersect(scene_b, o, d)
    np.testing.assert_array_equal(np.asarray(hp.valid), np.asarray(hb.valid))
    np.testing.assert_array_equal(_orig_prim(scene_p, hp), _orig_prim(scene_b, hb))
    ok = np.asarray(hb.valid)
    np.testing.assert_allclose(
        np.asarray(hp.t)[ok], np.asarray(hb.t)[ok], rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(hp.uv)[ok], np.asarray(hb.uv)[ok], rtol=1e-4, atol=1e-5
    )


def test_pallas_occlude_matches_brute():
    scene_p = cornell_box(16, 16).compile(intersector="pallas")
    scene_b = cornell_box(16, 16).compile(intersector="brute")
    o, d = _rays(300, seed=5)
    op = occlude(scene_p, o, d, 0.0, 1e30)
    ob = occlude(scene_b, o, d, 0.0, 1e30)
    np.testing.assert_array_equal(np.asarray(op), np.asarray(ob))


def test_pallas_closest_honors_t_max():
    """Regression: closest-hit must not report hits beyond per-ray t_max —
    the fused shadow+extension launch (integrators/path.py) reads
    ``h.valid`` of a t_max-bounded query as the occlusion answer."""
    scene_p = cornell_box(16, 16).compile(intersector="pallas")
    scene_b = cornell_box(16, 16).compile(intersector="brute")
    o, d = _rays(300, seed=7)
    hb = intersect(scene_b, o, d)
    t_ref = np.asarray(hb.t)
    valid_ref = np.asarray(hb.valid)
    # cut half the rays short of their own hit distance
    t_max = np.where(
        np.arange(300) % 2 == 0, t_ref * 0.5, np.full(300, 1e30)
    ).astype(np.float32)
    hp = intersect(scene_p, o, d, t_max=jnp.asarray(t_max))
    hb2 = intersect(scene_b, o, d, t_max=jnp.asarray(t_max))
    np.testing.assert_array_equal(
        np.asarray(hp.valid), np.asarray(hb2.valid)
    )
    # even-index valid rays must now be misses
    assert not np.any(np.asarray(hp.valid)[::2] & valid_ref[::2])


def test_pallas_ray_padding():
    """Ray counts off the block size are padded with never-hit rays."""
    scene_p = cornell_box(16, 16).compile(intersector="pallas")
    scene_b = cornell_box(16, 16).compile(intersector="brute")
    o, d = _rays(77)
    h = intersect(scene_p, o, d)
    assert h.t.shape == (77,)
    np.testing.assert_array_equal(
        np.asarray(h.prim), np.asarray(intersect(scene_b, o, d).prim)
    )


def test_native_bvh_builder_matches_python():
    from akari_tpu.bvh.build import MAX_LEAF, build_bvh
    from akari_tpu.native.loader import native_available

    if not native_available():
        pytest.skip("no C++ toolchain")
    r = np.random.default_rng(0)
    n = 5000
    base = r.uniform(-5, 5, size=(n, 1, 3))
    tris = (base + r.normal(scale=0.2, size=(n, 3, 3))).astype(np.float32)
    bvh, order = build_bvh(tris[:, 0], tris[:, 1], tris[:, 2], use_native=True)
    # invariants
    leaf = bvh["count"] > 0
    covered = np.concatenate(
        [np.arange(f, f + c) for f, c in zip(bvh["first"][leaf], bvh["count"][leaf])]
    )
    assert sorted(covered.tolist()) == list(range(n))
    assert bvh["count"].max() <= MAX_LEAF
    assert sorted(order.tolist()) == list(range(n))
    m = bvh["first"].shape[0]
    assert bvh["miss"].min() >= -1 and bvh["miss"].max() < m
    assert np.all(bvh["node_lo"] <= bvh["node_hi"])

    # traversal over the native-built BVH matches brute force
    import jax.numpy as jnp

    from akari_tpu.ops.intersect import intersect
    from akari_tpu.scene.nodes import Mesh, compile_scene

    verts = tris.reshape(-1, 3)
    idx = np.arange(verts.shape[0]).reshape(-1, 3)
    mesh = Mesh(vertices=verts, indices=idx)
    # compile_scene uses auto selection; force a small scene through native
    import akari_tpu.scene.nodes as nodes_mod

    orig = nodes_mod.build_bvh
    try:
        nodes_mod.build_bvh = lambda p0, p1, p2: orig(p0, p1, p2, use_native=True)
        scene_n = compile_scene([mesh], intersector="bvh")
    finally:
        nodes_mod.build_bvh = orig
    scene_b = compile_scene([mesh], intersector="brute")
    rr = np.random.default_rng(1)
    o = jnp.asarray(rr.uniform(-6, 6, size=(256, 3)).astype(np.float32))
    d = rr.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = jnp.asarray(d)
    hn = intersect(scene_n, o, d)
    hb = intersect(scene_b, o, d)
    # native and python builders order triangles differently, so compare
    # hit distances + validity (prim ids live in different permutations)
    np.testing.assert_array_equal(np.asarray(hn.valid), np.asarray(hb.valid))
    np.testing.assert_allclose(
        np.asarray(hn.t), np.asarray(hb.t), rtol=1e-5, atol=1e-4
    )


def _random_tri_scene(n_tri, seed=9, spread=4, size=0.15):
    from akari_tpu.scene.nodes import Mesh

    r = np.random.default_rng(seed)
    base = r.uniform(-spread, spread, size=(n_tri, 1, 3))
    tris = (base + r.normal(scale=size, size=(n_tri, 3, 3))).astype(np.float32)
    verts = tris.reshape(-1, 3)
    idx = np.arange(verts.shape[0]).reshape(-1, 3)
    return Mesh(vertices=verts, indices=idx)


def _random_rays(nr, seed=2, spread=5):
    rr = np.random.default_rng(seed)
    o = jnp.asarray(rr.uniform(-spread, spread, size=(nr, 3)).astype(np.float32))
    d = rr.normal(size=(nr, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, jnp.asarray(d)


def _assert_hits_match(scene_p, hp, hb, atol=1e-5):
    np.testing.assert_array_equal(np.asarray(hp.valid), np.asarray(hb.valid))
    np.testing.assert_array_equal(_orig_prim(scene_p, hp), _orig_prim(scene_p, hb))
    ok = np.asarray(hb.valid)
    np.testing.assert_allclose(
        np.asarray(hp.t)[ok], np.asarray(hb.t)[ok], rtol=1e-5, atol=atol
    )


def _bounded(hb, n):
    """t_max cutting every other ray at half its own hit distance."""
    t_ref = np.asarray(hb.t)
    return jnp.asarray(np.where(
        np.arange(n) % 2 == 0, t_ref * 0.5, np.full(n, 1e30)
    ).astype(np.float32))


def test_dense_kernel_many_triangles_closest():
    """~1k random triangles: the in-program triangle loop runs 1k steps
    over every ray block; closest hits (and bounded closest hits, the
    fused shadow+extension contract) match brute force exactly."""
    from akari_tpu.scene.nodes import compile_scene

    mesh = _random_tri_scene(1000, seed=21, spread=2, size=0.3)
    scene_p = compile_scene([mesh], intersector="pallas")
    scene_b = compile_scene([mesh], intersector="brute")
    o, d = _random_rays(300, seed=8, spread=3)
    hb = intersect(scene_b, o, d)
    assert np.asarray(hb.valid).sum() > 100
    _assert_hits_match(scene_p, intersect(scene_p, o, d), hb)
    t_max = _bounded(hb, 300)
    _assert_hits_match(
        scene_p, intersect(scene_p, o, d, t_max=t_max),
        intersect(scene_b, o, d, t_max=t_max),
    )


def test_dense_kernel_many_triangles_anyhit():
    from akari_tpu.scene.nodes import compile_scene

    mesh = _random_tri_scene(1000, seed=22, spread=2, size=0.3)
    scene_p = compile_scene([mesh], intersector="pallas")
    scene_b = compile_scene([mesh], intersector="brute")
    o, d = _random_rays(300, seed=9, spread=3)
    t_max = _bounded(intersect(scene_b, o, d), 300)
    for tm in (1e30, t_max):
        op = np.asarray(occlude(scene_p, o, d, 0.0, tm))
        ob = np.asarray(occlude(scene_b, o, d, 0.0, tm))
        np.testing.assert_array_equal(op, ob)
    assert 0 < op.sum() < 300


def test_dense_kernel_tie_goes_to_lowest_index():
    """Two copies of every triangle: equal-t hits must report the lower
    storage index, the brute-force oracle's tie rule."""
    import dataclasses

    scene_b = cornell_box(16, 16).compile(intersector="brute")
    dup = {
        k: np.concatenate([np.asarray(getattr(scene_b, k))] * 2)
        for k in ("tri_v0", "tri_e1", "tri_e2")
    }
    scene_p = dataclasses.replace(scene_b, intersector="pallas", **dup)
    scene_b2 = dataclasses.replace(scene_b, **dup)
    o, d = _rays(300, seed=12)
    hp, hb = intersect(scene_p, o, d), intersect(scene_b2, o, d)
    ok = np.asarray(hb.valid)
    np.testing.assert_array_equal(np.asarray(hp.valid), ok)
    np.testing.assert_array_equal(np.asarray(hp.prim), np.asarray(hb.prim))
    assert np.all(np.asarray(hp.prim)[ok] < scene_b.n_tris)


def test_bvh_matches_brute_mid_size_scene():
    """The XLA BVH walk on a 6k-triangle random scene (above the dense
    threshold, so the GPU route) vs brute force: hits and occlusion."""
    from akari_tpu.scene.nodes import compile_scene

    mesh = _random_tri_scene(6000, seed=13)
    scene_v = compile_scene([mesh], intersector="bvh")
    scene_b = compile_scene([mesh], intersector="brute")
    o, d = _random_rays(256, seed=4)
    hv, hb = intersect(scene_v, o, d), intersect(scene_b, o, d)
    np.testing.assert_array_equal(np.asarray(hv.valid), np.asarray(hb.valid))
    np.testing.assert_array_equal(_orig_prim(scene_v, hv), _orig_prim(scene_b, hb))
    ok = np.asarray(hb.valid)
    np.testing.assert_allclose(
        np.asarray(hv.t)[ok], np.asarray(hb.t)[ok], rtol=1e-5, atol=1e-5
    )
    np.testing.assert_array_equal(
        np.asarray(occlude(scene_v, o, d, 0.0, 1e30)),
        np.asarray(occlude(scene_b, o, d, 0.0, 1e30)),
    )


def test_bvh_honors_t_max_mid_size_scene():
    """Bounded queries on the BVH walk (shadow rays on large scenes)."""
    from akari_tpu.scene.nodes import compile_scene

    mesh = _random_tri_scene(6000, seed=17)
    scene_v = compile_scene([mesh], intersector="bvh")
    scene_b = compile_scene([mesh], intersector="brute")
    o, d = _random_rays(160, seed=6)
    hb = intersect(scene_b, o, d)
    t_max = _bounded(hb, 160)
    hv2 = intersect(scene_v, o, d, t_max=t_max)
    hb2 = intersect(scene_b, o, d, t_max=t_max)
    np.testing.assert_array_equal(np.asarray(hv2.valid), np.asarray(hb2.valid))
    assert not np.any(np.asarray(hv2.valid)[::2] & np.asarray(hb.valid)[::2])
    np.testing.assert_array_equal(
        np.asarray(occlude(scene_v, o, d, 0.0, t_max)),
        np.asarray(occlude(scene_b, o, d, 0.0, t_max)),
    )
