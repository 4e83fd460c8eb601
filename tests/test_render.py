"""End-to-end render tests: JAX (device path) vs NumPy oracle on matched seeds,
BVH vs brute-force equivalence, and basic physical sanity (white furnace).

Comparison policy. Per-sample radiance from the *same program shape*
matches the oracle to tight f32 tolerance on every lane (decision parity:
same prims hit, same occlusion outcomes — verified in
test_decision_parity_with_oracle). Across *different* compiled programs
(e.g. the fully fused ``render`` vs the oracle), XLA's fusion/FMA choices
perturb geometry by ~1 ulp, which flips a handful of knife-edge
intersection decisions (rays grazing triangle edges); those lanes get a
legitimately different — unbiased — sample. End-to-end image comparisons
therefore allow a small fraction of outlier pixels while bounding the
mean error tightly (catching any systematic bias).
"""

import numpy as np
import jax
import jax.numpy as jnp

from akari_tpu.integrators import path as path_mod
from akari_tpu.integrators.path import PathConfig, render
from akari_tpu.oracle.renderer import render_oracle
from akari_tpu.scene.builtin import cornell_box


def _small_scene(intersector="brute", res=24):
    sc = cornell_box(res, res)
    return sc.compile(intersector=intersector), sc.camera


from _imgcmp import assert_images_match  # noqa: E402 (shared helper)


def _per_sample_jax(scene, cam, cfg, seed, spp):
    """Mean of per-sample trace_paths calls — same program shape as the
    oracle's sample loop, so lanes match to f32 tolerance (no fusion skew)."""
    n = cam.width * cam.height

    @jax.jit
    def one(s):
        ifn, ofn, ffn = path_mod._jax_intersectors_soa(scene)
        px = jnp.arange(n, dtype=jnp.uint32)
        sx = jnp.full(n, s, jnp.uint32)
        return path_mod.trace_paths(
            scene, cam, cfg, jnp.uint32(seed), sx, px, ifn, ofn, jnp,
            fused_fn=ffn,
        )

    acc = sum(np.asarray(one(s), np.float64) for s in range(spp)) / spp
    return acc.reshape(cam.height, cam.width, 3)


def test_jax_matches_oracle_matched_seeds():
    """BASELINE north-star correctness: allclose images on matched seeds."""
    cfg = PathConfig(spp=2, max_depth=3, mis=True)
    scene, cam = _small_scene("brute")
    img_jax = _per_sample_jax(scene, cam, cfg, 0, cfg.spp)
    img_orc = render_oracle(scene, cam, cfg, seed=0)
    assert img_jax.shape == img_orc.shape
    # like-for-like programs: tight tolerance, tiny outlier budget
    assert_images_match(
        img_jax, img_orc, outlier_frac=0.005, mean_tol=2e-4
    )


def test_full_render_matches_oracle_with_outlier_budget():
    """The fully fused ``render`` against the oracle (see module doc)."""
    cfg = PathConfig(spp=2, max_depth=3, mis=True)
    scene, cam = _small_scene("brute")
    img_jax = np.asarray(jax.jit(render, static_argnums=(2, 3))(scene, cam, cfg, 0))
    img_orc = render_oracle(scene, cam, cfg, seed=0)
    assert_images_match(
        img_jax, img_orc, outlier_frac=0.08, mean_tol=3e-3
    )


def test_decision_parity_with_oracle():
    """Matched seeds -> matched decisions: identical camera-hit prims/valid
    between the jitted JAX path and the NumPy oracle intersector."""
    from akari_tpu.oracle.renderer import _intersect_brute_np, _to_numpy
    from akari_tpu.ops.intersect import T_MAX

    scene, cam = _small_scene("brute")
    n = cam.width * cam.height
    scn_np = _to_numpy(scene)

    px = np.arange(n, dtype=np.uint32)
    sx = np.zeros(n, np.uint32)
    o_np, d_np = path_mod.camera_rays(cam, 0, sx, px, np)
    _, prim_np, _, _, valid_np = _intersect_brute_np(
        scn_np, o_np, d_np, np.zeros(n, np.float32), np.full(n, T_MAX, np.float32)
    )

    @jax.jit
    def jax_hit():
        ifn, _, _ = path_mod._jax_intersectors_soa(scene)
        o, d = path_mod.camera_rays_soa(
            cam, 0, jnp.asarray(sx), jnp.asarray(px), jnp
        )
        t, prim, u, v, valid = ifn(o, d)
        return prim, valid

    prim_j, valid_j = map(np.asarray, jax_hit())
    assert (valid_np == valid_j).mean() > 0.999
    same = valid_np & valid_j
    assert (prim_np[same] == prim_j[same]).mean() > 0.999


def test_bvh_matches_brute_render():
    cfg = PathConfig(spp=2, max_depth=3, mis=True)
    scene_b, cam = _small_scene("brute")
    scene_v, _ = _small_scene("bvh")
    img_b = np.asarray(render(scene_b, cam, cfg, seed=0))
    img_v = np.asarray(render(scene_v, cam, cfg, seed=0))
    assert_images_match(img_b, img_v, rtol=1e-4, atol=1e-4,
                        outlier_frac=0.02, mean_tol=5e-4)


def test_nee_only_mode_matches_oracle():
    """mis=False reproduces the reference's NEE-only estimator path."""
    cfg = PathConfig(spp=2, max_depth=2, mis=False)
    scene, cam = _small_scene("brute")
    img_jax = _per_sample_jax(scene, cam, cfg, 1, cfg.spp)
    img_orc = render_oracle(scene, cam, cfg, seed=1)
    assert_images_match(img_jax, img_orc, outlier_frac=0.005, mean_tol=2e-4)


def test_render_nontrivial_and_finite():
    cfg = PathConfig(spp=2, max_depth=3)
    scene, cam = _small_scene("bvh")
    img = np.asarray(render(scene, cam, cfg, seed=0))
    assert np.all(np.isfinite(img))
    assert float(img.mean()) > 0.01  # light reaches the film
    # red wall on the left, green on the right (row through the middle)
    mid = img[img.shape[0] // 2]
    left, right = mid[1], mid[-2]
    assert left[0] > left[1]    # left wall reddish
    assert right[1] > right[0]  # right wall greenish


def test_mis_and_nee_converge_to_same_image():
    """Both estimators are unbiased: with enough samples they agree."""
    scene, cam = _small_scene("brute", res=12)
    img_mis = np.asarray(
        render(scene, cam, PathConfig(spp=64, max_depth=2, mis=True), seed=3)
    )
    img_nee = np.asarray(
        render(scene, cam, PathConfig(spp=64, max_depth=2, mis=False), seed=4)
    )
    # agreement in the mean (loose MC tolerance)
    assert abs(float(img_mis.mean() - img_nee.mean())) < 0.05 * max(
        float(img_mis.mean()), 1e-3
    ) + 0.02


def test_unrolled_matches_scan():
    """PathConfig(unroll=True) — the megakernel-mode variant the r5 bench
    step uses — must produce the same radiance as the lax.scan wavefront
    (same per-bounce math; only the program structure differs)."""
    import dataclasses

    from akari_tpu.scene.builtin import cornell_box

    sc = cornell_box(12, 12)
    scene = sc.compile(intersector="bvh")
    cfg = PathConfig(spp=2, max_depth=3)
    img_scan = np.asarray(render(scene, sc.camera, cfg, seed=0))
    img_unroll = np.asarray(
        render(scene, sc.camera,
               dataclasses.replace(cfg, unroll=True, remat=False), seed=0)
    )
    np.testing.assert_allclose(img_scan, img_unroll, rtol=1e-5, atol=1e-6)
