"""BDPT vs unidirectional path tracer: both are unbiased estimators of the
same transport, so converged images must agree."""

import numpy as np
import pytest

from akari_tpu.integrators.bdpt import BDPTConfig, render_bdpt
from akari_tpu.integrators.path import PathConfig, render
from akari_tpu.scene.builtin import cornell_box


@pytest.fixture(scope="module")
def setup():
    sc = cornell_box(10, 10)
    return sc, sc.compile(intersector="bvh")


def test_bdpt_matches_path_tracer(setup):
    sc, scene = setup
    # path length parity: PT max_depth=2 gives up to 3 surface vertices
    # (2 scatters); BDPT eye_depth=3 (3 eye vertices) + light_depth up to 2
    # covers the same path lengths.
    img_pt = np.asarray(
        render(scene, sc.camera, PathConfig(spp=96, max_depth=2, mis=True,
                                            ray_clamp=50.0), seed=0)
    )
    # max_vertices=3 matches PT max_depth=2 (3 surface vertices per path)
    img_bd = np.asarray(
        render_bdpt(scene, sc.camera,
                    BDPTConfig(spp=96, eye_depth=3, light_depth=2,
                               ray_clamp=50.0, max_vertices=3), seed=1)
    )
    assert np.all(np.isfinite(img_bd))
    m_pt, m_bd = float(img_pt.mean()), float(img_bd.mean())
    assert m_bd > 0.01
    # means agree within MC tolerance
    assert abs(m_pt - m_bd) < 0.12 * max(m_pt, m_bd), (m_pt, m_bd)
    # per-pixel agreement is looser (different estimators, finite spp)
    bright = img_pt.mean(-1) > 0.05
    rel = np.abs(img_bd - img_pt).mean(-1)[bright] / img_pt.mean(-1)[bright]
    assert float(np.median(rel)) < 0.5


def test_bdpt_weights_bounded(setup):
    """BDPT image must not blow up (weights in [0,1] keep variance sane)."""
    sc, scene = setup
    img = np.asarray(
        render_bdpt(scene, sc.camera,
                    BDPTConfig(spp=8, eye_depth=2, light_depth=2), seed=0)
    )
    assert np.all(np.isfinite(img))
    assert float(img.max()) < 60.0


@pytest.mark.slow
def test_bdpt_light_tracing_on_off_agree(setup):
    """t=1 splats + reweighted strategies keep the estimator unbiased:
    means with and without light tracing agree within MC tolerance."""
    import dataclasses

    sc, scene = setup
    cfg_on = BDPTConfig(spp=64, eye_depth=3, light_depth=3, ray_clamp=50.0)
    cfg_off = dataclasses.replace(cfg_on, light_tracing=False)
    a = np.asarray(render_bdpt(scene, sc.camera, cfg_on, seed=2))
    b = np.asarray(render_bdpt(scene, sc.camera, cfg_off, seed=3))
    assert np.all(np.isfinite(a)) and np.all(np.isfinite(b))
    ma, mb = float(a.mean()), float(b.mean())
    assert ma > 0.01
    assert abs(ma - mb) < 0.12 * max(ma, mb), (ma, mb)


def test_bdpt_jax_matches_numpy_oracle(setup):
    """BDPT is backend-generic: jnp and numpy runs on matched seeds agree."""
    import jax.numpy as jnp

    from akari_tpu.integrators.bdpt import trace_bdpt
    from akari_tpu.integrators.path import _jax_intersectors
    from akari_tpu.oracle.renderer import _intersect_brute_np, _to_numpy
    from akari_tpu.ops.intersect import T_MAX

    sc, _ = setup
    scene = sc.compile(intersector="brute")
    cfg = BDPTConfig(spp=1, eye_depth=2, light_depth=2)
    n = sc.camera.width * sc.camera.height
    pix = np.arange(n, dtype=np.uint32)

    intersect_fn, occlude_fn, _ = _jax_intersectors(scene)
    lj, sj = trace_bdpt(scene, sc.camera, cfg, 0, jnp.uint32(0),
                        jnp.asarray(pix), intersect_fn, occlude_fn, jnp)
    lj, sj = np.asarray(lj), np.asarray(sj)

    sn = _to_numpy(scene)

    def np_isect(o, d):
        t, prim, bu, bv, valid = _intersect_brute_np(
            sn, o, d, np.zeros(len(o), np.float32),
            np.full(len(o), T_MAX, np.float32),
        )
        return t, prim, np.stack([bu, bv], axis=-1), valid

    def np_occl(o, d, tmin, tmax):
        _, _, _, _, v = _intersect_brute_np(sn, o, d, tmin, tmax)
        return v

    ln, sn_splat = trace_bdpt(sn, sc.camera, cfg, np.uint32(0), np.uint32(0),
                              pix, np_isect, np_occl, np)
    # knife-edge outlier budget: see tests/_imgcmp.py (BDPT's many
    # visibility connections amplify 1-ulp jnp/np differences on a few lanes)
    from _imgcmp import assert_images_match

    assert_images_match(lj, ln, outlier_frac=0.04, mean_tol=2e-3)
    assert_images_match(sj, sn_splat, outlier_frac=0.04, mean_tol=2e-3)


def _glass_cornell():
    """Cornell box with the tall box swapped to glass (delta vertices in
    both subpaths)."""
    import dataclasses

    from akari_tpu.scene.nodes import GlassMaterial

    sc = cornell_box(10, 10)
    mesh = sc.shapes[0]
    mats = list(mesh.materials)
    # replace one diffuse wall material (not the emitter) with glass
    from akari_tpu.scene.nodes import DiffuseMaterial

    for i, m in enumerate(mats):
        if isinstance(m, DiffuseMaterial) and i >= 3:
            mats[i] = GlassMaterial(ior=1.5)
            break
    sc = dataclasses.replace(
        sc, shapes=[dataclasses.replace(mesh, materials=mats)]
    )
    return sc


def test_bdpt_glass_matches_path_tracer():
    """Delta-aware MIS: BDPT on a glass-bearing
    Cornell must agree with the unidirectional tracer — the r4
    DELTA_PDF=1e8 stand-in skewed the Veach recurrence at glass/mirror
    vertices; the r5 delta flags + remap0 make their densities cancel."""
    sc = _glass_cornell()
    scene = sc.compile(intersector="bvh")
    img_pt = np.asarray(
        render(scene, sc.camera, PathConfig(spp=128, max_depth=3, mis=True,
                                            ray_clamp=50.0), seed=0)
    )
    img_bd = np.asarray(
        render_bdpt(scene, sc.camera,
                    BDPTConfig(spp=128, eye_depth=4, light_depth=2,
                               max_vertices=4, ray_clamp=50.0), seed=1)
    )
    assert np.all(np.isfinite(img_bd))
    m_pt, m_bd = float(img_pt.mean()), float(img_bd.mean())
    assert m_bd > 0.01
    assert abs(m_pt - m_bd) < 0.12 * max(m_pt, m_bd), (m_pt, m_bd)


def test_bdpt_env_matches_path_tracer():
    """Environment lights in BDPT: an env-lit
    scene must no longer silently drop all environment illumination."""
    import dataclasses

    from akari_tpu.scene.nodes import (
        DiffuseMaterial, EnvMapLight, Mesh, Scene,
    )
    from akari_tpu.scene.arrays import make_camera
    from akari_tpu.core import transform as xform

    v = np.asarray(
        [[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]], np.float32
    )
    f = np.asarray([[0, 2, 1], [0, 3, 2]], np.int32)
    floor = Mesh(vertices=v, indices=f,
                 materials=[DiffuseMaterial((0.7, 0.7, 0.7))])
    env_img = np.full((8, 16, 3), 0.5, np.float32)
    env_img[1:3, 3:6] = 4.0  # a soft bright region
    cam = make_camera(
        xform.translate((0.0, 2.0, 0.0)) @ xform.rotate_x(np.radians(-75.0)),
        50.0, 12, 12,
    )
    sc = Scene(shapes=[floor], camera=cam,
               environment=EnvMapLight(env_img))
    scene = sc.compile(intersector="bvh")
    img_pt = np.asarray(
        render(scene, cam, PathConfig(spp=160, max_depth=2, mis=True),
               seed=0)
    )
    img_bd = np.asarray(
        render_bdpt(scene, cam,
                    BDPTConfig(spp=160, eye_depth=3, light_depth=2,
                               max_vertices=3), seed=1)
    )
    assert np.all(np.isfinite(img_bd))
    m_pt, m_bd = float(img_pt.mean()), float(img_bd.mean())
    assert m_bd > 0.05  # env illumination present, not dropped
    assert abs(m_pt - m_bd) < 0.12 * max(m_pt, m_bd), (m_pt, m_bd)
