"""Environment (dome) light: furnace closure, importance sampling,
estimator cross-agreement, and oracle parity.

A capability beyond the reference (it has no infinite lights) built on
the r4 HDR + continuous-CDF machinery.
"""

import numpy as np
import jax
import jax.numpy as jnp

from akari_tpu.core import transform as xform
from akari_tpu.core.v3 import V3
from akari_tpu.integrators.path import PathConfig, render
from akari_tpu.scene.arrays import make_camera
from akari_tpu.scene.nodes import (
    DiffuseMaterial, EmissiveMaterial, EnvMapLight, Mesh, Scene,
)
from akari_tpu.shading import soa


def _floor(albedo=1.0, y=0.0, half=50.0):
    v = np.asarray(
        [[-half, y, -half], [half, y, -half], [half, y, half],
         [-half, y, half]], np.float32,
    )
    f = np.asarray([[0, 2, 1], [0, 3, 2]], np.int32)  # +Y normal
    return Mesh(vertices=v, indices=f, materials=[DiffuseMaterial((albedo,) * 3)])


def _down_cam(w=16, h=16, height=1.0, fov=30.0):
    return make_camera(
        xform.translate((0.0, height, 0.0)) @ xform.rotate_x(np.radians(-90.0)),
        fov, w, h,
    )


def test_env_furnace_constant_sky():
    """Uniform env Le over a white (albedo 1) floor: every camera pixel
    looking at the floor converges to exactly Le (Lambert furnace), and
    rays that miss return Le directly."""
    Le = 0.6
    env = EnvMapLight(np.full((8, 16, 3), Le, np.float32))
    sc = Scene(shapes=[_floor(1.0)], camera=_down_cam(), environment=env)
    scene = sc.compile(intersector="bvh")
    assert scene.env_image is not None
    img = np.asarray(
        render(scene, sc.camera, PathConfig(spp=96, max_depth=2,
                                            ray_clamp=0.0), seed=0)
    )
    # unbiased: image mean within 1%, per-pixel within MC noise
    assert abs(img.mean() - Le) / Le < 0.01, img.mean()
    np.testing.assert_allclose(img, Le, rtol=0.12)
    # camera pointing up: pure miss = exact env radiance
    up_cam = make_camera(
        xform.translate((0.0, 1.0, 0.0)) @ xform.rotate_x(np.radians(90.0)),
        30.0, 8, 8,
    )
    img_up = np.asarray(
        render(scene, up_cam, PathConfig(spp=2, max_depth=2), seed=0)
    )
    np.testing.assert_allclose(img_up, Le, rtol=1e-4)


def _spot_env(scale=40.0):
    """Dark sky with one bright texel region high in +x."""
    img = np.full((16, 32, 3), 0.02, np.float32)
    img[3:5, 22:25] = scale  # a compact bright patch
    return EnvMapLight(img)


def test_env_importance_vs_bsdf_estimator():
    """NEE-with-env-CDF and BSDF-only sampling are independent unbiased
    estimators of the same scene: converged means agree. A wrong env pdf
    (mapping, sin-theta factor, mixture pmf) biases the NEE estimator."""
    sc = Scene(shapes=[_floor(0.8)], camera=_down_cam(),
               environment=_spot_env())
    scene = sc.compile(intersector="bvh")
    cfg_n = PathConfig(spp=160, max_depth=2, mis=True, ray_clamp=0.0)
    cfg_b = PathConfig(spp=640, max_depth=2, mis="bsdf", ray_clamp=0.0)
    m_n = float(np.mean(np.asarray(render(scene, sc.camera, cfg_n, seed=1))))
    m_b = float(np.mean(np.asarray(render(scene, sc.camera, cfg_b, seed=2))))
    assert abs(m_n - m_b) / max(m_b, 1e-9) < 0.06, (m_n, m_b)


def test_env_sample_histogram_matches_pmf():
    env = _spot_env()
    sc = Scene(shapes=[_floor(0.8)], camera=_down_cam(), environment=env)
    scene = sc.compile(intersector="bvh")
    n = 1 << 15
    u1 = (np.arange(n, dtype=np.float64) + 0.5) / n
    rngs = np.random.default_rng(0)
    u2 = rngs.random(n).astype(np.float32)
    wi, Le, pdf = soa.env_sample(scene, u1.astype(np.float32), u2)
    he, we = scene.env_image.shape[:2]
    u, v = soa.env_uv_of_dir(wi)
    xi = np.clip((np.asarray(u) * we).astype(int), 0, we - 1)
    yi = np.clip((np.asarray(v) * he).astype(int), 0, he - 1)
    hist = np.zeros(he * we)
    np.add.at(hist, yi * we + xi, 1.0)
    hist /= hist.sum()
    pmf = np.asarray(scene.env_pmf)
    # bright texels dominate: their observed frequency matches the pmf
    top = np.argsort(pmf)[-6:]
    np.testing.assert_allclose(hist[top], pmf[top], rtol=0.05)
    # round-trip: sampled directions map back to texels with pdf > 0
    assert (pmf[yi * we + xi] > 0).all()


def test_env_mixture_with_area_light():
    """Env + emissive quad together: the strategy mixture must stay
    unbiased (cross-check vs the BSDF-only estimator)."""
    emitter = Mesh(
        vertices=np.asarray(
            [[-0.4, 1.2, -0.4], [0.4, 1.2, -0.4], [0.4, 1.2, 0.4],
             [-0.4, 1.2, 0.4]], np.float32,
        ),
        indices=np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),  # -Y normal
        materials=[EmissiveMaterial((9.0, 9.0, 9.0))],
    )
    sc = Scene(shapes=[_floor(0.7), emitter], camera=_down_cam(height=0.8),
               environment=_spot_env(20.0))
    scene = sc.compile(intersector="bvh")
    p_sel = float(np.asarray(scene.env_p_select))
    assert 0.05 <= p_sel <= 0.95
    cfg_n = PathConfig(spp=200, max_depth=2, mis=True, ray_clamp=0.0)
    cfg_b = PathConfig(spp=800, max_depth=2, mis="bsdf", ray_clamp=0.0)
    m_n = float(np.mean(np.asarray(render(scene, sc.camera, cfg_n, seed=3))))
    m_b = float(np.mean(np.asarray(render(scene, sc.camera, cfg_b, seed=4))))
    assert abs(m_n - m_b) / max(m_b, 1e-9) < 0.08, (m_n, m_b)


def test_env_oracle_parity():
    from akari_tpu.oracle.renderer import render_oracle

    sc = Scene(shapes=[_floor(0.8)], camera=_down_cam(8, 8),
               environment=_spot_env())
    scene = sc.compile(intersector="brute")
    cfg = PathConfig(spp=4, max_depth=2, ray_clamp=0.0)
    img_j = np.asarray(render(scene, sc.camera, cfg, seed=0))
    img_o = render_oracle(scene, sc.camera, cfg, seed=0)
    np.testing.assert_allclose(img_j, img_o, rtol=2e-4, atol=2e-5)


def test_env_dir_uv_roundtrip():
    rngs = np.random.default_rng(1)
    d = rngs.normal(size=(256, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    v3 = V3(d[:, 0].astype(np.float32), d[:, 1].astype(np.float32),
            d[:, 2].astype(np.float32))
    u, v = soa.env_uv_of_dir(v3)
    theta = np.asarray(v) * np.pi
    phi = np.asarray(u) * 2 * np.pi - np.pi
    back = np.stack(
        [np.sin(theta) * np.sin(phi), np.cos(theta),
         -np.sin(theta) * np.cos(phi)], -1,
    )
    np.testing.assert_allclose(back, d, atol=1e-5)


def test_env_sdl_node(tmp_path):
    """EnvMap node through the .akari grammar end to end."""
    from akari_tpu.core.image import write_hdr
    from akari_tpu.scene import sdl

    write_hdr(str(tmp_path / "sky.hdr"), np.full((4, 8, 3), 0.5, np.float32))
    scene_file = tmp_path / "scene.akari"
    scene_file.write_text(
        'export scene = Scene {\n'
        '  camera: PerspectiveCamera { resolution: [8, 8], fov: 40 },\n'
        '  shapes: [],\n'
        '  environment: EnvMap { image: "sky.hdr", scale: 2.0 },\n'
        '}\n'
    )
    module = sdl.parse_file(str(scene_file))
    node = module.exports["scene"]
    assert node.environment is not None
    # empty shapes list: compile needs >= 0 tris; give it a floor
    node.shapes.append(_floor(0.5))
    scene = node.compile(intersector="bvh")
    np.testing.assert_allclose(np.asarray(scene.env_image), 0.5 * 2.0,
                               rtol=2e-2)


def test_env_on_instanced_scene_matches_flat():
    """Environment lights on INSTANCED scenes (closes the r4
    NotImplementedError): an env-lit two-level scene
    renders and matches the identical flattened scene. Only the env
    lights a diffuse floor here, so the sampler streams coincide across
    compiles and the images agree tightly."""
    from akari_tpu.scene.nodes import Instance

    env = _spot_env()
    proto = _floor(0.8, half=2.0)
    insts = [
        Instance(proto, np.asarray(xform.translate((dx, 0.0, 0.0)),
                                   np.float32))
        for dx in (-2.0, 2.0)
    ]
    cam = _down_cam(12, 12, height=2.0, fov=50.0)
    cfg = PathConfig(spp=4, max_depth=2)

    sc_i = Scene(shapes=insts, camera=cam, environment=env)
    scene_i = sc_i.compile(intersector="bvh")  # two-level
    assert scene_i.instances is not None and scene_i.env_image is not None
    sc_f = Scene(shapes=insts, camera=cam, environment=env)
    scene_f = sc_f.compile(intersector="brute")  # flattens instances
    assert scene_f.instances is None

    img_i = np.asarray(render(scene_i, cam, cfg, seed=0))
    img_f = np.asarray(render(scene_f, cam, cfg, seed=0))
    assert np.isfinite(img_i).all()
    np.testing.assert_allclose(img_i, img_f, rtol=1e-4, atol=1e-4)
