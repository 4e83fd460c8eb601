"""Multi-device sharding tests on the virtual 8-device CPU mesh:
sharded render == single-device render; sharded loss grads finite and
matching single-device grads (the gradient all-reduce path)."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from akari_tpu.diff.inverse import apply_params, scene_params
from akari_tpu.integrators.path import PathConfig, render
from akari_tpu.parallel.mesh import make_ray_mesh
from akari_tpu.parallel.render import loss_and_image_sharded, render_sharded
from akari_tpu.scene.builtin import cornell_box


@pytest.fixture(scope="module")
def setup():
    sc = cornell_box(12, 12)
    scene = sc.compile(intersector="bvh")
    return scene, sc.camera, PathConfig(spp=1, max_depth=1)


def test_eight_devices_available():
    assert jax.device_count() >= 8


def test_sharded_render_smoke_fast_tier(setup):
    """FAST-tier shard_map coverage: a seconds-scale
    2-device sharded render must equal the single-device render. The
    heavier 8-way + gradient variants stay in the slow tier."""
    scene, cam, cfg = setup
    mesh = make_ray_mesh(n_devices=2)
    img_sharded = np.asarray(render_sharded(scene, cam, cfg, mesh, seed=0))
    img_single = np.asarray(render(scene, cam, cfg, seed=0))
    np.testing.assert_allclose(img_sharded, img_single, rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_sharded_render_matches_single(setup):
    scene, cam, cfg = setup
    mesh = make_ray_mesh()
    img_sharded = np.asarray(render_sharded(scene, cam, cfg, mesh, seed=0))
    img_single = np.asarray(render(scene, cam, cfg, seed=0))
    np.testing.assert_allclose(img_sharded, img_single, rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_sharded_grads_match_single_device(setup):
    """North-star claim: gradients through the 8-way ray-sharded loss (grad
    all-reduce via the shard_map transpose) equal the plain single-device
    gradients of the same estimator."""
    scene, cam, cfg = setup
    mesh8 = make_ray_mesh()
    target = jnp.full((12, 12, 3), 0.25, jnp.float32)
    params = scene_params(scene)
    n3 = 12 * 12 * 3

    def loss_sharded(params):
        s = apply_params(scene, params)
        loss, _ = loss_and_image_sharded(s, cam, cfg, mesh8, target, seed=0)
        return loss

    def loss_plain(params):
        s = apply_params(scene, params)
        img = render(s, cam, cfg, seed=0)
        return jnp.sum((img - target) ** 2) / n3

    l8, g8 = jax.value_and_grad(loss_sharded)(params)
    l1, g1 = jax.value_and_grad(loss_plain)(params)
    np.testing.assert_allclose(float(l8), float(l1), rtol=1e-5)
    for k in g8:
        np.testing.assert_allclose(
            np.asarray(g8[k]), np.asarray(g1[k]), rtol=1e-4, atol=1e-6
        )
    # gradients actually flow into textures (albedo/emitter radiance)
    assert float(jnp.abs(g8["tex_value"]).sum()) > 0.0


@pytest.mark.slow
def test_sharded_bdpt_and_ao(setup):
    """BDPT and AO also render through the sharded path."""
    from akari_tpu.integrators.ao import AOConfig, render_ao
    from akari_tpu.integrators.bdpt import BDPTConfig, render_bdpt

    scene, cam, _ = setup
    mesh = make_ray_mesh(n_devices=4)
    cfg_b = BDPTConfig(spp=1, eye_depth=2, light_depth=1)
    img_s = np.asarray(render_sharded(scene, cam, cfg_b, mesh, seed=0))
    img_1 = np.asarray(render_bdpt(scene, cam, cfg_b, seed=0))
    np.testing.assert_allclose(img_s, img_1, rtol=1e-5, atol=1e-5)

    cfg_a = AOConfig(spp=2)
    img_s = np.asarray(render_sharded(scene, cam, cfg_a, mesh, seed=0))
    img_1 = np.asarray(render_ao(scene, cam, cfg_a, seed=0))
    np.testing.assert_allclose(img_s, img_1, rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_sharded_loss_and_grads_smoke(setup):
    """Ungated smoke of loss_and_image_sharded + grads (the bench/entry
    path): loss finite, image matches plain render, texture grads nonzero."""
    scene, cam, cfg = setup
    mesh = make_ray_mesh(n_devices=4)
    target = jnp.zeros((12, 12, 3), jnp.float32)
    params = scene_params(scene)

    def f(params):
        s = apply_params(scene, params)
        loss, img = loss_and_image_sharded(s, cam, cfg, mesh, target, seed=0)
        return loss, img

    (loss, img), grads = jax.value_and_grad(f, has_aux=True)(params)
    assert np.isfinite(float(loss))
    img_plain = render(scene, cam, cfg, seed=0)
    np.testing.assert_allclose(
        np.asarray(img), np.asarray(img_plain), rtol=1e-5, atol=1e-5
    )
    assert float(jnp.abs(grads["tex_value"]).sum()) > 0.0
