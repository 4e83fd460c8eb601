"""Silhouette/visibility boundary-gradient tests (diff/boundary.py).

Setup: a small occluder quad between an area light and a diffuse floor;
the camera looks straight down at the shadow (the occluder is outside the
frustum, so the image changes ONLY through the moving shadow). Matched-
seed central finite differences of the rendered image then measure
exactly the visibility boundary term — which the interior-only tri_delta
gradient misses entirely.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from akari_tpu.core import transform as xform
from akari_tpu.diff.boundary import boundary_direct_term, build_edge_table
from akari_tpu.integrators.path import PathConfig, render
from akari_tpu.scene.arrays import make_camera
from akari_tpu.scene.nodes import (
    DiffuseMaterial, EmissiveMaterial, Mesh, Scene,
)


def _quad(center, half, axis_u, axis_v, mat, flip=False):
    c = np.asarray(center, np.float32)
    u = np.asarray(axis_u, np.float32) * half
    v = np.asarray(axis_v, np.float32) * half
    verts = np.stack([c - u - v, c + u - v, c + u + v, c - u + v])
    faces = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    if flip:
        faces = faces[:, ::-1]
    return Mesh(vertices=verts, indices=faces, materials=[mat])


def _shadow_scene(w=24, h=24):
    floor = _quad((0, 0, 0), 4.0, (1, 0, 0), (0, 0, -1), DiffuseMaterial((0.8,) * 3))
    # occluder: horizontal quad at height 1, off to +x (outside the frustum)
    occ = _quad((0.6, 1.0, 0), 0.15, (1, 0, 0), (0, 0, -1),
                DiffuseMaterial((0.5,) * 3))
    # area light: horizontal quad at height 1.9 further out, emitting DOWN
    light = _quad((1.2, 1.9, 0), 0.2, (1, 0, 0), (0, 0, 1),
                  EmissiveMaterial((30.0,) * 3))
    cam = make_camera(
        xform.translate((0.0, 2.0, 0.0)) @ xform.rotate_x(np.radians(-90.0)),
        22.0, w, h,
    )
    sc = Scene(shapes=[floor, occ, light], camera=cam)
    return sc


def _occluder_mask(scene):
    """[T,3] unit +x direction on the occluder's storage triangles."""
    v0 = np.asarray(scene.tri_v0)
    c = v0 + (np.asarray(scene.tri_e1) + np.asarray(scene.tri_e2)) / 3.0
    occ = (np.abs(c[:, 1] - 1.0) < 0.2)
    m = np.zeros_like(v0)
    m[occ, 0] = 1.0
    return m, occ


@pytest.mark.slow
def test_boundary_gradient_matches_finite_difference():
    sc = _shadow_scene()
    cam = sc.camera
    cfg = PathConfig(spp=48, max_depth=1, ray_clamp=0.0)
    scene = sc.compile(intersector="bvh")
    edge_table = build_edge_table(scene)
    mask, occ_rows = _occluder_mask(scene)
    assert occ_rows.sum() == 2
    mask_j = jnp.asarray(mask)

    from akari_tpu.diff.inverse import apply_params

    def image(alpha):
        s = apply_params(scene, {"tex_value": scene.textures.value,
                                 "tri_delta": alpha * mask_j})
        return render(s, cam, cfg, seed=0)

    # matched-seed central FD: the visibility flips are the boundary term
    h = 0.02
    fd = 0.0
    for fd_seed in (0, 1):
        def image_s(alpha, s=fd_seed):
            sc_ = apply_params(scene, {"tex_value": scene.textures.value,
                                       "tri_delta": alpha * mask_j})
            return render(sc_, cam, cfg, seed=s)
        img_p = np.asarray(image_s(jnp.float32(h)))
        img_m = np.asarray(image_s(jnp.float32(-h)))
        fd += (img_p.mean() - img_m.mean()) / (2 * h) / 2.0

    def mean_with_boundary(alpha):
        s = apply_params(scene, {"tex_value": scene.textures.value,
                                 "tri_delta": alpha * mask_j})
        img = render(s, cam, cfg, seed=0)
        bnd = jnp.zeros((cam.width * cam.height, 3), jnp.float32)
        for si in range(16):
            bnd = bnd + boundary_direct_term(
                s, cam, alpha * mask_j, edge_table, seed=0,
                edge_samples=4, sample_idx=si,
            ) / 16.0
        return jnp.mean(img + bnd.reshape(cam.height, cam.width, 3))

    g_total = float(jax.grad(mean_with_boundary)(jnp.float32(0.0)))

    def mean_interior(alpha):
        s = apply_params(scene, {"tex_value": scene.textures.value,
                                 "tri_delta": alpha * mask_j})
        return jnp.mean(render(s, cam, cfg, seed=0))

    g_interior = float(jax.grad(mean_interior)(jnp.float32(0.0)))

    # the shadow boundary dominates: FD is clearly nonzero
    assert abs(fd) > 1e-3, fd
    # interior-only misses it (the documented failure of the r3 gradients)
    assert abs(g_interior - fd) > 0.5 * abs(fd), (g_interior, fd)
    # interior + boundary matches FD to 10%
    assert abs(g_total - fd) / abs(fd) < 0.10, (g_total, fd, g_interior)


def test_boundary_term_primal_zero():
    """The surrogate's primal value is exactly zero (it only carries
    tangents) — adding it never changes a rendered image."""
    sc = _shadow_scene(8, 8)
    scene = sc.compile(intersector="bvh")
    et = build_edge_table(scene)
    td = jnp.zeros_like(jnp.asarray(scene.tri_v0))
    out = boundary_direct_term(scene, sc.camera, td, et, seed=0, edge_samples=2)
    np.testing.assert_array_equal(np.asarray(out), 0.0)


def test_edge_table_dedup_and_exclusions():
    sc = _shadow_scene(8, 8)
    scene = sc.compile(intersector="bvh")
    et = build_edge_table(scene)
    # 2 quads (floor+occluder) x 2 tris x 3 edges = 12 slots, minus 2
    # shared diagonals counted once -> 10 unique edges; light excluded.
    assert et.a.shape[0] == 10
    assert (np.asarray(et.tri2) >= 0).sum() == 2  # the two shared diagonals


def _mirror_shadow_scene(w=20, h=20):
    """The occluder's shadow is visible ONLY via a mirror: camera looks at
    a mirror wall; the reflected view sees the shadowed floor patch.
    Geometry tuned for edge-sample acceptance (occluder near a large
    light: the edge->light-plane projection lands on the light often)."""
    from akari_tpu.scene.nodes import MirrorMaterial

    floor = _quad((0.75, 0, 0), 3.0, (1, 0, 0), (0, 0, -1),
                  DiffuseMaterial((0.8,) * 3))
    mirror = _quad((-1.5, 0.75, 0), 1.2, (0, 0, 1), (0, 1, 0),
                   MirrorMaterial((0.95,) * 3))
    occ = _quad((1.4, 1.5, 0), 0.3, (1, 0, 0), (0, 0, -1),
                DiffuseMaterial((0.5,) * 3))
    light = _quad((1.5, 1.9, 0), 0.8, (1, 0, 0), (0, 0, 1),
                  EmissiveMaterial((8.0,) * 3))
    # camera at (1.5, 1.5, 0) aimed at the mirror point (-1.5, 0.75, 0):
    # the reflected chief ray lands on the floor near x ~ 1.5 (under the
    # light and behind the occluder); the floor itself is OUTSIDE the
    # 16-degree frustum, so the image changes only through the mirror.
    fwd = np.asarray([-3.0, -0.75, 0.0])
    fwd = fwd / np.linalg.norm(fwd)
    up = np.asarray([0.0, 1.0, 0.0])
    right = np.cross(fwd, up); right /= np.linalg.norm(right)
    up2 = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, up2, -fwd
    c2w[:3, 3] = (1.5, 1.5, 0.0)
    cam = make_camera(c2w, 16.0, w, h)
    return Scene(shapes=[floor, mirror, occ, light], camera=cam)


@pytest.mark.slow
def test_indirect_boundary_gradient_matches_finite_difference():
    """Visibility boundary gradients for an
    occluder that affects ONLY indirect light (a mirror-bounced shadow).
    boundary_term(max_bounce=1) walks the specular prefix and edge-
    samples the NEE boundary at the reflected vertex.

    Statistical note: the indirect estimator's edge->light projection
    acceptance is a few percent, so at test-budget sample counts its
    standard error is ~15-20% of the signal. The assertions here are a
    ~3-sigma band around FD (the tight 10% anchor remains the direct
    test above); the decisive claim is that the interior-only gradient
    reads ZERO while interior+boundary recovers the FD signal."""
    from akari_tpu.diff.boundary import boundary_term

    sc = _mirror_shadow_scene()
    cam = sc.camera
    cfg = PathConfig(spp=64, max_depth=2, ray_clamp=0.0)
    scene = sc.compile(intersector="bvh")
    edge_table = build_edge_table(scene)
    v0 = np.asarray(scene.tri_v0)
    c = v0 + (np.asarray(scene.tri_e1) + np.asarray(scene.tri_e2)) / 3.0
    areas = 0.5 * np.linalg.norm(
        np.cross(np.asarray(scene.tri_e1), np.asarray(scene.tri_e2)), axis=-1
    )
    occ_rows = (np.abs(c[:, 1] - 1.5) < 0.1) & (areas < 0.5)
    assert occ_rows.sum() == 2
    mask = np.zeros_like(v0)
    mask[occ_rows, 0] = 1.0
    mask_j = jnp.asarray(mask)

    from akari_tpu.diff.inverse import apply_params

    h = 0.02
    fd = 0.0
    for fd_seed in (0, 1, 2, 3):
        def image_s(alpha, s=fd_seed):
            sc_ = apply_params(scene, {"tex_value": scene.textures.value,
                                       "tri_delta": alpha * mask_j})
            return render(sc_, cam, cfg, seed=s)
        img_p = np.asarray(image_s(jnp.float32(h)))
        img_m = np.asarray(image_s(jnp.float32(-h)))
        fd += (img_p.mean() - img_m.mean()) / (2 * h) / 4.0

    @jax.jit
    def bnd_grad(si):
        def f(alpha):
            b = boundary_term(
                scene, cam, alpha * mask_j, edge_table, seed=0,
                edge_samples=8, sample_idx=si, max_bounce=1,
            )
            return jnp.mean(b.reshape(cam.height, cam.width, 3))
        return jax.grad(f)(jnp.float32(0.0))

    g_bnd = float(np.mean([float(bnd_grad(jnp.uint32(si)))
                           for si in range(96)]))

    def mean_interior(alpha):
        s = apply_params(scene, {"tex_value": scene.textures.value,
                                 "tri_delta": alpha * mask_j})
        return jnp.mean(render(s, cam, cfg, seed=0))

    g_interior = float(jax.grad(mean_interior)(jnp.float32(0.0)))

    # the mirror-bounced shadow boundary is the ONLY image change
    assert abs(fd) > 1e-3, fd
    # interior-only misses it entirely
    assert abs(g_interior - fd) > 0.5 * abs(fd), (g_interior, fd)
    # interior + indirect boundary recovers the FD signal (3-sigma band)
    ratio = (g_interior + g_bnd) / fd
    assert 0.45 < ratio < 1.55, (g_bnd, fd, g_interior, ratio)
