"""Two-level TLAS/BLAS instancing: traversal + render parity vs the same
geometry flattened (baked transforms), and instanced emissive lights.

ref: kernel/bvh-accelerator.h:551-683 (the reference's two-level BVH; ours
adds transforms + geometry sharing — see scene/nodes.py Instance).
"""

import numpy as np
import pytest

from akari_tpu.scene.arrays import make_camera
from akari_tpu.scene.nodes import (
    DiffuseMaterial,
    EmissiveMaterial,
    GlossyMaterial,
    Instance,
    Mesh,
    compile_scene,
)
from akari_tpu.core import transform as xform


def _box_mesh(materials):
    """Unit cube [0,1]^3, 12 CCW tris, one material."""
    v = np.array(
        [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
        np.float32,
    )
    f = np.array(
        [
            [0, 1, 3], [0, 3, 2],  # x=0
            [4, 6, 7], [4, 7, 5],  # x=1
            [0, 4, 5], [0, 5, 1],  # y=0
            [2, 3, 7], [2, 7, 6],  # y=1
            [0, 2, 6], [0, 6, 4],  # z=0
            [1, 5, 7], [1, 7, 3],  # z=1
        ],
        np.int64,
    )
    return Mesh(vertices=v, indices=f, materials=materials)


def _xf(translate=(0, 0, 0), scale=1.0, rot_y=0.0):
    t = xform.translate(np.asarray(translate, np.float32))
    c, s = np.cos(rot_y), np.sin(rot_y)
    r = np.eye(4, dtype=np.float32)
    r[0, 0], r[0, 2], r[2, 0], r[2, 2] = c, s, -s, c
    sc = np.diag([scale, scale, scale, 1.0]).astype(np.float32)
    return np.asarray(t @ r @ sc, np.float32)


def _baked(mesh, M):
    """Copy of ``mesh`` with the transform baked (for the flat reference)."""
    return Mesh(
        vertices=mesh.vertices, indices=mesh.indices,
        materials=mesh.materials, material_ids=mesh.material_ids,
        normals=mesh.normals, uvs=mesh.uvs,
        corner_normals=mesh.corner_normals, corner_uvs=mesh.corner_uvs,
        transform=M,
    )


def _scene_pair():
    """(instanced shapes, flat-baked shapes) of identical world geometry."""
    white = DiffuseMaterial((0.7, 0.7, 0.7))
    glossy = GlossyMaterial((0.8, 0.7, 0.6), 0.2)
    light = EmissiveMaterial((12.0, 11.0, 9.0))
    proto = _box_mesh([glossy])

    floor = Mesh(
        vertices=np.array(
            [[-4, 0, -4], [4, 0, -4], [4, 0, 4], [-4, 0, 4]], np.float32
        ),
        indices=np.array([[0, 2, 1], [0, 3, 2]], np.int64),
        materials=[white],
    )
    lamp = Mesh(
        vertices=np.array(
            [[-0.6, 3.0, -0.6], [0.6, 3.0, -0.6], [0.6, 3.0, 0.6],
             [-0.6, 3.0, 0.6]], np.float32
        ),
        indices=np.array([[0, 1, 2], [0, 2, 3]], np.int64),
        materials=[light],
    )
    xforms = [
        _xf((-1.5, 0.0, -0.5), scale=0.8, rot_y=0.4),
        _xf((0.3, 0.0, 0.4), scale=1.2, rot_y=-0.7),
        _xf((1.6, 0.0, -1.0), scale=0.5, rot_y=1.1),
    ]
    instanced = [floor, lamp] + [Instance(proto, M) for M in xforms]
    flat = [floor, lamp] + [_baked(proto, M) for M in xforms]
    return instanced, flat


def _rays(n=512, seed=0):
    r = np.random.RandomState(seed)
    o = np.array([0.0, 2.0, 6.0], np.float32) + r.randn(n, 3).astype(np.float32) * 0.3
    target = r.uniform(-2, 2, (n, 3)).astype(np.float32)
    target[:, 1] = r.uniform(0, 2, n)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    instanced, flat = _scene_pair()
    return compile_scene(instanced), compile_scene(flat, intersector="brute")


def test_instanced_compile_shares_storage(pair):
    sc_i, sc_f = pair
    # 3 instances share one 12-tri prototype: storage grows by 12, virtual
    # id space by 36 (flat scene stores >= 36 box tris, modulo SBVH dups).
    assert sc_i.instances is not None
    assert sc_i.instances.n_instances == 5  # floor, lamp, 3 boxes
    n_proto_storage = sc_i.tri_v0.shape[0]
    assert n_proto_storage < np.asarray(sc_f.tri_v0).shape[0]
    assert sc_i.n_tris >= 2 + 2 + 36


def test_instanced_intersect_matches_flat(pair):
    import jax.numpy as jnp

    from akari_tpu.ops.intersect import intersect

    sc_i, sc_f = pair
    o, d = _rays()
    hi = intersect(sc_i, jnp.asarray(o), jnp.asarray(d))
    hf = intersect(sc_f, jnp.asarray(o), jnp.asarray(d))
    vi, vf = np.asarray(hi.valid), np.asarray(hf.valid)
    np.testing.assert_array_equal(vi, vf)
    ti, tf = np.asarray(hi.t), np.asarray(hf.t)
    np.testing.assert_allclose(ti[vi], tf[vf], rtol=1e-4, atol=1e-4)


def test_instanced_occlude_matches_flat(pair):
    import jax.numpy as jnp

    from akari_tpu.ops.intersect import occlude

    sc_i, sc_f = pair
    o, d = _rays(seed=1)
    t_min = np.zeros(o.shape[0], np.float32)
    t_max = np.full(o.shape[0], 5.0, np.float32)
    oi = np.asarray(occlude(sc_i, jnp.asarray(o), jnp.asarray(d), t_min, t_max))
    of = np.asarray(occlude(sc_f, jnp.asarray(o), jnp.asarray(d), t_min, t_max))
    # boundary-epsilon hits may differ on a few lanes; demand near-total match
    assert (oi == of).mean() > 0.99


def test_instanced_surface_data_world_space(pair):
    """Shading attrs of an instanced hit are in world space: the hit point
    recomputed from barycentrics must equal o + t*d."""
    import jax.numpy as jnp

    from akari_tpu.integrators.path import _surface_data
    from akari_tpu.ops.intersect import intersect

    sc_i, _ = pair
    o, d = _rays(seed=2)
    h = intersect(sc_i, jnp.asarray(o), jnp.asarray(d))
    p, ng, ns, uv, mat_id = _surface_data(sc_i, h.prim, h.uv, jnp)
    v = np.asarray(h.valid)
    p_exp = o + np.asarray(h.t)[:, None] * d
    np.testing.assert_allclose(
        np.asarray(p)[v], p_exp[v], rtol=1e-3, atol=1e-3
    )
    n_len = np.linalg.norm(np.asarray(ns)[v], axis=-1)
    np.testing.assert_allclose(n_len, 1.0, atol=1e-3)


def test_instanced_render_matches_flat(pair):
    from akari_tpu.integrators.path import PathConfig, render

    sc_i, sc_f = pair
    cam = make_camera(xform.translate((0.0, 2.0, 8.0)), 30.0, 24, 24)
    cfg = PathConfig(spp=24, max_depth=3, ray_clamp=40.0)
    img_i = np.asarray(render(sc_i, cam, cfg, seed=0))
    img_f = np.asarray(render(sc_f, cam, cfg, seed=0))
    assert np.all(np.isfinite(img_i))
    mi, mf = float(img_i.mean()), float(img_f.mean())
    assert mi > 0.01
    # same light table + same RNG stream: only traversal tie-breaks differ
    assert abs(mi - mf) < 0.05 * max(mi, mf), (mi, mf)
    rel = np.abs(img_i - img_f).mean() / max(mf, 1e-6)
    assert rel < 0.1


def test_instanced_pallas_flatten_matches_bvh(pair):
    """Instanced scenes on the dense Pallas kernel (interpret mode): the
    compile flattens instances to world space; hits and renders must
    agree with the two-level TLAS/BLAS traversal of the same geometry."""
    import jax.numpy as jnp

    import akari_tpu.ops.pallas_intersect as pi
    from akari_tpu.integrators.path import PathConfig, render
    from akari_tpu.ops.intersect import intersect

    sc_i, _ = pair
    instanced, _ = _scene_pair()
    sc_p = compile_scene(instanced, intersector="pallas")
    assert sc_p.instances is None          # flattened
    assert sc_p.intersector == "pallas"
    assert sc_i.instances is not None      # bvh path untouched

    o, d = _rays(300, seed=4)
    o, d = jnp.asarray(o), jnp.asarray(d)
    old = pi.INTERPRET
    pi.INTERPRET = True
    try:
        hp = intersect(sc_p, o, d)
        cam = make_camera(xform.translate((0.0, 2.0, 8.0)), 30.0, 16, 16)
        cfg = PathConfig(spp=16, max_depth=3, ray_clamp=40.0)
        img_p = np.asarray(render(sc_p, cam, cfg, seed=0))
    finally:
        pi.INTERPRET = old
    hi = intersect(sc_i, o, d)
    np.testing.assert_array_equal(np.asarray(hp.valid), np.asarray(hi.valid))
    ok = np.asarray(hi.valid)
    np.testing.assert_allclose(
        np.asarray(hp.t)[ok], np.asarray(hi.t)[ok], rtol=1e-4, atol=1e-4
    )
    img_i = np.asarray(render(sc_i, cam, cfg, seed=0))
    rel = np.abs(img_p - img_i).mean() / max(float(img_i.mean()), 1e-6)
    assert rel < 0.1, rel


def test_instanced_emissive_lights_scale():
    """Two instances of an emissive quad emit ~2x the light of one, and a
    scaled instance's power follows its world area (power CDF built from
    per-instance world areas)."""
    from akari_tpu.integrators.path import PathConfig, render

    white = DiffuseMaterial((0.7, 0.7, 0.7))
    light = EmissiveMaterial((8.0, 8.0, 8.0), double_sided=True)
    lamp = Mesh(
        vertices=np.array(
            [[-0.4, 2.0, -0.4], [0.4, 2.0, -0.4], [0.4, 2.0, 0.4],
             [-0.4, 2.0, 0.4]], np.float32
        ),
        indices=np.array([[0, 1, 2], [0, 2, 3]], np.int64),
        materials=[light],
    )
    floor = Mesh(
        vertices=np.array(
            [[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]], np.float32
        ),
        indices=np.array([[0, 2, 1], [0, 3, 2]], np.int64),
        materials=[white],
    )
    cam = make_camera(xform.translate((0.0, 1.0, 6.0)), 35.0, 16, 16)
    cfg = PathConfig(spp=48, max_depth=2, ray_clamp=100.0)

    sc1 = compile_scene([floor, Instance(lamp, _xf((0, 0, 0)))])
    sc2 = compile_scene(
        [
            floor,
            Instance(lamp, _xf((-0.8, 0, 0))),
            Instance(lamp, _xf((0.8, 0, 0))),
        ]
    )
    assert sc1.lights.n_lights == 2 and sc2.lights.n_lights == 4
    m1 = float(np.asarray(render(sc1, cam, cfg, seed=0)).mean())
    m2 = float(np.asarray(render(sc2, cam, cfg, seed=0)).mean())
    assert m1 > 0.005
    ratio = m2 / m1
    assert 1.5 < ratio < 2.6, ratio


def test_decode_prim_roundtrip(pair):
    from akari_tpu.scene import geom

    sc_i, _ = pair
    it = sc_i.instances
    prim_base = np.concatenate([[0], np.asarray(it.prim_ends)])
    for i in range(it.n_instances):
        for local in (0, int(prim_base[i + 1] - prim_base[i]) - 1):
            virt = np.asarray([prim_base[i] + local])
            sid, inst = geom.decode_prim(sc_i, virt, np)
            assert inst[0] == i
            assert 0 <= sid[0] < sc_i.tri_v0.shape[0]
            assert sid[0] == virt[0] + np.asarray(it.tri_offset)[i]


def test_sdl_instance_node(tmp_path):
    """SDL `Instance { mesh, translate/rotate/scale }` compiles and renders."""
    import os

    from akari_tpu.scene import sdl

    obj = tmp_path / "tri.obj"
    obj.write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n"
    )
    src = """
let proto = OBJMesh { path: "tri.obj" }
export scene = Scene {
    shapes: [
        Instance { mesh: $proto, translate: [1, 0, 0], scale: 2 },
        Instance { mesh: $proto, rotate: [0, 90, 0] }
    ]
}
"""
    (tmp_path / "main.akari").write_text(src)
    module = sdl.parse_file(str(tmp_path / "main.akari"))
    scene_node = module.exports["scene"]
    sc = scene_node.compile()
    assert sc.instances is not None and sc.instances.n_instances == 2
    # one shared prototype: storage holds a single triangle
    assert sc.tri_v0.shape[0] == 1 and sc.n_tris == 2


def test_two_level_walk_matches_flat_on_larger_scene():
    """The two-level XLA walk (the GPU route for instanced scenes above
    the dense threshold) on 40 rotated, scaled instances of a 200-triangle
    prototype: hits, distances and occlusion match brute force over the
    same geometry flattened to world space."""
    import jax.numpy as jnp

    from akari_tpu.ops.intersect import intersect, occlude

    r = np.random.default_rng(5)
    base = r.uniform(-1, 1, size=(200, 1, 3))
    tris = (base + r.normal(scale=0.2, size=(200, 3, 3))).astype(np.float32)
    proto = Mesh(vertices=tris.reshape(-1, 3),
                 indices=np.arange(600).reshape(-1, 3),
                 materials=[DiffuseMaterial()])
    xforms = [
        _xf(tuple(r.uniform(-6, 6, 3)), scale=float(r.uniform(0.4, 1.2)),
            rot_y=float(r.uniform(0, 6.28)))
        for _ in range(40)
    ]
    sc_i = compile_scene([Instance(proto, M) for M in xforms])
    sc_f = compile_scene([_baked(proto, M) for M in xforms],
                         intersector="brute")
    assert sc_i.instances is not None and sc_i.instances.n_instances == 40
    assert sc_i.tri_v0.shape[0] < np.asarray(sc_f.tri_v0).shape[0]
    o = r.uniform(-7, 7, size=(512, 3)).astype(np.float32)
    d = r.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    hi, hf = intersect(sc_i, o, d), intersect(sc_f, o, d)
    vi, vf = np.asarray(hi.valid), np.asarray(hf.valid)
    np.testing.assert_array_equal(vi, vf)
    assert vi.sum() > 50
    np.testing.assert_allclose(
        np.asarray(hi.t)[vi], np.asarray(hf.t)[vf], rtol=1e-4, atol=1e-4
    )
    t_max = jnp.full((512,), 2.0, jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(occlude(sc_i, o, d, 0.0, t_max)),
        np.asarray(occlude(sc_f, o, d, 0.0, t_max)),
    )
