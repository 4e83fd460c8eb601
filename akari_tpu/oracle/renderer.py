"""NumPy reference renderer — the golden oracle for the JAX device path.

Plays the role of the reference's CPU megakernel renderer in the golden
tests (BASELINE: "images and pixel gradients allclose to the reference CPU
renderer on matched sampler seeds"): same algorithm, same deterministic
counter RNG stream (core/rng.py), brute-force intersection with float64
accumulation options — executed eagerly in NumPy with no XLA involved.

The JAX renderer must match this bit-for-bit in ray/sample decisions and
to float32 tolerance in radiance.
"""

from __future__ import annotations

import numpy as np

from ..core.vecmath import cross, dot
from ..integrators.path import PathConfig, trace_paths
from ..ops.intersect import HIT_EPS, T_MAX


def _intersect_brute_np(scene, o, d, t_min, t_max):
    """Vectorized numpy brute-force closest hit (rays x all triangles)."""
    v0 = np.asarray(scene.tri_v0)[None]  # [1,T,3]
    e1 = np.asarray(scene.tri_e1)[None]
    e2 = np.asarray(scene.tri_e2)[None]
    o_ = o[:, None, :]
    d_ = d[:, None, :]
    pvec = cross(d_, e2)
    det = dot(e1, pvec)
    safe_det = np.where(np.abs(det) < HIT_EPS, 1.0, det)
    inv_det = 1.0 / safe_det
    tvec = o_ - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d_, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = (
        (np.abs(det) >= HIT_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min[:, None])
        & (t < t_max[:, None])
    )
    t = np.where(hit, t, T_MAX).astype(np.float32)
    k = np.argmin(t, axis=1)
    rows = np.arange(o.shape[0])
    best_t = t[rows, k]
    valid = best_t < T_MAX
    prim = np.where(valid, k, -1).astype(np.int32)
    bu = u[rows, k].astype(np.float32)
    bv = v[rows, k].astype(np.float32)
    return best_t, prim, bu, bv, valid


def render_oracle(scene, camera, cfg=None, seed=0, spp=None):
    """Render with NumPy. Returns [H, W, 3] float32 mean radiance."""
    cfg = cfg or PathConfig()
    spp = spp if spp is not None else cfg.spp
    scene = _to_numpy(scene)
    n = camera.width * camera.height
    pixel_idx = np.arange(n, dtype=np.uint32)

    def intersect_fn(o3, d3):
        return _intersect_brute_np(
            scene, o3.stack(np), d3.stack(np),
            np.zeros(n, np.float32), np.full(n, T_MAX, np.float32),
        )

    def occlude_fn(o3, d3, t_min, t_max):
        _, prim, _, _, valid = _intersect_brute_np(
            scene, o3.stack(np), d3.stack(np), t_min, t_max
        )
        return valid

    acc = np.zeros((n, 3), np.float64)
    for s in range(spp):
        acc += trace_paths(
            scene, camera, cfg, np.uint32(seed), np.uint32(s), pixel_idx,
            intersect_fn, occlude_fn, np,
        )
    img = (acc / spp).astype(np.float32)
    return img.reshape(camera.height, camera.width, 3)


def _to_numpy(scene):
    import jax

    return jax.tree_util.tree_map(lambda x: np.asarray(x), scene)
