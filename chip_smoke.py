"""Smoke run of the renderer's main path on one NVIDIA GPU.

    python chip_smoke.py               # every phase below, on one card
    python chip_smoke.py --four-cards  # only the 4-card sharded phase

Phases, in order, in one process (each prints one line; any failed check
raises and the script exits non-zero):

1. device   — JAX must see a GPU; prints nvidia-smi's name and power limit.
2. cli      — the render CLI in-process on the Cornell scene, 1024x1024,
              16 spp, depth 5; the image must be finite and lit.
3. kernels  — the dense intersector vs the brute-force reference at real
              widths (2^22 rays; the 524,288-ray fused shadow+extension
              launch), and the XLA BVH walk vs brute force on the
              522k-triangle terrain (65,536 rays).
4. oracle   — a small matched-seed frame vs the NumPy oracle.
5. inverse  — fwd+bwd of the bench configuration (256x256, 4 spp, depth
              5) and a few Adam steps: finite, and the loss falls.
6. terrain  — the 522k-triangle terrain through ``auto``: finite and lit.

The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

PHASES = ("cli", "kernels", "oracle", "inverse", "terrain")
FOUR_CARD_PHASES = ("four_cards",)
_ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(_ROOT, "chiprun_out", "chip_smoke")

# Barycentric distance to an edge, and relative distance of t to t_max,
# inside which float32 rounding (FMA contraction, division) may flip a hit
# test between two compiled programs.
EDGE_TOL = 1e-5
T_RTOL = 1e-5


def select_phases(argv):
    """Phases to run for the command line ``argv``."""
    if "--four-cards" in argv:
        return FOUR_CARD_PHASES
    return PHASES


def last_line(devices):
    """The result line for the devices JAX reports."""
    d = devices[0]
    return json.dumps({
        "ok": True,
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(devices)},
    })


def _say(phase, **fields):
    parts = " ".join(
        f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in fields.items()
    )
    print(f"[{phase}] {parts}", flush=True)


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _timed(fn):
    """(result, first-call seconds, second-call seconds); both calls end
    in block_until_ready. The first includes compilation."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, first, time.perf_counter() - t0


def phase_device(n_cards):
    import jax

    devs = jax.devices()
    _check(devs[0].platform == "gpu",
           f"JAX found no GPU (platform {devs[0].platform!r})")
    _check(len(devs) >= n_cards, f"need {n_cards} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    for line in smi.splitlines():
        print(f"nvidia-smi: {line}")
    _say("device", kind=devs[0].device_kind, count=len(devs))


# -- phase 2: CLI -----------------------------------------------------------

def phase_cli(size=1024, spp=16, depth=5):
    from akari_tpu.cli.render import main as cli_main
    from akari_tpu.scene import sdl

    scene_file = os.path.join(_ROOT, "scenes", "cornell_box", "scene.akari")
    resolved = sdl.parse_file(scene_file).exports["scene"].compile(
        intersector="auto").intersector
    os.makedirs(OUT_DIR, exist_ok=True)
    out = os.path.join(OUT_DIR, f"cornell_{size}.npy")
    argv = ["-i", scene_file, "-o", out, "--spp", str(spp),
            "--max-depth", str(depth), "--width", str(size),
            "--height", str(size)]
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        _check(cli_main(argv) == 0, "render CLI returned non-zero")
        times.append(time.perf_counter() - t0)
    img = np.load(out)
    _check(img.shape == (size, size, 3), f"image shape {img.shape}")
    _check(bool(np.isfinite(img).all()), "CLI image has non-finite pixels")
    mean = float(img.mean())
    # the lit Cornell box averages ~0.2-0.4; a broken light term is dark
    _check(mean > 0.05, f"CLI image too dark (mean {mean})")
    _say("cli", ran=f"akari_tpu.cli.render {size}x{size} {spp}spp "
         f"depth{depth}", intersector=resolved, first_s=times[0],
         second_s=times[1], mean=mean, max=float(img.max()))


# -- phase 3: kernels vs the plain reference ----------------------------------

def _ambiguous(o, d, tmin, tmax, v0, e1, e2):
    """[M] bool: rays for which some triangle's hit test lies within
    float32 rounding of flipping (a barycentric within EDGE_TOL of an
    edge, t within T_RTOL of t_max, or two hits tied in t). Float64
    Moeller-Trumbore of every ray against every triangle."""
    o, d = o.astype(np.float64), d.astype(np.float64)
    out = np.zeros(o.shape[0], bool)
    for r in range(o.shape[0]):
        p = np.cross(d[r], e2)
        det = np.einsum("ij,ij->i", e1, p)
        ok = np.abs(det) > 1e-12
        inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        tv = o[r] - v0
        u = np.einsum("ij,ij->i", tv, p) * inv
        q = np.cross(tv, e1)
        v = (q @ d[r]) * inv
        t = np.einsum("ij,ij->i", e2, q) * inv
        edge = np.minimum(np.minimum(u, v), 1.0 - u - v)
        span = ok & (t > tmin[r] - T_RTOL) & (t < tmax[r] * (1 + T_RTOL))
        near_edge = span & (np.abs(edge) <= EDGE_TOL)
        inside = span & (edge >= -EDGE_TOL)
        near_tmax = inside & (np.abs(t - tmax[r]) <= T_RTOL * abs(tmax[r]))
        ties = 0
        if inside.any():
            tin = t[inside]
            ties = int((np.abs(tin - tin.min()) <= T_RTOL * tin.min()).sum())
        out[r] = bool(near_edge.any() or near_tmax.any() or ties > 1)
    return out


def _compare(name, got, ref, rays, scene, closest=True):
    """Check ``got`` against ``ref``: valid/prim (or occlusion) exactly,
    except on ambiguous rays; t within T_RTOL on matching hits. Prims are
    compared as original triangles (a spatial-split BVH stores some
    triangles in several slots)."""
    o, d, tmin, tmax = (np.asarray(a) for a in rays)
    tris = tuple(np.asarray(a, np.float64)
                 for a in (scene.tri_v0, scene.tri_e1, scene.tri_e2))
    if closest:
        vg, vr = np.asarray(got.valid), np.asarray(ref.valid)
        orig = np.asarray(scene.prim_to_orig)
        pg = orig[np.maximum(np.asarray(got.prim), 0)]
        pr = orig[np.maximum(np.asarray(ref.prim), 0)]
        bad = (vg != vr) | (vr & (pg != pr))
    else:
        vg, vr = np.asarray(got), np.asarray(ref)
        bad = vg != vr
    idx = np.nonzero(bad)[0]
    _check(idx.size <= 2000, f"{name}: {idx.size} rays disagree")
    amb = _ambiguous(o[idx], d[idx], tmin[idx], tmax[idx], *tris)
    _check(bool(amb.all()),
           f"{name}: {int((~amb).sum())} rays disagree away from any "
           f"edge/t_max tie (first {idx[~amb][:5].tolist()})")
    fields = dict(rays=o.shape[0], hits=int(vr.sum()), edge_flips=idx.size)
    if closest:
        same = vr & ~bad
        tg, tr = np.asarray(got.t)[same], np.asarray(ref.t)[same]
        rel = float(np.max(np.abs(tg - tr) / np.abs(tr), initial=0.0))
        _check(rel <= T_RTOL, f"{name}: t rel err {rel} > {T_RTOL}")
        fields["t_max_rel_err"] = rel
    return fields


def _uniform_dirs(key, n):
    import jax
    import jax.numpy as jnp

    d = jax.random.normal(key, (n, 3), jnp.float32)
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def _cornell_rays(camera, n, seed, bounded):
    """Half camera rays, half rays from random points inside the box in
    random directions; ``bounded`` gives every ray a finite t_max."""
    import jax
    import jax.numpy as jnp

    from akari_tpu.integrators.path import camera_rays
    from akari_tpu.ops.intersect import T_MAX

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    half = n // 2
    npix = camera.width * camera.height
    i = jnp.arange(half, dtype=jnp.uint32)
    oc, dc = camera_rays(camera, seed, i // npix, i % npix, jnp)
    lo = jnp.asarray([-0.99, 0.01, -0.99], jnp.float32)
    hi = jnp.asarray([0.99, 1.99, 0.99], jnp.float32)
    oi = lo + (hi - lo) * jax.random.uniform(k1, (n - half, 3))
    di = _uniform_dirs(k2, n - half)
    o = jnp.concatenate([oc, oi])
    d = jnp.concatenate([dc, di])
    tmin = jnp.zeros((n,), jnp.float32)
    if bounded:
        tmax = jax.random.uniform(k3, (n,), jnp.float32, 0.3, 4.0)
    else:
        tmax = jnp.full((n,), T_MAX, jnp.float32)
    return o, d, tmin, tmax


def _fused_rays(n, seed):
    """The bench step's fused launch: n/2 shadow rays from points inside
    the box toward the ceiling light (t_max short of the light), then n/2
    extension rays with unbounded t_max."""
    import jax
    import jax.numpy as jnp

    from akari_tpu.ops.intersect import T_MAX

    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(seed), 4)
    half = n // 2
    lo = jnp.asarray([-0.99, 0.01, -0.99], jnp.float32)
    hi = jnp.asarray([0.99, 1.9, 0.99], jnp.float32)
    o = lo + (hi - lo) * jax.random.uniform(k1, (n, 3))
    light = jnp.stack([
        jax.random.uniform(k2, (half,), jnp.float32, -0.24, 0.23),
        jnp.full((half,), 1.98, jnp.float32),
        jax.random.uniform(k3, (half,), jnp.float32, -0.22, 0.16),
    ], -1)
    to_l = light - o[:half]
    dist = jnp.linalg.norm(to_l, axis=-1)
    d = jnp.concatenate([to_l / dist[:, None], _uniform_dirs(k4, n - half)])
    tmax = jnp.concatenate([
        dist * (1.0 - 1e-3), jnp.full((n - half,), T_MAX, jnp.float32)
    ])
    return o, d, jnp.zeros((n,), jnp.float32), tmax


def _intersectors(scene, dense):
    """Jitted (closest, any-hit) of ``scene`` under intersector ``dense``."""
    import dataclasses

    import jax

    from akari_tpu.ops.intersect import intersect, occlude

    s = dataclasses.replace(scene, intersector=dense)
    closest = jax.jit(lambda sc, o, d, a, b: intersect(sc, o, d, a, b))
    anyhit = jax.jit(lambda sc, o, d, a, b: occlude(sc, o, d, a, b))
    return (lambda *r: closest(s, *r)), (lambda *r: anyhit(s, *r))


def phase_kernels(n_big=1 << 22, n_fused=1 << 19, n_terrain=1 << 16,
                  terrain_n=512):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from akari_tpu.integrators.path import camera_rays
    from akari_tpu.scene import sdl
    from akari_tpu.scene.builtin import terrain_scene

    node = sdl.parse_file(
        os.path.join(_ROOT, "scenes", "cornell_box", "scene.akari")
    ).exports["scene"]
    scene = jax.device_put(node.compile(intersector="auto"))
    dense = scene.intersector
    k_closest, k_any = _intersectors(scene, dense)
    b_closest, b_any = _intersectors(scene, "brute")

    fused = _fused_rays(n_fused, 3)
    cases = [
        (f"closest {n_big}", _cornell_rays(node.camera, n_big, 1, False),
         True),
        (f"anyhit {n_big} bounded",
         _cornell_rays(node.camera, n_big, 2, True), False),
        (f"closest {n_fused} fused shadow+extension", fused, True),
        (f"anyhit {n_fused // 2} shadow",
         tuple(a[:n_fused // 2] for a in fused), False),
    ]
    for name, rays, closest in cases:
        kern, ref = (k_closest, b_closest) if closest else (k_any, b_any)
        got, k_first, k_steady = _timed(lambda: kern(*rays))
        want, b_first, b_steady = _timed(lambda: ref(*rays))
        fields = _compare(name, got, want, rays, scene, closest)
        _say("kernels", ran=f"cornell {name}", intersector=dense,
             compile_s=k_first - k_steady, steady_s=k_steady,
             brute_compile_s=b_first - b_steady, brute_steady_s=b_steady,
             **fields)

    tsc = terrain_scene(256, 256, n=terrain_n)
    tscene = jax.device_put(tsc.compile(intersector="auto"))
    side = int(np.sqrt(n_terrain))
    cam = dataclasses.replace(tsc.camera, width=side, height=side)
    i = jnp.arange(side * side, dtype=jnp.uint32)
    o, d = camera_rays(cam, 0, jnp.zeros_like(i), i, jnp)
    rays = (o, d, jnp.zeros((side * side,), jnp.float32),
            jnp.full((side * side,), 1e30, jnp.float32))
    t_closest, _ = _intersectors(tscene, tscene.intersector)
    tb_closest, _ = _intersectors(tscene, "brute")
    got, k_first, k_steady = _timed(lambda: t_closest(*rays))
    want, b_first, b_steady = _timed(lambda: tb_closest(*rays))
    fields = _compare("terrain bvh", got, want, rays, tscene, True)
    _say("kernels", ran=f"terrain {tscene.n_tris} tris closest",
         intersector=tscene.intersector, compile_s=k_first - k_steady,
         steady_s=k_steady, brute_compile_s=b_first - b_steady,
         brute_steady_s=b_steady, **fields)


# -- phase 4: NumPy oracle ----------------------------------------------------

def phase_oracle(res=24, spp=2, depth=3):
    import jax

    from akari_tpu.integrators.path import PathConfig, render
    from akari_tpu.oracle.renderer import render_oracle
    from akari_tpu.scene.builtin import cornell_box

    sc = cornell_box(res, res)
    scene = sc.compile(intersector="auto")
    cfg = PathConfig(spp=spp, max_depth=depth, mis=True)
    fn = jax.jit(lambda s: render(s, sc.camera, cfg, seed=0))
    img, first, steady = _timed(lambda: fn(scene))
    img = np.asarray(img, np.float64)
    ref = np.asarray(render_oracle(scene, sc.camera, cfg, seed=0), np.float64)
    # tolerance of tests/test_render.py's fused-render-vs-oracle test:
    # per-element rtol 1e-3 / atol 2e-3 with an 8% outlier budget (knife-
    # edge hit decisions flip between compiled programs), mean abs 3e-3
    diff = np.abs(img - ref)
    frac = float((diff > 2e-3 + 1e-3 * np.abs(ref)).mean())
    mean = float(diff.mean())
    _check(frac <= 0.08, f"oracle: outlier fraction {frac} > 0.08")
    _check(mean <= 3e-3, f"oracle: mean abs diff {mean} > 3e-3")
    _say("oracle", ran=f"render vs render_oracle {res}x{res} {spp}spp "
         f"depth{depth}", intersector=scene.intersector,
         compile_s=first - steady, steady_s=steady, outlier_frac=frac,
         mean_abs_diff=mean)


# -- phase 5: inverse rendering -----------------------------------------------

def phase_inverse(res=256, spp=4, depth=5, iterations=6):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from akari_tpu.diff.inverse import (
        InverseConfig, apply_params, inverse_render, scene_params,
    )
    from akari_tpu.integrators.path import PathConfig, render
    from akari_tpu.parallel.mesh import make_ray_mesh
    from akari_tpu.parallel.render import loss_and_image_sharded
    from akari_tpu.scene.builtin import cornell_box

    sc = cornell_box(res, res)
    scene = jax.device_put(sc.compile(intersector="auto"))
    cfg = PathConfig(spp=spp, max_depth=depth, unroll=True, remat=False)
    mesh = make_ray_mesh(n_devices=1)
    # target: the true scene averaged over four seeds (less target noise)
    fwd = jax.jit(lambda s, seed: render(s, sc.camera, cfg, seed=seed))
    target = sum(fwd(scene, jnp.uint32(100 + k)) for k in range(4)) / 4.0
    # start from albedos and emission at 60% of the truth
    truth = np.asarray(scene.textures.value)
    start = dataclasses.replace(scene, textures=dataclasses.replace(
        scene.textures, value=scene.textures.value * 0.6))

    def loss_fn(params):
        s = apply_params(start, params)
        return loss_and_image_sharded(s, sc.camera, cfg, mesh, target)[0]

    step = jax.jit(jax.value_and_grad(loss_fn))
    (loss0, grads), first, steady = _timed(lambda: step(scene_params(start)))
    g = np.asarray(grads["tex_value"])
    _check(np.isfinite(float(loss0)) and bool(np.isfinite(g).all()),
           "inverse: loss or gradients not finite")
    _check(float(np.abs(g).sum()) > 0.0, "inverse: gradients are all zero")
    t0 = time.perf_counter()
    found, losses, _ = inverse_render(
        start, sc.camera, cfg, target, mesh,
        InverseConfig(iterations=iterations, learning_rate=0.1,
                      param_space="log"),
    )
    adam_s = time.perf_counter() - t0
    _check(bool(np.isfinite(losses).all()), f"inverse: losses {losses}")
    # the same loss (same seed, so the same sample noise) before and after
    loss1 = float(step(scene_params(found))[0])
    err0 = float(np.abs(truth * 0.6 - truth).mean())
    err1 = float(np.abs(np.asarray(found.textures.value) - truth).mean())
    _check(loss1 < float(loss0), f"inverse: loss did not fall {loss0} -> "
           f"{loss1} (Adam losses {losses})")
    _check(err1 < err0, f"inverse: parameter error grew {err0} -> {err1}")
    _say("inverse", ran=f"value_and_grad {res}x{res} {spp}spp depth{depth} "
         f"+ {iterations} Adam steps", intersector=scene.intersector,
         compile_s=first - steady, steady_s=steady, adam_total_s=adam_s,
         loss_start=float(loss0), loss_end=loss1, param_err_start=err0,
         param_err_end=err1, grad_l1=float(np.abs(g).sum()))


# -- phase 6: large mesh -----------------------------------------------------

def phase_terrain(res=256, spp=4, depth=5, n=512):
    import jax

    from akari_tpu.bvh import build
    from akari_tpu.integrators.path import PathConfig, render
    from akari_tpu.scene.builtin import terrain_scene

    t0 = time.perf_counter()
    tsc = terrain_scene(res, res, n=n)
    scene = tsc.compile(intersector="auto")
    host_s = time.perf_counter() - t0
    builder = build.LAST_BUILDER
    cfg = PathConfig(spp=spp, max_depth=depth)
    fn = jax.jit(lambda s: render(s, tsc.camera, cfg, seed=0))
    dev_scene = jax.device_put(scene)
    img, first, steady = _timed(lambda: fn(dev_scene))
    img = np.asarray(img)
    _check(bool(np.isfinite(img).all()), "terrain image has non-finite pixels")
    mean = float(img.mean())
    _check(mean > 0.01, f"terrain image too dark (mean {mean})")
    _say("terrain", ran=f"render {scene.n_tris} tris {res}x{res} {spp}spp "
         f"depth{depth}", intersector=scene.intersector, bvh_builder=builder,
         scene_compile_s=host_s, compile_s=first - steady, steady_s=steady,
         mean=mean)


# -- four cards ---------------------------------------------------------------

def phase_four_cards(res=256, spp=4, depth=5, odd=131):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from akari_tpu.diff.inverse import apply_params, scene_params
    from akari_tpu.integrators.path import PathConfig
    from akari_tpu.parallel.mesh import make_ray_mesh
    from akari_tpu.parallel.render import loss_and_image_sharded, render_sharded
    from akari_tpu.scene.builtin import cornell_box

    devs = jax.devices()[:4]
    mesh4, mesh1 = make_ray_mesh(n_devices=4), make_ray_mesh(n_devices=1)
    sc = cornell_box(res, res)
    scene = sc.compile(intersector="auto")
    cfg = PathConfig(spp=spp, max_depth=depth)  # library default: scan+remat
    target = jnp.full((res, res, 3), 0.1, jnp.float32)
    params = scene_params(scene)

    def step_for(mesh):
        def loss_fn(p):
            s = apply_params(scene, p)
            return loss_and_image_sharded(s, sc.camera, cfg, mesh, target)[0]
        return jax.jit(jax.value_and_grad(loss_fn))

    step4 = step_for(mesh4)
    (l4, g4), first4, steady4 = _timed(lambda: step4(params))
    # CPU devices (a rehearsal) report no memory statistics
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 1)
             for d in devs]
    step1 = step_for(mesh1)
    (l1, g1), first1, steady1 = _timed(lambda: step1(params))
    for leaf in jax.tree_util.tree_leaves((l4, g4)):
        _check(len(leaf.sharding.device_set) == 4,
               f"four_cards: a result lives on {leaf.sharding.device_set}")
    _check(min(peaks) > 0.5 * max(peaks),
           f"four_cards: uneven device memory peaks {peaks}")
    rel = abs(float(l4) - float(l1)) / abs(float(l1))
    _check(rel <= 1e-5, f"four_cards: loss rel diff {rel}")
    a, b = np.asarray(g4["tex_value"]), np.asarray(g1["tex_value"])
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max())
    _say("four_cards", ran=f"loss_and_image_sharded fwd+bwd {res}x{res} "
         f"{spp}spp depth{depth}", intersector=scene.intersector,
         compile_s_4=first4 - steady4, steady_s_4=steady4,
         compile_s_1=first1 - steady1, steady_s_1=steady1, loss_rel_diff=rel,
         grad_max_abs_diff=float(np.abs(a - b).max()),
         peak_bytes=",".join(str(p) for p in peaks))

    cam = dataclasses.replace(sc.camera, width=odd, height=odd)
    r4 = jax.jit(lambda s: render_sharded(s, cam, cfg, mesh4))
    r1 = jax.jit(lambda s: render_sharded(s, cam, cfg, mesh1))
    img4, f4, s4 = _timed(lambda: r4(scene))
    img1, f1, s1 = _timed(lambda: r1(scene))
    img4, img1 = np.asarray(img4), np.asarray(img1)
    diff = np.abs(img4 - img1)
    frac = float((diff > 2e-3 + 1e-3 * np.abs(img1)).mean())
    _check(img4.shape == (odd, odd, 3), f"four_cards: shape {img4.shape}")
    _check(frac <= 0.005, f"four_cards: image outlier fraction {frac}")
    _say("four_cards", ran=f"render_sharded {odd}x{odd} {spp}spp "
         f"depth{depth}", intersector=scene.intersector,
         compile_s_4=f4 - s4, steady_s_4=s4, steady_s_1=s1,
         outlier_frac=frac, max_abs_diff=float(diff.max()))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    phases = select_phases(argv)
    phase_device(4 if phases == FOUR_CARD_PHASES else 1)

    from akari_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    for name in phases:
        globals()[f"phase_{name}"]()

    import jax

    devices = jax.devices()
    if phases == FOUR_CARD_PHASES:
        devices = devices[:4]
    print(last_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
