"""Benchmark: rays/sec/chip forward+backward at 4spp Cornell box.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.
The baseline denominator is the reference's only stated CPU throughput
figure, 0.5 M rays/s (ref: src/akari/kernel/integrators/cpu/
integrator.cpp:102 — a hard-coded progress-cadence estimate; the reference
publishes no measured numbers, see BASELINE.md).

``--full`` additionally times, and prints as markdown on stderr, the
canonical reference workload (Cornell 1024², 16 spp, depth 5 — ref:
resources/data/cornell_box/scene.akari:3-20), the 522k-triangle terrain,
a 64-instance two-level scene, the bf16-vs-f32 spectrum variant and the
fwd+bwd step against the forward pass alone.

Timing: every timed call ends in ``jax.block_until_ready``; the first
call (compilation) is reported apart from the steady median.
"""

import json
import statistics
import sys
import time


def _timeit(fn, iters):
    """(first-call seconds, median steady seconds) of ``fn()``."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return first, statistics.median(times)


def _device():
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def bench_step(width=256, height=256, spp=4, max_depth=5):
    """The driver metric's step: jitted value_and_grad of the sharded MSE
    loss over the scene parameters. Returns (step, params, scene)."""
    import jax
    import jax.numpy as jnp

    from akari_tpu.diff.inverse import apply_params, scene_params
    from akari_tpu.integrators.path import PathConfig
    from akari_tpu.parallel.mesh import make_ray_mesh
    from akari_tpu.parallel.render import loss_and_image_sharded
    from akari_tpu.scene.builtin import cornell_box

    # unroll=True is the megakernel-style variant (ref keeps the same
    # choice behind a flag, gpu/cuda/integrator.cpp:409-419): unrolling
    # the bounce loop lets XLA fuse across bounces and drops the scan's
    # carry updates, at ~max_depth x the compile time. The scan+remat
    # path stays the library default.
    cfg = PathConfig(spp=spp, max_depth=max_depth, unroll=True, remat=False)
    sc = cornell_box(width, height)
    scene = jax.device_put(sc.compile(intersector="auto"))
    mesh = make_ray_mesh()
    target = jnp.zeros((height, width, 3), jnp.float32)

    def loss_fn(params):
        s = apply_params(scene, params)
        loss, _ = loss_and_image_sharded(s, sc.camera, cfg, mesh, target,
                                         seed=0)
        return loss

    return jax.jit(jax.value_and_grad(loss_fn)), scene_params(scene), scene


def primary():
    """The driver metric: fwd+bwd rays/s/chip, 4spp 256^2 Cornell."""
    import jax

    width = height = 256
    spp, max_depth = 4, 5
    step, params, _ = bench_step(width, height, spp, max_depth)
    _, dt = _timeit(lambda: step(params), iters=10)

    # rays per fwd+bwd step: camera + bounce extension rays + shadow rays
    rays = spp * width * height * (2 * max_depth + 1)
    rays_per_sec_per_chip = rays / dt / jax.device_count()
    baseline = 0.5e6  # ref CPU estimate (integrators/cpu/integrator.cpp:102)
    return {
        "metric": "rays_per_sec_per_chip_fwd_bwd_4spp_cornell",
        "value": rays_per_sec_per_chip,
        "unit": "rays/s/chip",
        "vs_baseline": rays_per_sec_per_chip / baseline,
        "device": _device(),
    }


def full_suite():
    """Extended workloads -> list of markdown lines."""
    import dataclasses

    import jax
    import numpy as np

    from akari_tpu.core import transform as xform
    from akari_tpu.integrators.path import PathConfig, render
    from akari_tpu.scene.builtin import cornell_box, terrain_mesh, terrain_scene
    from akari_tpu.scene.nodes import Instance, compile_scene
    from akari_tpu.utils.config import RGB_BF16

    def fwd_rays(w, h, spp, depth):
        return spp * w * h * (2 * depth + 1)

    def frame(scene, camera, cfg, iters=3):
        # scenes are jit ARGUMENTS (a closure would bake the arrays into
        # the program as constants)
        fn = jax.jit(lambda s: render(s, camera, cfg, seed=0))
        return _timeit(lambda: fn(scene), iters)

    lines = [f"# bench.py --full on {_device()}", ""]

    sc = cornell_box(1024, 1024)
    scene = jax.device_put(sc.compile(intersector="auto"))
    first, dt = frame(scene, sc.camera, PathConfig(spp=16, max_depth=5))
    lines += [
        "## Canonical workload (ref: cornell_box/scene.akari — 1024x1024, "
        "16 spp, depth 5, forward)",
        f"- intersector `{scene.intersector}`; first call {first:.3f} s; "
        f"steady {dt:.4f} s/frame, "
        f"{fwd_rays(1024, 1024, 16, 5) / dt / 1e6:.1f} M rays/s",
        "",
    ]

    cfg_t = PathConfig(spp=4, max_depth=5)
    rt = fwd_rays(256, 256, 4, 5)
    tsc = terrain_scene(256, 256, n=512)
    tscene = jax.device_put(tsc.compile(intersector="auto"))
    first, dt = frame(tscene, tsc.camera, cfg_t)
    lines += [
        f"## Large mesh: terrain, {tscene.n_tris} tris "
        "(256x256, 4 spp, depth 5)",
        f"- intersector `{tscene.intersector}`; first call {first:.3f} s; "
        f"steady {dt:.4f} s/frame, {rt / dt / 1e6:.2f} M rays/s",
        "",
    ]

    proto = terrain_mesh(n=128)  # 32k-tri prototype
    rng_np = np.random.default_rng(3)
    insts = [
        Instance(proto, np.asarray(xform.translate(
            (float(rng_np.uniform(-40, 40)), 0.0,
             float(rng_np.uniform(-40, 40)))), np.float32))
        for _ in range(64)
    ]
    iscene = jax.device_put(compile_scene(insts, intersector="auto"))
    first, dt = frame(iscene, tsc.camera, cfg_t)
    lines += [
        f"## Instanced: 64 x {len(np.asarray(proto.indices))} tris "
        "(256x256, 4 spp, depth 5)",
        f"- intersector `{iscene.intersector}`, two-level "
        f"{iscene.instances is not None}; first call {first:.3f} s; "
        f"steady {dt:.4f} s/frame, {rt / dt / 1e6:.2f} M rays/s",
        "",
    ]

    sc2 = cornell_box(256, 256)
    scene2 = jax.device_put(sc2.compile(intersector="auto"))
    cfg32 = PathConfig(spp=4, max_depth=5)
    cfg16 = dataclasses.replace(cfg32, dtypes=RGB_BF16)
    _, t32 = frame(scene2, sc2.camera, cfg32, iters=5)
    _, t16 = frame(scene2, sc2.camera, cfg16, iters=5)
    step, params, _ = bench_step()
    _, t_step = _timeit(lambda: step(params), iters=10)
    lines += [
        "## Cornell 256x256, 4 spp, depth 5",
        f"- forward rgb-float32 {t32 * 1e3:.3f} ms, rgb-bfloat16 "
        f"{t16 * 1e3:.3f} ms; bench fwd+bwd step (unrolled) "
        f"{t_step * 1e3:.3f} ms",
        "",
    ]
    return lines


def main():
    from akari_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    result = primary()
    if "--full" in sys.argv:
        print("\n".join(full_suite()), file=sys.stderr)
    print(json.dumps(result))


if __name__ == "__main__":
    sys.exit(main())
