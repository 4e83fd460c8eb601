"""Scaling benchmark: rays/s at 1..N devices on the 'rays' mesh axis.

On a multi-GPU host this measures real scaling over the device
interconnect; on one card (or the CPU test mesh via JAX_PLATFORMS=cpu
XLA_FLAGS=--xla_force_host_platform_device_count=8) it validates the
harness and the sharding path.

Prints one JSON line per device count plus a final efficiency summary.
"""

import json
import sys
import time


def main():
    import jax
    import jax.numpy as jnp

    from akari_tpu.integrators.path import PathConfig
    from akari_tpu.parallel.mesh import make_ray_mesh
    from akari_tpu.parallel.render import render_sharded
    from akari_tpu.scene.builtin import cornell_box

    width = height = 256
    cfg = PathConfig(spp=4, max_depth=5)
    rays = cfg.spp * width * height * (2 * cfg.max_depth + 1)

    sc = cornell_box(width, height)
    scene = jax.device_put(sc.compile(intersector="auto"))

    n_total = jax.device_count()
    counts = sorted({1, 2, n_total} | {n_total // 2} - {0})
    results = {}
    for n_dev in counts:
        if n_dev > n_total:
            continue
        mesh = make_ray_mesh(n_devices=n_dev)
        fn = jax.jit(
            lambda s, m=mesh: render_sharded(s, sc.camera, cfg, m, seed=0)
        )
        out = fn(scene)
        float(jnp.sum(out))  # compile + sync
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(scene)
        float(jnp.sum(out))
        dt = (time.perf_counter() - t0) / iters
        rps = rays / dt
        results[n_dev] = rps
        print(json.dumps({
            "metric": "rays_per_sec_total",
            "devices": n_dev,
            "value": round(rps, 1),
            "unit": "rays/s",
        }))

    if 1 in results and n_total in results and n_total > 1:
        eff = results[n_total] / (results[1] * n_total)
        print(json.dumps({
            "metric": "scaling_efficiency",
            "devices": n_total,
            "value": round(eff, 4),
            "unit": "fraction_of_linear",
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
