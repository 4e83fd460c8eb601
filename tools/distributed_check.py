"""Real multi-process jax.distributed exercise on CPU devices.

Two OS processes, each with 4 virtual CPU devices, connect through
``akari_tpu.parallel.mesh.initialize_distributed`` into one 8-device
global mesh; both render across ALL 8 devices (collectives cross the
process boundary) and assert equality with the single-process render.

The workload is big enough to expose sharding bugs, not just prove the
plumbing runs:

- 131x131 path-traced frame — 17161 pixels, NOT divisible by 8, so the
  pixel-axis padding path is exercised cross-process.
- a BDPT render on the same mesh: the whole-film t=1 splat is psum'd
  across processes and compared against the single-process BDPT frame
  (this is the film-merge collective the reference does with a mutex,
  ref: integrators/cpu/integrator.cpp:138-140). The non-divisible pixel
  count also pins the splat lane-mask (pad lanes must not splat).

Run:  python tools/distributed_check.py            (parent; spawns workers)
      writes a JSON summary to stdout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

COORD = "127.0.0.1:29784"
W, H, SPP, DEPTH = 131, 131, 2, 3
BW, BH = 33, 33  # BDPT frame (33*33 = 1089, also not divisible by 8)


def _render_means():
    """Sharded renders over the full (possibly multi-process) mesh ->
    replicated scalar means (path, bdpt)."""
    import jax
    import jax.numpy as jnp

    from akari_tpu.integrators.bdpt import BDPTConfig
    from akari_tpu.integrators.path import PathConfig
    from akari_tpu.parallel.mesh import make_ray_mesh
    from akari_tpu.parallel.render import render_sharded
    from akari_tpu.scene.builtin import cornell_box

    mesh = make_ray_mesh()

    sc = cornell_box(W, H)
    scene = sc.compile(intersector="bvh")
    cfg = PathConfig(spp=SPP, max_depth=DEPTH)
    mean_pt = float(jax.jit(
        lambda: jnp.mean(render_sharded(scene, sc.camera, cfg, mesh, seed=0))
    )())

    scb = cornell_box(BW, BH)
    sceneb = scb.compile(intersector="bvh")
    cfgb = BDPTConfig(spp=1, eye_depth=3, light_depth=2)
    mean_bdpt = float(jax.jit(
        lambda: jnp.mean(render_sharded(sceneb, scb.camera, cfgb, mesh, seed=0))
    )())
    return mean_pt, mean_bdpt, jax.device_count(), jax.local_device_count()


def worker(process_id, expect_pt, expect_bdpt):
    from akari_tpu.parallel.mesh import initialize_distributed

    initialize_distributed(
        coordinator=COORD, num_processes=2, process_id=process_id
    )
    mean_pt, mean_bdpt, n_dev, n_local = _render_means()
    assert n_dev == 8 and n_local == 4, (n_dev, n_local)
    rel_pt = abs(mean_pt - expect_pt) / max(abs(expect_pt), 1e-12)
    rel_bdpt = abs(mean_bdpt - expect_bdpt) / max(abs(expect_bdpt), 1e-12)
    print(
        json.dumps(
            {
                "process_id": process_id,
                "devices": n_dev,
                "local_devices": n_local,
                "pixels": W * H,
                "mean_pt": mean_pt,
                "rel_err_pt": rel_pt,
                "mean_bdpt": mean_bdpt,
                "rel_err_bdpt": rel_bdpt,
            }
        ),
        flush=True,
    )
    assert rel_pt < 1e-5, (mean_pt, expect_pt)
    assert rel_bdpt < 1e-5, (mean_bdpt, expect_bdpt)


def main():
    # single-process golden (8 local devices)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    out = subprocess.run(
        [sys.executable, __file__, "--golden"],
        env=env, capture_output=True, text=True, timeout=1800,
    )
    if out.returncode != 0:
        print(out.stdout + out.stderr)
        raise SystemExit("golden run failed")
    golden_pt, golden_bdpt = (
        float(x) for x in out.stdout.strip().splitlines()[-1].split()
    )

    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "--worker", str(pid),
             str(golden_pt), str(golden_bdpt)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in range(2)
    ]
    results, ok = [], True
    for p in procs:
        so, se = p.communicate(timeout=1800)
        if p.returncode != 0:
            ok = False
            print(se[-4000:], file=sys.stderr)
        else:
            results.append(json.loads(so.strip().splitlines()[-1]))
    print(json.dumps({
        "ok": ok, "golden_mean_pt": golden_pt,
        "golden_mean_bdpt": golden_bdpt, "workers": results,
    }))
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    if "--golden" in sys.argv:
        mean_pt, mean_bdpt, n_dev, _ = _render_means()
        assert n_dev == 8, n_dev
        print(mean_pt, mean_bdpt)
    elif "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        worker(int(sys.argv[i + 1]), float(sys.argv[i + 2]),
               float(sys.argv[i + 3]))
    else:
        main()
