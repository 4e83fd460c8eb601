"""Render CLI — the ``akari`` equivalent (ref: src/akari/cmd/akari.cpp:41-102).

Usage: python -m akari_tpu.cli.render -i scene.akari [-o out.png] [--spp N]
       [--intersector auto|bvh|brute|pallas] [--ao] [-v]
"""

from __future__ import annotations

import argparse
import functools
import sys
import time


@functools.cache
def _jitted(fn):
    """One jitted program per render function, kept for the process (a
    second ``main`` call with the same scene shapes reuses it). The scene
    and camera are arguments, not constants baked into the program."""
    import jax

    return jax.jit(fn, static_argnames=("cfg", "seed"))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="akari-render")
    ap.add_argument("-i", "--input", required=True, help="scene .akari file")
    ap.add_argument("-o", "--output", default=None,
                    help="output image path (.png, or .npy/.hdr for linear "
                         "float radiance)")
    ap.add_argument("--spp", type=int, default=None, help="override spp")
    ap.add_argument("--max-depth", type=int, default=None)
    ap.add_argument("--intersector", default="auto",
                    choices=["auto", "bvh", "brute", "pallas"])
    ap.add_argument("--spectrum-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="numeric variant for radiance/throughput "
                         "(ref: akari.conf Config<Float,Spectrum>)")
    ap.add_argument("--width", type=int, default=None,
                    help="override output width (camera resolution)")
    ap.add_argument("--height", type=int, default=None,
                    help="override output height")
    ap.add_argument("--ao", action="store_true", help="ambient occlusion mode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sharded", action="store_true",
                    help="shard rays over all local devices")
    ap.add_argument("--profile", action="store_true",
                    help="print a per-phase timing table after rendering "
                         "(ref: print_kernel_stats)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    from ..utils.logger import get_logger, set_verbose

    log = get_logger()
    if args.verbose:
        set_verbose(True)

    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from ..core.image import write_image
    from ..integrators.ao import AOConfig, render_ao
    from ..integrators.path import PathConfig, render
    from ..scene import sdl

    log.info(f"parsing {args.input}")
    try:
        module = sdl.parse_file(args.input)
    except FileNotFoundError:
        log.error(f"scene file not found: {args.input}")
        return 1
    except sdl.SDLError as e:
        log.error(f"parse error: {e}")
        return 1
    scene_node = module.exports.get("scene")
    if scene_node is None:
        log.error("no exported 'scene' found")  # ref: akari.cpp:84-88
        return 1

    t0 = time.perf_counter()
    scene = scene_node.compile(intersector=args.intersector)
    camera = scene_node.camera
    if args.width or args.height:
        import dataclasses as _dc

        camera = _dc.replace(
            camera,
            width=args.width or camera.width,
            height=args.height or camera.height,
        )
    log.info(
        f"scene compiled: {scene.n_tris} tris, {scene.n_materials} materials, "
        f"{scene.bvh.first.shape[0]} BVH nodes ({time.perf_counter() - t0:.2f}s)"
    )

    import dataclasses

    import numpy as np

    from ..integrators.bdpt import BDPTConfig, render_bdpt
    from ..utils.profiler import Profiler

    prof = Profiler() if args.profile else None

    def frame(name):
        import contextlib

        return prof.frame(name) if prof else contextlib.nullcontext()

    cfg = scene_node.integrator or PathConfig()
    t0 = time.perf_counter()
    if args.spectrum_dtype != "float32" and (
        args.ao or isinstance(cfg, (AOConfig, BDPTConfig))
    ):
        log.warning(
            f"--spectrum-dtype {args.spectrum_dtype} only applies to the "
            "path integrator; the AO/BDPT integrators run float32"
        )
    if args.ao or isinstance(cfg, AOConfig):
        if not isinstance(cfg, AOConfig):
            cfg = AOConfig(spp=args.spp or 16)
        if args.spp:
            cfg = dataclasses.replace(cfg, spp=args.spp)
        with frame("render/ao"):
            img = render_ao(scene, camera, cfg, seed=args.seed)
            img = np.asarray(img)
    elif isinstance(cfg, BDPTConfig):
        if args.spp:
            cfg = dataclasses.replace(cfg, spp=args.spp)
        with frame("render/bdpt"):
            img = render_bdpt(scene, camera, cfg, seed=args.seed)
            img = np.asarray(img)
    else:
        if args.spp:
            cfg = dataclasses.replace(cfg, spp=args.spp)
        if args.max_depth:
            cfg = dataclasses.replace(cfg, max_depth=args.max_depth)
        if args.spectrum_dtype != "float32":
            from ..utils.config import RGB_BF16, variant_string

            cfg = dataclasses.replace(cfg, dtypes=RGB_BF16)
            log.info(f"variant: {variant_string(cfg.dtypes)}")
        if args.sharded:
            from ..parallel.mesh import make_ray_mesh
            from ..parallel.render import render_sharded

            with frame("render/path-sharded"):
                img = render_sharded(
                    scene, camera, cfg, make_ray_mesh(), seed=args.seed
                )
                img = np.asarray(img)
        else:
            with frame("render/path"):
                img = _jitted(render)(scene, camera, cfg=cfg, seed=args.seed)
                img = np.asarray(img)
    dt = time.perf_counter() - t0
    rays = cfg.spp * camera.width * camera.height
    log.info(f"render done took ({dt:.3f}s)  [{rays / dt / 1e6:.2f} Mpaths/s]")

    out = args.output or scene_node.output
    with frame("write_image"):
        write_image(out, img)
    log.info(f"wrote {out}")
    if prof:
        prof.print_stats()  # ref: print_kernel_stats (cuda/launch.cpp:92-117)
    return 0


if __name__ == "__main__":
    sys.exit(main())
