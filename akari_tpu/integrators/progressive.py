"""Progressive (chunked) rendering with progress reporting and
checkpoint/resume.

Analog of the reference's tiled CPU render loop with its
ProgressReporter (ref: src/akari/kernel/integrators/cpu/integrator.cpp:
89-142) — but the bounded resource here is samples-in-flight, not film
tiles: the whole frame's wavefront for a chunk of spp renders per pass
(one compiled program, reused), accumulating into a host-side film.
Long renders survive preemption via utils/checkpoint.py (SURVEY.md §5.3).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.film import Film
from ..utils.checkpoint import load_render_state, save_render_state
from ..utils.progress import ProgressReporter
from .path import PathConfig, render


def render_progressive(
    scene,
    camera,
    cfg: PathConfig,
    seed=0,
    spp_chunk=4,
    checkpoint_path=None,
    checkpoint_every=4,
    progress=True,
    mesh=None,
):
    """Render cfg.spp samples in chunks; returns the developed [H,W,3] image.

    With ``mesh`` set, each chunk renders ray-sharded over the device mesh.
    Resumes from ``checkpoint_path`` when it exists and matches the config.
    """
    import jax

    total = cfg.spp
    start_sample = 0
    acc = np.zeros((camera.height, camera.width, 3), np.float32)
    meta = {
        "w": camera.width, "h": camera.height,
        "spp": cfg.spp, "max_depth": cfg.max_depth,
    }
    if checkpoint_path:
        state = load_render_state(checkpoint_path)
        if state is not None and state[3] == meta and state[2] == seed:
            acc, start_sample = np.asarray(state[0]), state[1]

    reporter = ProgressReporter(total, label="render") if progress else None
    if reporter and start_sample:
        reporter.update(start_sample)

    done = start_sample
    while done < total:
        n = min(spp_chunk, total - done)
        chunk_cfg = dataclasses.replace(cfg, spp=n)
        # each chunk renders samples [done, done+n) of the same stream
        if mesh is not None:
            from ..parallel.render import render_sharded

            img = render_sharded(
                scene, camera, chunk_cfg, mesh, seed=seed, sample_offset=done
            )
        else:
            img = render(scene, camera, chunk_cfg, seed=seed, sample_offset=done)
        acc = acc + np.asarray(jax.block_until_ready(img)) * n
        done += n
        if reporter:
            reporter.update(n)
        if checkpoint_path and (
            done % (checkpoint_every * spp_chunk) == 0 or done >= total
        ):
            save_render_state(checkpoint_path, acc, done, seed, meta)

    film = Film(radiance=acc, weight=np.full((camera.height, camera.width), total, np.float32))
    return film.develop()

