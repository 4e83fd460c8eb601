"""Ray-sharded rendering and loss over a device mesh (shard_map + psum).

Replacement for the reference's tile thread-pool parallelism
(ref: src/akari/core/parallel.cpp:45-130 + mutex film merge,
integrators/cpu/integrator.cpp:115-141): pixels are sharded over the
``rays`` mesh axis, each device traces its slice with the identical
wavefront code, and the film/loss merge is an XLA collective instead of a
mutex. The scene pytree is replicated (in_spec P()); gradients of
replicated scene parameters are summed across shards by shard_map's
transpose of the replication (an all-reduce over the device interconnect),
which is the "gradient all-reduce overlapped with backward" of BASELINE's
north star.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..integrators.path import trace_accumulate


def _trace_block(scene, camera, pixel_idx, *, cfg, seed, sample_offset=0):
    """Trace cfg.spp samples for a block of pixels -> [B,3] mean radiance.

    Dispatches on the integrator config type (Path / BDPT / AO), so every
    integrator renders ray-sharded with the same mesh layout.
    """
    from ..integrators.ao import AOConfig, trace_ao
    from ..integrators.bdpt import BDPTConfig, trace_bdpt
    from ..integrators.path import _jax_intersectors

    if isinstance(cfg, BDPTConfig):
        intersect_fn, occlude_fn, _ = _jax_intersectors(scene)
        n_film = camera.width * camera.height
        # pad lanes (pixel id beyond the film) must not splat: the t=1
        # estimator is normalized for exactly n_film light subpaths.
        lane_mask = pixel_idx < jnp.uint32(n_film)

        def body(carry, s):
            acc, spl = carry
            li, sp = trace_bdpt(
                scene, camera, cfg, seed, s + jnp.uint32(sample_offset),
                pixel_idx, intersect_fn, occlude_fn, jnp,
                lane_mask=lane_mask,
            )
            return (acc + li, spl + sp), None

        (acc, spl), _ = jax.lax.scan(
            body,
            (
                jnp.zeros((pixel_idx.shape[0], 3), jnp.float32),
                jnp.zeros((n_film, 3), jnp.float32),
            ),
            jnp.arange(cfg.spp, dtype=jnp.uint32),
        )
        # splat film covers the WHOLE frame (a light path traced on this
        # shard may splat to a pixel owned by another shard) — the caller
        # psums it across the rays axis.
        return acc / cfg.spp, spl / cfg.spp
    if isinstance(cfg, AOConfig):
        intersect_fn, occlude_fn, _ = _jax_intersectors(scene)

        def body_ao(acc, s):
            li = trace_ao(
                scene, camera, cfg, seed, s + jnp.uint32(sample_offset),
                pixel_idx, intersect_fn, occlude_fn, jnp,
            )
            return acc + li, None

        acc, _ = jax.lax.scan(
            body_ao,
            jnp.zeros((pixel_idx.shape[0], 3), jnp.float32),
            jnp.arange(cfg.spp, dtype=jnp.uint32),
        )
        return acc / cfg.spp
    return trace_accumulate(
        scene, camera, cfg, seed, pixel_idx, sample_offset=sample_offset
    )


def render_sharded(scene, camera, cfg, mesh, seed=0, sample_offset=0):
    """Full-frame render with pixels sharded over mesh axis 'rays'.

    Returns [H, W, 3]. Pixel count is padded to a multiple of the axis size.
    """
    from ..integrators.bdpt import BDPTConfig

    n = camera.width * camera.height
    n_dev = mesh.shape["rays"]
    pad = (-n) % n_dev
    pixel_idx = jnp.arange(n + pad, dtype=jnp.uint32)

    if isinstance(cfg, BDPTConfig):
        # BDPT additionally produces a whole-film t=1 splat image per
        # shard; psum merges the shards' splats (the collective replaces
        # the reference's mutex-guarded film merge).
        def shard_fn(scene, camera, pixel_idx):
            rad, spl = _trace_block(
                scene, camera, pixel_idx, cfg=cfg, seed=seed,
                sample_offset=sample_offset,
            )
            return rad, jax.lax.psum(spl, "rays")

        fn = shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(), P(), P("rays")),
            out_specs=(P("rays"), P()),
            check_vma=False,
        )
        radiance, splat = fn(scene, camera, pixel_idx)
        img = radiance[:n] + splat
        return img.reshape(camera.height, camera.width, 3)

    fn = shard_map(
        partial(_trace_block, cfg=cfg, seed=seed, sample_offset=sample_offset),
        mesh=mesh,
        in_specs=(P(), P(), P("rays")),
        out_specs=P("rays"),
        check_vma=False,
    )
    radiance = fn(scene, camera, pixel_idx)
    return radiance[:n].reshape(camera.height, camera.width, 3)


def loss_and_image_sharded(scene, camera, cfg, mesh, target, seed=0):
    """Sharded MSE loss against a target image (+ the rendered image).

    The loss psum runs over the device interconnect; differentiating this function yields
    scene-parameter gradients that are all-reduced across shards by the
    shard_map transpose. Target: [H, W, 3].
    """
    n = camera.width * camera.height
    n_dev = mesh.shape["rays"]
    pad = (-n) % n_dev
    pixel_idx = jnp.arange(n + pad, dtype=jnp.uint32)
    target_flat = target.reshape(-1, 3)
    if pad:
        target_flat = jnp.concatenate(
            [target_flat, jnp.zeros((pad, 3), jnp.float32)]
        )
    valid = (jnp.arange(n + pad) < n).astype(jnp.float32)[:, None]

    from ..integrators.bdpt import BDPTConfig

    def shard_fn(scene, camera, pixel_idx, target_px, valid_px):
        out = _trace_block(scene, camera, pixel_idx, cfg=cfg, seed=seed)
        if isinstance(cfg, BDPTConfig):
            radiance, spl = out
            spl = jax.lax.psum(spl, "rays")  # whole-film t=1 splats
            if pad:
                spl = jnp.concatenate([spl, jnp.zeros((pad, 3), jnp.float32)])
            blk = pixel_idx.shape[0]
            i = jax.lax.axis_index("rays")
            radiance = radiance + jax.lax.dynamic_slice_in_dim(
                spl, i * blk, blk
            )
        else:
            radiance = out
        sq = jnp.sum(((radiance - target_px) * valid_px) ** 2)
        total = jax.lax.psum(sq, "rays")
        return total / (n * 3), radiance

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P("rays"), P("rays"), P("rays")),
        out_specs=(P(), P("rays")),
        check_vma=False,
    )
    loss, radiance = fn(scene, camera, pixel_idx, target_flat, valid)
    return loss, radiance[:n].reshape(camera.height, camera.width, 3)
