"""Inverse rendering: recover scene parameters from target images.

Entirely new capability vs the reference (its autodiff.h is an empty stub,
ref: src/akari/common/autodiff.h:26-39). BASELINE config 4: recover albedo
textures + emitter radiance on the Cornell box via pixel-loss gradients
with Adam. The renderer is differentiable end-to-end through shading
(detached-hit convention, ops/intersect.py); the optimizable leaves are
``TextureTable.value`` (constant colors / image multipliers, which covers
both albedo and emitter radiance) and ``TextureTable.images``.

Multi-chip: gradients of the replicated texture parameters are all-reduced
across the ray shards by shard_map's transpose (parallel/render.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import numpy as np
import jax.numpy as jnp
import optax

from ..parallel.render import loss_and_image_sharded


@dataclass(frozen=True)
class InverseConfig:
    iterations: int = 100
    learning_rate: float = 5e-2
    optimize_images: bool = False  # also optimize image-texture texels
    seed: int = 0
    # "constant" | "cosine": cosine decays the lr to 5% over the run —
    # with a fixed lr the Adam iterates orbit the optimum at a noise
    # floor set by the MC gradient variance (r4 recovery: loss bounced
    # 0.008 <-> 0.015 after iter ~450 and parameters stayed off).
    lr_schedule: str = "constant"
    # ((start_fraction, spp), ...): per-phase spp override of the render
    # config — late iterations use more samples (less gradient noise)
    # right where the schedule needs precision. Each distinct spp is one
    # extra jit compile. Empty = render_cfg.spp throughout.
    spp_ramp: tuple = ()
    # Polyak/EMA averaging of the LATE iterates (starts at half the run):
    # 0 disables; e.g. 0.98 returns an exponential average whose MC
    # noise is ~sqrt((1-d)/2) of the final iterate's.
    param_ema: float = 0.0
    # "linear" | "log": optimize texture values in log space. Adam's
    # per-parameter step magnitude is ~lr, so a LINEAR-space emitter that
    # must travel 7 -> 17 radiance units needs >= (10/lr) iterations no
    # matter the gradients (the r4 recovery stalled exactly there); in
    # log space the same travel is ln(17/7) ~ 0.9 units. Positivity is
    # automatic. tri_delta (signed) stays linear.
    param_space: str = "linear"


def scene_params(scene, optimize_images=False, optimize_geometry=False):
    """Extract the optimizable parameter pytree from a compiled scene.

    ``optimize_geometry`` adds ``tri_delta`` [T,3]: a per-storage-triangle
    world-space translation, applied to the differentiable geometry uses
    (hit positions via the prim_table gather, NEE light-sample positions,
    geometric normals via e1/e2 — all in integrators/path.py +
    shading/light.py). Through the render alone, gradients are the
    **interior** (reparameterized-barycentric, detached-hit) term; the
    **visibility/silhouette boundary term** is provided separately by
    ``diff/boundary.py::boundary_direct_term`` (edge-sampled, add its
    surrogate to the rendered image inside the loss — FD-verified in
    tests/test_boundary.py). Note the acceleration structures are built
    for the undisplaced geometry — after large accumulated deltas,
    re-``compile()`` the scene.
    """
    params = {"tex_value": scene.textures.value}
    if optimize_images:
        params["tex_images"] = scene.textures.images
    if optimize_geometry:
        if scene.instances is not None:
            # On a two-level scene tri_v0 is shared BLAS *object* space:
            # one delta would move every instance at once, silently
            # different semantics from the documented world-space move.
            raise ValueError(
                "optimize_geometry=True requires a flat (non-instanced) "
                "scene; recompile with a dense intersector ('brute' or "
                "'pallas'), which flattens instances to world space"
            )
        params["tri_delta"] = jnp.zeros_like(jnp.asarray(scene.tri_v0))
    return params


def apply_params(scene, params):
    """Write a parameter pytree back into the scene (functional update)."""
    import dataclasses

    tex = scene.textures
    tex = dataclasses.replace(tex, value=params["tex_value"])
    if "tex_images" in params:
        tex = dataclasses.replace(tex, images=params["tex_images"])
    scene = dataclasses.replace(scene, textures=tex)
    if "tri_delta" in params:
        d = params["tri_delta"]
        repl = {"tri_v0": jnp.asarray(scene.tri_v0) + d}
        if scene.prim_table is not None:
            # keep the fat shading table coherent (v0 lives in cols 0:3)
            repl["prim_table"] = (
                jnp.asarray(scene.prim_table).at[:, 0:3].add(d)
            )
        scene = dataclasses.replace(scene, **repl)
    return scene


def inverse_render(scene, camera, render_cfg, target, mesh, cfg=None):
    """Adam loop recovering texture parameters to match ``target`` [H,W,3].

    Returns (recovered_scene, losses list, final_image).
    """
    import dataclasses

    cfg = cfg or InverseConfig()
    params = scene_params(scene, cfg.optimize_images)
    log_space = cfg.param_space == "log"

    def to_raw(p):
        if not log_space:
            return p
        return {
            k: (v if k == "tri_delta" else jnp.exp(v))
            for k, v in p.items()
        }

    if log_space:
        params = {
            k: (v if k == "tri_delta"
                else jnp.log(jnp.maximum(jnp.asarray(v), 1e-4)))
            for k, v in params.items()
        }
    if cfg.lr_schedule == "cosine":
        lr = optax.cosine_decay_schedule(
            cfg.learning_rate, cfg.iterations, alpha=0.05
        )
    else:
        lr = cfg.learning_rate
    tx = optax.adam(lr)
    opt_state = tx.init(params)

    def make_step(rc):
        def loss_fn(params, seed):
            s = apply_params(scene, to_raw(params))
            loss, img = loss_and_image_sharded(
                s, camera, rc, mesh, target, seed=seed
            )
            return loss, img

        @partial(jax.jit, donate_argnums=(0, 1))
        def step(params, opt_state, seed):
            (loss, img), grads = jax.value_and_grad(
                loss_fn, has_aux=True
            )(params, seed)
            # MC gradient estimates can contain stray non-finite lanes;
            # zero them rather than poisoning the Adam moments.
            grads = jax.tree_util.tree_map(
                lambda g: jnp.where(jnp.isfinite(g), g, 0.0), grads
            )
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            # texture parameters are physically non-negative
            # (albedo/radiance); keep a tiny positive floor (linear) or a
            # sane range (log). Geometry deltas are signed, unclamped.
            if log_space:
                params = {
                    k: (p if k == "tri_delta"
                        else jnp.clip(p, np.log(1e-4), np.log(1e4)))
                    for k, p in params.items()
                }
            else:
                params = {
                    k: (p if k == "tri_delta" else jnp.maximum(p, 1e-4))
                    for k, p in params.items()
                }
            return params, opt_state, loss, img

        return step

    # per-phase spp: each distinct spp compiles its own step
    phases = [(0, render_cfg)]
    for frac, spp in cfg.spp_ramp:
        phases.append(
            (int(frac * cfg.iterations),
             dataclasses.replace(render_cfg, spp=int(spp)))
        )
    phases.sort(key=lambda x: x[0])
    steps = [(start, make_step(rc)) for start, rc in phases]

    ema = None
    ema_start = cfg.iterations // 2
    losses = []
    img = None
    for it in range(cfg.iterations):
        step = next(s for start, s in reversed(steps) if it >= start)
        params, opt_state, loss, img = step(
            params, opt_state, jnp.uint32(cfg.seed + it)
        )
        losses.append(float(loss))
        if cfg.param_ema > 0.0 and it >= ema_start:
            if ema is None:
                # explicit copy: ``params`` is donated into the next step
                ema = jax.tree_util.tree_map(lambda p: p * 1.0, params)
            else:
                d = cfg.param_ema
                ema = jax.tree_util.tree_map(
                    lambda e, p: e * d + p * (1.0 - d), ema, params
                )
    final = ema if ema is not None else params
    return apply_params(scene, to_raw(final)), losses, img
