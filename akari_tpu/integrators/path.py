"""Wavefront path tracer with NEE + MIS.

Capability parity with the reference's three integrator variants —
CPU megakernel (ref: src/akari/kernel/pathtracer.h:133-164 run_megakernel),
GPU megakernel and GPU wavefront (ref: kernel/integrators/gpu/cuda/
integrator.cpp:106-424) — expressed the JAX way (SURVEY.md §2.7):

* The wavefront decomposition (SoA PathState + per-depth kernel sweeps
  with atomic-append work queues) is *the natural JAX formulation*: a
  ``PathState`` pytree stepped through a fixed per-bounce sweep with an
  ``active`` mask. No atomics — inactive lanes are masked; XLA fuses the
  whole bounce into large fused kernels.
* Layout: every per-ray quantity in the bounce loop is a 1-D ``[N]``
  array and every 3-vector/RGB a ``V3`` of components (core/v3.py) — the
  wavefront equivalent of the reference's soac-generated SoA work items
  (ref: common/soa.h:47-104, tools/soac.cpp).
* The reference's per-material-type queues (one queue per Material variant)
  become masked evaluation of the BSDF closures — see shading/soa.py.
* Improvement over the reference: full multiple importance sampling
  (power heuristic) between NEE and BSDF sampling; the reference is
  NEE-only with depth-0 emissive (pathtracer.h:102-111). ``mis=False``
  reproduces the reference's estimator for golden comparisons.

The bounce loop is backend-generic (jax.numpy or numpy): the NumPy oracle
(oracle/renderer.py) runs this exact code with ``xp=numpy`` and a brute
intersector, giving matched-sampler-seed golden images by construction.

Differentiability: the hit record is detached (ops/intersect.py); radiance
is differentiable w.r.t. texture values / images / emitter radiance.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import sampling
from ..core import rng
from ..core.v3 import V3, from_rows, from_stack, v3where
from ..core.vecmath import _xp, cross, dot, normalize
from ..shading import soa
from ..utils.config import RGB, DtypePolicy

RAY_EPS = 1e-4
SHADOW_EPS = 1e-3
# Intersectors that test every triangle, so a shadow query costs the same
# as a closest-hit one and both can share a launch.
DENSE_INTERSECTORS = ("pallas", "brute")


@dataclass(frozen=True)
class PathConfig:
    """ref: nodes/integrator.cpp:42-57 (spp, max_depth, ray_clamp) + mis."""

    spp: int = 4
    max_depth: int = 5
    # Numeric variant (ref: akari.conf Config<Float,Spectrum>): L/beta are
    # carried across the bounce scan in dtypes.spectrum.
    dtypes: DtypePolicy = RGB
    # estimator: True = NEE+MIS; False = NEE-only w/ depth-0 emission
    # (the reference's estimator); "bsdf" = BSDF-sampling only with emission
    # at every depth (no NEE) — slowest-converging but simplest unbiased
    # estimator, used as an independent cross-check in tests.
    mis: object = True
    ray_clamp: float = 10.0   # firefly clamp on per-sample radiance (ref: ray_clamp)
    rr_start: int = 100       # russian roulette start depth (off by default)
    # True unrolls the bounce loop in the traced program (lets XLA
    # specialize per bounce, ~max_depth x the compile time); False scans.
    unroll: bool = False
    # True wraps each scan bounce in jax.checkpoint with a policy that
    # saves ONLY the intersection results: the backward recomputes the
    # (cheap, SoA) shading math instead of materializing thousands of
    # per-bounce residual slices, and never re-runs the intersection.
    remat: bool = True


def camera_rays_soa(camera, seed, sample_idx, pixel_idx, xp):
    """Generate primary rays for flat pixel indices [N] -> (V3 o, V3 d).

    Raster-to-camera chain redesigned from ref kernel/camera.h:45-61 with
    the standard tan(fov/2) image-plane scale; camera looks down -Z.
    """
    jx = rng.uniform(seed, pixel_idx, sample_idx, rng.DIM_CAMERA)
    jy = rng.uniform(seed, pixel_idx, sample_idx, rng.DIM_CAMERA + 1)
    w, h = camera.width, camera.height
    x = (pixel_idx % w).astype(xp.float32) + jx
    y = (pixel_idx // w).astype(xp.float32) + jy
    ndc_x = 2.0 * (x / w) - 1.0
    ndc_y = 1.0 - 2.0 * (y / h)  # flip v (ref camera.h scale(1,-1,1))
    t = camera.tan_half_fov
    if w > h:
        sx, sy = t, t * (h / w)
    else:
        sx, sy = t * (w / h), t
    d_cam = V3(ndc_x * sx, ndc_y * sy, -xp.ones_like(ndc_x))
    o_cam = V3(
        xp.zeros_like(ndc_x), xp.zeros_like(ndc_x), xp.zeros_like(ndc_x)
    )

    lens_r = camera.lens_radius
    # Thin-lens DoF (ref camera.h:68-88). Static (metadata) switch.
    if lens_r > 0.0:
        u1 = rng.uniform(seed, pixel_idx, sample_idx, rng.DIM_LENS)
        u2 = rng.uniform(seed, pixel_idx, sample_idx, rng.DIM_LENS + 1)
        px, py = soa.concentric_disk(u1, u2)
        px, py = px * lens_r, py * lens_r
        d_len = xp.sqrt(d_cam.dot(d_cam))
        ft = camera.focal_distance / xp.abs(d_cam.z / d_len)
        p_focus = d_cam.normalized() * ft
        o_cam = V3(px, py, xp.zeros_like(px))
        d_cam = p_focus - o_cam

    c2w = xp.asarray(camera.c2w)
    r = [[c2w[i, j] for j in range(3)] for i in range(3)]

    def apply_rot(v):
        return V3(
            r[0][0] * v.x + r[0][1] * v.y + r[0][2] * v.z,
            r[1][0] * v.x + r[1][1] * v.y + r[1][2] * v.z,
            r[2][0] * v.x + r[2][1] * v.y + r[2][2] * v.z,
        )

    o = apply_rot(o_cam) + V3(c2w[0, 3], c2w[1, 3], c2w[2, 3])
    d = apply_rot(d_cam).normalized()
    return o, d


def camera_rays(camera, seed, sample_idx, pixel_idx, xp):
    """AoS wrapper: -> ([N,3] o, [N,3] d) for the BDPT/AO integrators."""
    o, d = camera_rays_soa(camera, seed, sample_idx, pixel_idx, xp)
    return o.stack(xp), d.stack(xp)


def _vertex_data(scene, prim, bu, bv, xp):
    """Gather ALL hit-surface attributes for [N] prim ids + [N] barys.

    Flat scenes: ONE fat row gather from ``scene.prim_table``
    (-> [32, N], ops/gather.py) — the shading path's entire per-hit
    memory traffic. Instanced scenes decode virtual
    prim ids and transform prototype geometry to world space
    (scene/geom.py) — a static branch.

    Returns a dict of V3/[N]: p, ng, ns, uv_u, uv_v, mat_id, e1, e2,
    light_pdf (the hit triangle's NEE selection pmf; 0 for non-lights —
    powers MIS without a second gather).
    """
    pid = xp.maximum(prim, 0)
    if scene.prim_table is not None and scene.instances is None:
        from ..ops.gather import gather_rows_t

        fat = gather_rows_t(scene.prim_table, pid)
        v0, e1, e2 = from_rows(fat, 0), from_rows(fat, 3), from_rows(fat, 6)
        n0, n1, n2 = from_rows(fat, 9), from_rows(fat, 12), from_rows(fat, 15)
        uv0u, uv0v, uv1u, uv1v, uv2u, uv2v = (
            fat[18], fat[19], fat[20], fat[21], fat[22], fat[23]
        )
        mat_id = fat[24].astype(xp.int32)
        light_pdf = fat[25]
    else:
        from ..scene import geom

        v0_a, e1_a, e2_a = geom.tri_world(scene, pid, xp)
        v0, e1, e2 = from_stack(v0_a), from_stack(e1_a), from_stack(e2_a)
        ns_c = geom.normals_world(scene, pid, xp)  # [N,3,3]
        n0, n1, n2 = (
            from_stack(ns_c[:, 0]), from_stack(ns_c[:, 1]), from_stack(ns_c[:, 2])
        )
        uv_c = geom.uvs_of_prim(scene, pid, xp)  # [N,3,2]
        uv0u, uv0v = uv_c[:, 0, 0], uv_c[:, 0, 1]
        uv1u, uv1v = uv_c[:, 1, 0], uv_c[:, 1, 1]
        uv2u, uv2v = uv_c[:, 2, 0], uv_c[:, 2, 1]
        mat_id = geom.mat_of_prim(scene, pid, xp)
        li = geom.light_of_prim(scene, pid, xp)
        light_pdf = xp.where(
            li >= 0, xp.take(scene.lights.pdf, xp.maximum(li, 0)), 0.0
        )
    p = v0 + e1 * bu + e2 * bv
    ng = e1.cross(e2).normalized(eps=1e-20)
    w0 = 1.0 - bu - bv
    ns = (n0 * w0 + n1 * bu + n2 * bv).normalized(eps=1e-12)
    # fall back to ng for degenerate shading normals
    ns = v3where(ns.dot(ns) > 0.5, ns, ng)
    uv_u = uv0u * w0 + uv1u * bu + uv2u * bv
    uv_v = uv0v * w0 + uv1v * bu + uv2v * bv
    return {
        "p": p, "ng": ng, "ns": ns, "uv_u": uv_u, "uv_v": uv_v,
        "mat_id": mat_id, "e1": e1, "e2": e2, "light_pdf": light_pdf,
    }


def _surface_data(scene, prim, bary, xp):
    """Hit attributes as the classic AoS 5-tuple (p, ng, ns, uv, mat_id)
    for the BDPT/AO integrators. ``bary`` is [N,2]."""
    vd = _vertex_data(scene, prim, bary[..., 0], bary[..., 1], xp)
    uv = xp.stack([vd["uv_u"], vd["uv_v"]], axis=-1)
    return (
        vd["p"].stack(xp), vd["ng"].stack(xp), vd["ns"].stack(xp), uv,
        vd["mat_id"],
    )


def trace_paths(
    scene,
    camera,
    cfg,
    seed,
    sample_idx,
    pixel_idx,
    intersect_fn,
    occlude_fn,
    xp,
    fused_fn=None,
):
    """Trace one sample per pixel; returns [N,3] radiance.

    ``intersect_fn(o, d) -> (t, prim, u, v, valid)`` on V3 rays;
    ``occlude_fn(o, d, t_min, t_max) -> occluded`` — injected so the same
    code runs on JAX (BVH/Pallas) and NumPy (oracle brute force).
    ``fused_fn(shadow_o, shadow_d, shadow_tmax, o2, d2) -> (occluded, hit)``
    optionally answers a bounce's shadow ray and the next extension ray in
    a single batched launch (the dense intersectors benefit; the ray sets
    and RNG streams are identical either way).
    """
    o, d = camera_rays_soa(camera, seed, sample_idx, pixel_idx, xp)
    n = o.x.shape[0]
    sdt = cfg.dtypes.spectrum
    zero = xp.zeros((n,), sdt)
    one = xp.ones((n,), sdt)
    L = V3(zero, zero, zero)
    beta = V3(one, one, one)
    active = xp.ones((n,), bool)
    prev_pdf = xp.zeros((n,), xp.float32)

    hit = intersect_fn(o, d)
    state = (hit, o, d, L, beta, active, prev_pdf)

    if xp is not np and not cfg.unroll and cfg.max_depth > 1:
        # lax.scan over the bounce axis: one copy of the bounce graph in
        # the program instead of max_depth copies — cuts compile time
        # ~max_depth-fold. The body is identical to the unrolled path
        # (bounce-dependent logic is branchless), so radiance matches the
        # unrolled/oracle result bit-for-bit up to reduction order.
        import jax

        def body(st, bounce):
            return _bounce_step(
                scene, cfg, seed, sample_idx, pixel_idx, st, bounce,
                intersect_fn, occlude_fn, fused_fn, xp,
            ), None

        if cfg.remat:
            body = jax.checkpoint(
                body,
                policy=jax.checkpoint_policies.save_only_these_names("isect"),
            )
        state, _ = jax.lax.scan(
            body, state, xp.arange(cfg.max_depth, dtype=xp.int32)
        )
    else:
        for bounce in range(cfg.max_depth):
            state = _bounce_step(
                scene, cfg, seed, sample_idx, pixel_idx, state, bounce,
                intersect_fn, occlude_fn, fused_fn, xp,
            )
    L = _emission_term(scene, cfg, state, cfg.max_depth, xp)
    L = L.astype(cfg.dtypes.accum)

    Ls = L.stack(xp)
    if cfg.ray_clamp > 0.0:
        Ls = xp.minimum(Ls, cfg.ray_clamp)
    # kill NaN/Inf lanes defensively (ref clamps too)
    return xp.where(xp.isfinite(Ls), Ls, 0.0)


def _emission_term(scene, cfg, state, bounce, xp, vd=None):
    """Add this vertex's (MIS-weighted) emission to L and return it
    (ref: pathtracer.h:102-111) — plus the environment radiance on lanes
    whose extension ray escaped (once per path: ``active`` still holds
    the pre-miss liveness here and drops to False next bounce).
    ``bounce`` may be traced (scan) or int."""
    (t, prim, bu, bv, valid), o, d, L, beta, active, prev_pdf = state
    has_env = scene.env_image is not None
    escaped = active & ~valid
    active = active & valid
    if vd is None:
        vd = _vertex_data(scene, prim, bu, bv, xp)
    Le, double_sided = soa.emission_and_sided(
        scene.materials, scene.textures, vd["mat_id"], vd["uv_u"], vd["uv_v"]
    )
    front = d.dot(vd["ng"]) < 0.0
    emit_ok = double_sided | front
    n = t.shape[0]
    is_first = xp.asarray(bounce, xp.int32) == 0
    ones = xp.ones((n,), xp.float32)
    if cfg.mis == "bsdf":
        w_emit = ones
    else:
        if cfg.mis:
            nee_pdf = soa.light_pdf_direction_from(
                vd["e1"], vd["e2"], vd["light_pdf"], valid, d, t, double_sided
            )
            if has_env:
                # NEE is a strategy mixture when an env light exists
                nee_pdf = nee_pdf * (1.0 - scene.env_p_select)
            later = sampling.power_heuristic(prev_pdf, nee_pdf)
        else:
            later = xp.zeros((n,), xp.float32)
        w_emit = xp.where(is_first, ones, later)
    L = L + beta * Le * ((active & emit_ok) * w_emit)
    if has_env:
        Le_env = soa.env_eval(scene, d)
        if cfg.mis == "bsdf":
            w_env = ones
        elif cfg.mis:
            env_nee = soa.env_pdf_sa(scene, d) * scene.env_p_select
            w_env = xp.where(
                is_first, ones, sampling.power_heuristic(prev_pdf, env_nee)
            )
        else:
            w_env = xp.where(is_first, ones, xp.zeros((n,), xp.float32))
        L = L + beta * Le_env * (escaped * w_env)
    return L


def _bounce_step(scene, cfg, seed, sample_idx, pixel_idx, state, bounce,
                 intersect_fn, occlude_fn, fused_fn, xp):
    """One full path-vertex step: emission + NEE + BSDF-sample + next hit.

    ``bounce`` may be a traced scalar (lax.scan) or a python int (the
    unrolled/oracle path) — all bounce-dependent logic is branchless.
    """
    (t, prim, bu, bv, valid), o, d, _, beta, active, prev_pdf = state
    vd = _vertex_data(scene, prim, bu, bv, xp)
    L = _emission_term(scene, cfg, state, bounce, xp, vd=vd)
    active = active & valid
    n = t.shape[0]
    p, ng, ns = vd["p"], vd["ng"], vd["ns"]
    wo = -d

    # ---- material selection + closure (ref: material.h:255-297) ----
    u_mix = rng.uniform(seed, pixel_idx, sample_idx, rng.bounce_dim(bounce, rng.OFF_MIX))
    leaf, choice_pdf = soa.select_material(
        scene.materials, scene.textures, vd["mat_id"], u_mix,
        vd["uv_u"], vd["uv_v"],
    )
    params = soa.closure_params(
        scene.materials, scene.textures, leaf, choice_pdf,
        vd["uv_u"], vd["uv_v"],
    )
    frame = soa.make_frame(ns)
    scatterable = active & (params["kind"] != soa.CLOSURE_NULL)

    # ---- next-event estimation setup (ref: pathtracer.h:69-91) ----
    do_nee = (
        scene.lights.n_lights > 0 or scene.env_image is not None
    ) and cfg.mis != "bsdf"
    if do_nee:
        u_sel = rng.uniform(
            seed, pixel_idx, sample_idx, rng.bounce_dim(bounce, rng.OFF_LIGHT_SELECT)
        )
        u_p1 = rng.uniform(
            seed, pixel_idx, sample_idx, rng.bounce_dim(bounce, rng.OFF_LIGHT_U)
        )
        u_p2 = rng.uniform(
            seed, pixel_idx, sample_idx, rng.bounce_dim(bounce, rng.OFF_LIGHT_U) + 1
        )
        ls = soa.light_sample_mixed(scene, u_sel, u_p1, u_p2, p)
        f_nee = soa.eval_world(params, frame, wo, ls.wi)
        cos_nee = xp.abs(ns.dot(ls.wi))
        contrib_scale = xp.where(
            ls.pdf > 1e-12, 1.0 / xp.maximum(ls.pdf, 1e-12), 0.0
        )
        nee_contrib = beta * f_nee * ls.L * (cos_nee * contrib_scale)
        useful = scatterable & ls.valid & (nee_contrib.max_comp() > 0.0)
        shadow_o = p + ls.wi * (
            RAY_EPS / xp.maximum(xp.abs(ng.dot(ls.wi)), 1e-4)
        )
        shadow_tmax = ls.dist * (1.0 - SHADOW_EPS)
        if cfg.mis:
            pdf_bsdf_nee = soa.pdf_world(params, frame, wo, ls.wi)
            w_nee = sampling.power_heuristic(ls.pdf, pdf_bsdf_nee)
        else:
            w_nee = xp.ones((n,), xp.float32)

    # ---- BSDF sampling (ref: pathtracer.h on_surface_scatter) ----
    u_b1 = rng.uniform(
        seed, pixel_idx, sample_idx, rng.bounce_dim(bounce, rng.OFF_BSDF_U)
    )
    u_b2 = rng.uniform(
        seed, pixel_idx, sample_idx, rng.bounce_dim(bounce, rng.OFF_BSDF_U) + 1
    )
    wi, f, pdf = soa.sample_world(params, frame, wo, u_b1, u_b2)
    cos_wi = xp.abs(ns.dot(wi))
    ok = scatterable & (pdf > 1e-9)
    throughput = f * (cos_wi / xp.maximum(pdf, 1e-9))
    beta = v3where(ok, beta * throughput, beta)

    # russian roulette (new capability; off by default to match ref).
    # Enabled statically when rr can trigger within max_depth; the
    # per-bounce gate is branchless (bounce may be traced).
    if cfg.rr_start < cfg.max_depth:
        u_rr = rng.uniform(
            seed, pixel_idx, sample_idx, rng.bounce_dim(bounce, rng.OFF_RR)
        )
        q = xp.clip(beta.max_comp(), 0.05, 1.0)
        rr_on = xp.asarray(bounce, xp.int32) >= cfg.rr_start  # 0-d bool
        survive = xp.where(rr_on, u_rr < q, True)
        beta = v3where(rr_on, beta * (1.0 / q), beta)
        ok = ok & survive

    o = p + wi * (RAY_EPS / xp.maximum(xp.abs(ng.dot(wi)), 1e-4))
    d = wi

    # ---- shadow + next extension rays (one fused launch if possible) ----
    # Inactive lanes get t_max = 0 ("dead rays"): their results are
    # masked out below anyway, and the BVH walk culls them at the root
    # (their best_t <= t_min fails every slab test) — on open scenes most
    # lanes are dead by bounce 2-3.
    from ..ops.intersect import T_MAX

    ext_tmax = xp.where(ok, xp.float32(T_MAX), xp.float32(0.0))
    if do_nee:
        shadow_tmax = xp.where(useful, shadow_tmax, xp.float32(0.0))
    if do_nee and fused_fn is not None:
        occluded, hit = fused_fn(shadow_o, ls.wi, shadow_tmax, o, d, ext_tmax)
    else:
        if do_nee:
            occluded = occlude_fn(
                shadow_o, ls.wi, xp.zeros((n,), xp.float32), shadow_tmax
            )
        hit = intersect_fn(o, d)
    if xp is not np:
        # tag intersection results as remat save-points (PathConfig.remat):
        # the backward recompute then reads them instead of re-launching.
        from jax.ad_checkpoint import checkpoint_name

        hit = checkpoint_name(hit, "isect")
        if do_nee:
            occluded = checkpoint_name(occluded, "isect")
    if do_nee:
        L = L + nee_contrib * ((useful & ~occluded) * w_nee)

    # Carry the wavefront's spectrum state in the configured variant dtype
    # (mixed-dtype arithmetic above promotes to f32; cast back on the way
    # into the scan carry so bf16 actually halves the live state).
    sdt = cfg.dtypes.spectrum
    return (hit, o, d, L.astype(sdt), beta.astype(sdt), ok, pdf)


def _jax_intersectors_soa(scene):
    import jax.numpy as jnp

    from ..ops.intersect import T_MAX, intersect_soa, occlude_soa

    def intersect_fn(o, d):
        h = intersect_soa(scene, o, d)
        return h.t, h.prim, h.u, h.v, h.valid

    def occlude_fn(o, d, t_min, t_max):
        return occlude_soa(scene, o, d, t_min, t_max)

    fused_fn = None
    if scene.intersector in DENSE_INTERSECTORS and scene.instances is None:
        # One dense launch answers N shadow rays + N extension rays: the
        # all-pairs sweep has no any-hit early-out to lose, so merging
        # halves the number of launches per bounce.
        def fused_fn(shadow_o, shadow_d, shadow_tmax, o2, d2, ext_tmax=None):
            n = o2.x.shape[0]
            cat = jnp.concatenate
            o = V3(*(cat([a, b]) for a, b in zip(shadow_o, o2)))
            d = V3(*(cat([a, b]) for a, b in zip(shadow_d, d2)))
            if ext_tmax is None:
                ext_tmax = jnp.full((n,), T_MAX, jnp.float32)
            t_max = cat([shadow_tmax, ext_tmax])
            h = intersect_soa(scene, o, d, t_max=t_max)
            occluded = h.valid[:n]
            hit = (h.t[n:], h.prim[n:], h.u[n:], h.v[n:], h.valid[n:])
            return occluded, hit

    return intersect_fn, occlude_fn, fused_fn


def _jax_intersectors(scene):
    """AoS intersectors ([N,3] rays, Hit records) for the BDPT/AO
    integrators (ops.intersect dispatch unchanged)."""
    import jax.numpy as jnp

    from ..ops.intersect import T_MAX, intersect, occlude

    def intersect_fn(o, d):
        h = intersect(scene, o, d)
        return h.t, h.prim, h.uv, h.valid

    def occlude_fn(o, d, t_min, t_max):
        return occlude(scene, o, d, t_min, t_max)

    fused_fn = None
    if scene.intersector in DENSE_INTERSECTORS and scene.instances is None:
        def fused_fn(shadow_o, shadow_d, shadow_tmax, o2, d2, ext_tmax=None):
            n = o2.shape[0]
            o = jnp.concatenate([shadow_o, o2], axis=0)
            d = jnp.concatenate([shadow_d, d2], axis=0)
            if ext_tmax is None:
                ext_tmax = jnp.full((n,), T_MAX, jnp.float32)
            t_max = jnp.concatenate([shadow_tmax, ext_tmax])
            h = intersect(scene, o, d, t_max=t_max)
            occluded = h.valid[:n]
            hit = (h.t[n:], h.prim[n:], h.uv[n:], h.valid[n:])
            return occluded, hit

    return intersect_fn, occlude_fn, fused_fn


def render_sample(scene, camera, cfg, seed, sample_idx, pixel_idx=None):
    """One sample for every pixel -> [H*W, 3] radiance (JAX)."""
    import jax.numpy as jnp

    n = camera.width * camera.height
    if pixel_idx is None:
        pixel_idx = jnp.arange(n, dtype=jnp.uint32)
    intersect_fn, occlude_fn, fused_fn = _jax_intersectors_soa(scene)
    return trace_paths(
        scene, camera, cfg, seed, sample_idx, pixel_idx,
        intersect_fn, occlude_fn, jnp, fused_fn=fused_fn,
    )


# Max rays in one wavefront: bounds PathState memory (~60 B/ray live state;
# 4M rays ~= 0.25 GB of device memory) while keeping launches large.
MAX_RAYS_IN_FLIGHT = 1 << 22


def trace_accumulate(scene, camera, cfg, seed, base_pixel_idx, sample_offset=0):
    """Mean radiance over cfg.spp samples for the given pixel ids [B].

    Samples are folded into the ray axis (spp_chunk * B rays per wavefront)
    up to MAX_RAYS_IN_FLIGHT, then scanned over chunks. Large batches
    amortize per-op overhead — the analog of the reference's
    512^2-paths-per-tile wavefront sizing (gpu/cuda/integrator.cpp:111).
    Used by both the single-device and the shard_map-sharded renderers.
    """
    import jax
    import jax.numpy as jnp

    n = base_pixel_idx.shape[0]
    chunk = max(1, min(cfg.spp, MAX_RAYS_IN_FLIGHT // max(n, 1)))
    n_chunks = (cfg.spp + chunk - 1) // chunk
    # pad spp up to n_chunks*chunk and weight the average accordingly
    pixel_idx = jnp.tile(base_pixel_idx.astype(jnp.uint32), chunk)
    sample_off = jnp.repeat(
        jnp.arange(chunk, dtype=jnp.uint32), n
    )
    intersect_fn, occlude_fn, fused_fn = _jax_intersectors_soa(scene)

    def body(acc_count, c):
        acc, count = acc_count
        sample_idx = sample_off + c * chunk + jnp.uint32(sample_offset)
        li = trace_paths(
            scene, camera, cfg, seed, sample_idx, pixel_idx,
            intersect_fn, occlude_fn, jnp, fused_fn=fused_fn,
        )
        # only samples < offset+spp contribute (last chunk may be partial)
        w = (sample_idx < sample_offset + cfg.spp).astype(jnp.float32)[:, None]
        li = (li * w).reshape(chunk, n, 3).sum(axis=0)
        return (acc + li, count + w.reshape(chunk, n, 1).sum(axis=0)), None

    init = (
        jnp.zeros((n, 3), jnp.float32),
        jnp.zeros((n, 1), jnp.float32),
    )
    if n_chunks == 1:
        (acc, count), _ = body(init, jnp.uint32(0))
    else:
        (acc, count), _ = jax.lax.scan(
            body, init, jnp.arange(n_chunks, dtype=jnp.uint32)
        )
    return acc / jnp.maximum(count, 1.0)


def render(scene, camera, cfg, seed=0, sample_offset=0):
    """Full render: [H, W, 3] mean radiance over cfg.spp samples (JAX).

    ``sample_offset`` starts the sample stream at a later index — chunked
    progressive renders accumulate disjoint slices of the same stream.
    """
    import jax.numpy as jnp

    n = camera.width * camera.height
    img = trace_accumulate(
        scene, camera, cfg, seed, jnp.arange(n, dtype=jnp.uint32),
        sample_offset=sample_offset,
    )
    return img.reshape(camera.height, camera.width, 3)
