"""Bidirectional path tracer (BDPT), wavefront-vectorized.

New capability vs the reference: AkariRender's gallery shows BDPT renders
from an earlier incarnation but the reference code has no bidirectional
integrator (SURVEY.md §4 — "BDPT/guiding are NOT in this code"); BASELINE
config 5 asks for one. This is a from-scratch wavefront formulation:

* An **eye subpath** and a **light subpath** are traced for every pixel
  sample with the same fixed-depth masked wavefront sweeps as the
  unidirectional integrator — producing SoA vertex tapes of shape
  [n_rays, depth, ...] (a pytree of dense arrays; no dynamic path lengths).
* Every (s, t) **connection strategy** (light vertex s >= 1, eye vertex
  t >= 1) plus the s = 0 strategy (eye path hits the light) is evaluated
  as a dense batched operation: one visibility ray batch per (s, t) pair.
* **Exact Veach MIS** (balance heuristic) over all strategies of each path
  length: each vertex stores its forward and reverse probability densities
  converted to area measure, and the weight is computed with the standard
  r_i product recurrence — vectorized over the whole ray batch.

* **Light tracing (t = 1)**: every light-subpath vertex is also connected
  to the camera and splatted to the film pixel it projects to (a
  scatter-add — the stand-in for a film atomic splat). Enabled for
  pinhole cameras (``BDPTConfig.light_tracing``); when disabled (or with a
  thin lens) the strategy set simply excludes t = 1 and the MIS weights
  account only for included strategies, so the estimator stays unbiased
  either way.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import sampling
from ..core import rng
from ..core.vecmath import _xp, cross, dot, matmul, normalize
from ..scene import geom
from ..shading import bsdf as bsdf_mod
from ..shading import light as light_mod
from ..shading import material as mat_mod
from .path import RAY_EPS, SHADOW_EPS, camera_rays, _surface_data, _jax_intersectors

# RNG dimension plan: eye subpath uses the standard per-bounce dims
# (rng.bounce_dim); the light subpath draws from a disjoint high range.
LIGHT_DIMS_BASE = 4096
OFF_L_POS = 0      # light point (2) + light select (1)
OFF_L_DIR = 3      # emission direction (2)
OFF_L_BSDF = 5     # per-bounce bsdf u (2)

# Cap on rays per fused connection-visibility launch (see trace_bdpt):
# bounds the shadow wavefront's transient memory while still fusing ~16
# connection strategies per launch at 256^2.
BDPT_OCC_CHUNK_RAYS = 1 << 20


@dataclass(frozen=True)
class BDPTConfig:
    spp: int = 4
    eye_depth: int = 4    # max eye surface vertices (tape depth)
    light_depth: int = 3  # max light subpath vertices (tape depth)
    ray_clamp: float = 20.0
    # Cap on total surface vertices per path (0 = no cap beyond the tape
    # depths). Applies to whole path lengths, so MIS weights need no
    # adjustment; used for apples-to-apples comparisons with the
    # unidirectional tracer (max_vertices = max_depth + 1).
    max_vertices: int = 0
    # Light tracing: connect light-subpath vertices to the camera and
    # splat (t = 1 strategies). Auto-disabled for thin-lens cameras.
    light_tracing: bool = True


def _vertex_tape(n, depth, xp):
    """SoA tape for one subpath: all [n, depth(, c)] arrays."""
    z = lambda *sh: xp.zeros((n, depth) + sh, xp.float32)
    return {
        "p": z(3),           # position
        "ns": z(3),          # shading normal
        "ng": z(3),          # geometric normal
        "wo": z(3),          # direction toward the previous vertex
        "beta": z(3),        # throughput up to (and including) this vertex
        "kind": xp.full((n, depth), -1, xp.int32),   # closure kind
        "color": z(3),
        "alpha": z(),
        "choice_pdf": z(),
        "pdf_fwd": z(),      # area-measure pdf of generating this vertex
        "pdf_rev": z(),      # area-measure pdf of the reverse walk
        "valid": xp.zeros((n, depth), bool),
        "uv": z(2),          # texture coords (for Le at eye hits)
        "mat_id": xp.zeros((n, depth), xp.int32),
        "prim": xp.full((n, depth), -1, xp.int32),
        # Dirac (mirror/glass) vertex: non-connectible; its fwd/rev pdfs
        # are recorded as 0 and remapped to 1 in the MIS recurrence so
        # the delta densities cancel ratio-wise (pbrt's remap0 + delta
        # flag treatment — replaces the r4 DELTA_PDF=1e8 crutch).
        "delta": xp.zeros((n, depth), bool),
    }


def _set(tape, i, **kv):
    for k, v in kv.items():
        tape[k] = tape[k].at[:, i].set(v) if hasattr(tape[k], "at") else _np_set(tape[k], i, v)
    return tape


def _np_set(arr, i, v):
    arr[:, i] = v
    return arr


def _film_plane(camera):
    """Half-extents (sx, sy) of the film plane at unit camera depth.

    Matches the forward mapping in path.camera_rays (ref: the reference's
    raster->camera chain, kernel/camera.h:45-61)."""
    t = camera.tan_half_fov
    w, h = camera.width, camera.height
    if w > h:
        return t, t * (h / w)
    return t * (w / h), t


def _camera_ray_pdf_dir(camera, d, xp):
    """Solid-angle pdf of the camera sampling world direction ``d`` (unit).

    Uniform-over-film sampling: p(w) = 1 / (A * cos^3 theta), A = film
    area at unit depth. Used as the eye subpath's vertex-0 forward pdf so
    MIS can weigh t=1 (light tracing) against camera-sampled strategies.
    """
    c2w = xp.asarray(camera.c2w)
    fwd = -c2w[:3, 2]  # camera looks down local -Z; rotation is orthonormal
    cos_t = xp.maximum(dot(d, fwd), 1e-6)
    sx, sy = _film_plane(camera)
    area = 4.0 * sx * sy
    return 1.0 / (area * cos_t * cos_t * cos_t)


def _camera_connect(camera, p, xp):
    """Project a world point to the pinhole camera.

    Returns (w_to_cam, dist, pix, in_frustum, We, pdf_dir, cos_cam, cam_o):
    w_to_cam [N,3] unit direction point->camera; pix [N] flat film pixel
    (clipped; gate on in_frustum); We = importance 1/(A cos^4); pdf_dir =
    camera direction pdf toward p; cos_cam = cos(view axis, dir to p).
    """
    c2w = xp.asarray(camera.c2w)
    rot = c2w[:3, :3]
    cam_o = c2w[:3, 3]
    v = cam_o - p
    d2 = xp.maximum(dot(v, v), 1e-12)
    dist = xp.sqrt(d2)
    w_to_cam = v / dist[..., None]
    d_cam = matmul(p - cam_o, rot, xp=xp)  # R^T (p - cam_o): camera space
    z = -d_cam[..., 2]
    safe_z = xp.maximum(z, 1e-8)
    sx, sy = _film_plane(camera)
    ndc_x = d_cam[..., 0] / safe_z / sx
    ndc_y = d_cam[..., 1] / safe_z / sy
    in_frustum = (z > 1e-6) & (xp.abs(ndc_x) < 1.0) & (xp.abs(ndc_y) < 1.0)
    w, h = camera.width, camera.height
    px = xp.clip(((ndc_x + 1.0) * 0.5 * w).astype(xp.int32), 0, w - 1)
    py = xp.clip(((1.0 - ndc_y) * 0.5 * h).astype(xp.int32), 0, h - 1)
    pix = py * w + px
    cos_cam = safe_z / xp.sqrt(xp.maximum(dot(d_cam, d_cam), 1e-16))
    area = 4.0 * sx * sy
    cos2 = cos_cam * cos_cam
    we = 1.0 / (area * cos2 * cos2)
    pdf_dir = 1.0 / (area * cos_cam * cos2)
    return w_to_cam, dist, pix, in_frustum, we, pdf_dir, cos_cam, cam_o


def _t1_enabled(scene, camera, cfg):
    """t=1 strategies are active (static: metadata only)."""
    return (
        cfg.light_tracing
        and camera.lens_radius == 0.0
        and scene.lights.n_lights > 0
        and cfg.light_depth > 0
    )


def _scatter_add(img, idx, val, xp):
    if hasattr(img, "at"):
        return img.at[idx].add(val)
    np.add.at(img, idx, val)
    return img


def _geo_term(pa, na, pb, nb, xp):
    """|cos a||cos b| / d^2 and the unit direction a->b, distance."""
    w = pb - pa
    d2 = xp.maximum(dot(w, w), 1e-12)
    dist = xp.sqrt(d2)
    wn = w / dist[..., None]
    cos_a = xp.abs(dot(na, wn))
    cos_b = xp.abs(dot(nb, -wn))
    return cos_a * cos_b / d2, wn, dist, cos_a, cos_b


def _sa_to_area(pdf_sa, p_from, p_to, n_to, xp):
    """Solid-angle pdf at p_from -> area pdf at p_to."""
    w = p_to - p_from
    d2 = xp.maximum(dot(w, w), 1e-12)
    wn = w / xp.sqrt(d2)[..., None]
    return pdf_sa * xp.abs(dot(n_to, wn)) / d2


def _trace_eye_subpath(scene, camera, cfg, seed, sample_idx, pixel_idx,
                       intersect_fn, xp):
    """Trace the eye subpath, filling a vertex tape of depth cfg.eye_depth.

    Returns (tape, L_env): escaped segments accumulate the environment
    radiance times the running throughput. The env participates in BDPT
    only through this escape strategy (env directions are never sampled
    from the light side, so escape is the UNIQUE strategy for env paths
    and its MIS weight is exactly 1 — unbiased by construction; peaked
    env maps simply converge at BSDF-sampling rates).
    """
    n = pixel_idx.shape[0]
    depth = cfg.eye_depth
    tape = _vertex_tape(n, depth, xp)
    has_env = scene.env_image is not None
    L_env = xp.zeros((n, 3), xp.float32)

    o, d = camera_rays(camera, seed, sample_idx, pixel_idx, xp)
    beta = xp.ones((n, 3), xp.float32)
    active = xp.ones((n,), bool)
    # vertex-0 forward pdf = the real camera direction pdf (only consumed
    # by MIS when t=1 strategies are in the set; beta stays We/pdf == 1
    # because film-uniform sampling importance-samples We exactly).
    pdf_dir = _camera_ray_pdf_dir(camera, d, xp)
    prev_p = o
    prev_delta = xp.zeros((n,), bool)

    for t in range(depth):
        th, prim, bary, valid = intersect_fn(o, d)
        if has_env:
            from ..core.v3 import V3
            from ..shading import soa

            escaped = active & ~valid
            Le_env = soa.env_eval(
                scene, V3(d[..., 0], d[..., 1], d[..., 2])
            ).stack(xp)
            L_env = L_env + beta * Le_env * escaped[..., None]
        active = active & valid
        p, ng, ns, uv, mat_id = _surface_data(scene, prim, bary, xp)
        wo = -d

        u_mix = rng.uniform(seed, pixel_idx, sample_idx, rng.bounce_dim(t, rng.OFF_MIX))
        leaf, choice_pdf = mat_mod.select_material(
            scene.materials, scene.textures, mat_id, u_mix, uv
        )
        params = mat_mod.closure_params(
            scene.materials, scene.textures, leaf, choice_pdf, uv
        )
        # area pdf of this vertex from the previous one (0 — remapped to
        # 1 in MIS — when the previous vertex sampled a delta lobe)
        pdf_area = xp.where(
            prev_delta, 0.0, _sa_to_area(pdf_dir, prev_p, p, ns, xp)
        )

        tape = _set(
            tape, t,
            p=p, ns=ns, ng=ng, wo=wo, beta=beta,
            kind=params["kind"], color=params["color"], alpha=params["alpha"],
            choice_pdf=params["choice_pdf"], pdf_fwd=pdf_area,
            valid=active, uv=uv, mat_id=mat_id,
            prim=xp.where(active, prim, -1),
            delta=_is_delta_kind(params["kind"]),
        )

        # sample continuation
        frame = bsdf_mod.make_frame(ns)
        u_b = rng.uniform2(seed, pixel_idx, sample_idx, rng.bounce_dim(t, rng.OFF_BSDF_U))
        wi, f, pdf = bsdf_mod.sample_world(params, frame, wo, u_b)
        # reverse pdf of the PREVIOUS vertex: pdf of sampling wo from wi
        pdf_rev_sa = bsdf_mod.pdf_world(params, frame, wi, wo)
        if t > 0:
            prev_rev = _sa_to_area(
                pdf_rev_sa, p, tape["p"][:, t - 1],
                tape["ns"][:, t - 1], xp,
            )
            tape["pdf_rev"] = tape["pdf_rev"].at[:, t - 1].set(prev_rev) \
                if hasattr(tape["pdf_rev"], "at") else _np_set(tape["pdf_rev"], t - 1, prev_rev)

        cos_wi = xp.abs(dot(ns, wi))
        ok = active & (params["kind"] != bsdf_mod.CLOSURE_NULL) & (pdf > 1e-9)
        beta = xp.where(
            ok[..., None], beta * f * (cos_wi / xp.maximum(pdf, 1e-9))[..., None], beta
        )
        prev_p = p
        prev_delta = _is_delta_kind(params["kind"])
        o = p + wi * (RAY_EPS / xp.maximum(xp.abs(dot(ng, wi)), 1e-4))[..., None]
        d = wi
        pdf_dir = pdf
        active = ok

    return tape, L_env


def _sample_light_origin(scene, seed, sample_idx, pixel_idx, xp):
    """Sample a point + direction on a light: returns origin vertex data."""
    u_sel = rng.uniform(seed, pixel_idx, sample_idx, LIGHT_DIMS_BASE + OFF_L_POS + 2)
    u_pos = rng.uniform2(seed, pixel_idx, sample_idx, LIGHT_DIMS_BASE + OFF_L_POS)
    from ..core.distribution import sample_discrete

    li, sel_pdf = sample_discrete(scene.lights.cdf, u_sel)
    tri = xp.take(scene.lights.tri_id, li)
    v0, e1, e2 = geom.tri_world(scene, tri, xp)
    ng_raw = cross(e1, e2)
    area2 = xp.sqrt(xp.maximum(dot(ng_raw, ng_raw), 1e-20))
    ng = ng_raw / area2[..., None]
    area = 0.5 * area2
    b = sampling.uniform_triangle(u_pos)
    p = v0 + b[..., 0:1] * e1 + b[..., 1:2] * e2
    mat_id = geom.mat_of_prim(scene, tri, xp)
    uvs = geom.uvs_of_prim(scene, tri, xp)
    b0 = 1.0 - b[..., 0:1] - b[..., 1:2]
    uv = uvs[:, 0] * b0 + uvs[:, 1] * b[..., 0:1] + uvs[:, 2] * b[..., 1:2]
    Le = mat_mod.emission(scene.materials, scene.textures, mat_id, uv)
    pdf_area = sel_pdf / xp.maximum(area, 1e-12)
    return p, ng, Le, pdf_area, tri


def _trace_light_subpath(scene, cfg, seed, sample_idx, pixel_idx,
                         intersect_fn, xp):
    """Trace the light subpath; vertex 0 is the point on the light."""
    n = pixel_idx.shape[0]
    depth = cfg.light_depth
    tape = _vertex_tape(n, depth, xp)
    if scene.lights.n_lights == 0 or depth == 0:
        return tape

    p0, ng0, Le, pdf_a0, tri0 = _sample_light_origin(
        scene, seed, sample_idx, pixel_idx, xp
    )
    # vertex 0: on the light. beta = Le / pdf_area (direction factors follow)
    beta0 = Le / pdf_a0[..., None]
    tape = _set(
        tape, 0,
        p=p0, ns=ng0, ng=ng0, wo=ng0, beta=beta0,
        kind=xp.full((n,), bsdf_mod.CLOSURE_NULL, xp.int32),
        pdf_fwd=pdf_a0,
        valid=xp.ones((n,), bool) & (xp.max(Le, axis=-1) > 0),
        prim=tri0,
    )

    # emit direction: cosine-weighted about the light normal
    from ..core.vecmath import onb, to_world

    u_dir = rng.uniform2(seed, pixel_idx, sample_idx, LIGHT_DIMS_BASE + OFF_L_DIR)
    w_local = sampling.cosine_hemisphere(u_dir)
    t0, b0v = onb(ng0)
    d = to_world(t0, b0v, ng0, w_local)
    cos0 = xp.abs(dot(ng0, d))
    pdf_dir = sampling.cosine_hemisphere_pdf(xp.maximum(cos0, 1e-9))
    beta = beta0 * (cos0 / xp.maximum(pdf_dir, 1e-9))[..., None]
    o = p0 + d * (RAY_EPS / xp.maximum(cos0, 1e-4))[..., None]
    active = tape["valid"][:, 0]
    prev_p = p0
    prev_delta = xp.zeros((n,), bool)

    for s in range(1, depth):
        th, prim, bary, valid = intersect_fn(o, d)
        active = active & valid
        p, ng, ns, uv, mat_id = _surface_data(scene, prim, bary, xp)
        wo = -d

        dim = LIGHT_DIMS_BASE + OFF_L_BSDF + s * 4
        u_mix = rng.uniform(seed, pixel_idx, sample_idx, dim + 2)
        leaf, choice_pdf = mat_mod.select_material(
            scene.materials, scene.textures, mat_id, u_mix, uv
        )
        params = mat_mod.closure_params(
            scene.materials, scene.textures, leaf, choice_pdf, uv
        )
        pdf_area = xp.where(
            prev_delta, 0.0, _sa_to_area(pdf_dir, prev_p, p, ns, xp)
        )
        tape = _set(
            tape, s,
            p=p, ns=ns, ng=ng, wo=wo, beta=beta,
            kind=params["kind"], color=params["color"], alpha=params["alpha"],
            choice_pdf=params["choice_pdf"], pdf_fwd=pdf_area,
            valid=active, uv=uv, mat_id=mat_id,
            prim=xp.where(active, prim, -1),
            delta=_is_delta_kind(params["kind"]),
        )

        frame = bsdf_mod.make_frame(ns)
        u_b = rng.uniform2(seed, pixel_idx, sample_idx, dim)
        wi, f, pdf = bsdf_mod.sample_world(params, frame, wo, u_b)
        pdf_rev_sa = bsdf_mod.pdf_world(params, frame, wi, wo)
        prev_rev = _sa_to_area(
            pdf_rev_sa, p, tape["p"][:, s - 1], tape["ns"][:, s - 1], xp
        )
        tape["pdf_rev"] = tape["pdf_rev"].at[:, s - 1].set(prev_rev) \
            if hasattr(tape["pdf_rev"], "at") else _np_set(tape["pdf_rev"], s - 1, prev_rev)

        cos_wi = xp.abs(dot(ns, wi))
        ok = active & (params["kind"] != bsdf_mod.CLOSURE_NULL) & (pdf > 1e-9)
        beta = xp.where(
            ok[..., None], beta * f * (cos_wi / xp.maximum(pdf, 1e-9))[..., None], beta
        )
        prev_p = p
        prev_delta = _is_delta_kind(params["kind"])
        o = p + wi * (RAY_EPS / xp.maximum(xp.abs(dot(ng, wi)), 1e-4))[..., None]
        d = wi
        pdf_dir = pdf
        active = ok

    return tape


def _params_at(tape, i):
    return {
        "kind": tape["kind"][:, i],
        "color": tape["color"][:, i],
        "alpha": tape["alpha"][:, i],
        "dist": tape["kind"][:, i] * 0,  # GGX == 0
        "choice_pdf": tape["choice_pdf"][:, i],
    }


def _safe_div(xp, a, b):
    return a / xp.where(b > 1e-18, b, 1e-18)


def _remap0(xp, x):
    """pbrt's remap0: treat 0 pdfs as 1 in MIS pdf ratios. Delta vertices
    record fwd/rev = 0, so their (delta) densities cancel to ratio 1; the
    strategies that would CONNECT at them are excluded separately via the
    delta flags."""
    return xp.where(x > 0.0, x, 1.0)


def _is_delta_kind(kind):
    return (kind == bsdf_mod.CLOSURE_SPECULAR) | (
        kind == bsdf_mod.CLOSURE_GLASS
    )


def _mis_weight(eye, light, s, t, rev_e_t, rev_e_tm1, rev_l_s, rev_l_sm1,
                max_light_depth, xp, t1=False):
    """Balance-heuristic weight for connection strategy (s, t).

    Strategy set for a path with E eye vertices + L light vertices:
    all (s', t') with s' + t' = s + t + 2 vertices split as s' light /
    t' eye, where t' >= 1 (plus the t' = 0 camera-splat alternative when
    ``t1``) and s' <= max_light_depth. Standard r_i recurrence (Veach;
    pbrt's MISWeight): walk outward from the connection multiplying
    rev/fwd pdf ratios per vertex. The two vertices adjacent to the
    connection need their reverse pdfs recomputed for the connection
    direction:
    rev_e_t   = area pdf of eye vertex t generated from light vertex s;
    rev_e_tm1 = area pdf of eye vertex t-1 generated from eye vertex t
                with incoming from the connection;
    rev_l_s / rev_l_sm1 symmetrically.
    When ``t1``, eye pdf_fwd[:, 0] must hold the true camera area pdf —
    the k = 0 ratio weighs light tracing against camera sampling (the
    pinhole position delta is shared by both and cancels).
    """
    sum_ri = xp.zeros_like(rev_e_t)
    max_eye_depth = eye["pdf_fwd"].shape[1]

    # Tape index k holds vertex count k+1. Eye-ward alternatives: the
    # connection moves past eye index k (k = t .. 1, and k = 0 for the
    # t1 splat strategy), leaving k eye vertices and s + (t - k) + 2
    # light vertices. pdf ratios use remap0 so delta vertices' (zeroed)
    # densities cancel to 1; an alternative whose connection endpoint is
    # a delta vertex does not exist and is excluded per lane.
    ri = xp.ones_like(rev_e_t)
    for k in range(t, -1 if t1 else 0, -1):
        rev = rev_e_t if k == t else (rev_e_tm1 if k == t - 1 else eye["pdf_rev"][:, k])
        ri = ri * (_remap0(xp, rev) / _remap0(xp, eye["pdf_fwd"][:, k]))
        if s + (t - k) + 2 <= max_light_depth:
            can = ~eye["delta"][:, k]
            if k >= 1:
                can = can & ~eye["delta"][:, k - 1]
            sum_ri = sum_ri + xp.where(can, ri, 0.0)

    # Light-ward alternatives: the connection moves past light index k
    # (k = s .. 0, k = 0 is the pure eye hit), leaving k light vertices
    # and t + (s - k) + 2 eye vertices.
    ri = xp.ones_like(rev_e_t)
    for k in range(s, -1, -1):
        rev = rev_l_s if k == s else (rev_l_sm1 if k == s - 1 else light["pdf_rev"][:, k])
        ri = ri * (_remap0(xp, rev) / _remap0(xp, light["pdf_fwd"][:, k]))
        if t + (s - k) + 2 <= max_eye_depth:
            can = ~light["delta"][:, k]
            if k >= 1:
                can = can & ~light["delta"][:, k - 1]
            sum_ri = sum_ri + xp.where(can, ri, 0.0)

    return 1.0 / (1.0 + sum_ri)


def _mis_weight_s0(eye, t, pdf_light_area, pdf_emit_tm1, max_light_depth, xp,
                   t1=False):
    """Weight for the s = 0 strategy: the eye path hits the light at eye
    vertex index t. Competitors generate the light vertex (and possibly
    more) from the light side:
    pdf_light_area = area pdf of sampling the hit point on the light;
    pdf_emit_tm1   = area pdf of eye vertex t-1 generated from the light
                     point by emission-direction sampling.
    """
    sum_ri = xp.zeros_like(pdf_light_area)
    ri = xp.ones_like(pdf_light_area)
    # k walks the eye tape from the light vertex (index t) backwards; the
    # alternative after moving past index k has (t - k + 1) light vertices
    # and k eye vertices (k = 0, the camera splat, only when t1).
    for k in range(t, -1 if t1 else 0, -1):
        if k == t:
            rev = pdf_light_area
        elif k == t - 1:
            rev = pdf_emit_tm1
        else:
            rev = eye["pdf_rev"][:, k]
        ri = ri * (_remap0(xp, rev) / _remap0(xp, eye["pdf_fwd"][:, k]))
        if (t - k + 1) <= max_light_depth:
            can = ~eye["delta"][:, k]
            if k >= 1:
                can = can & ~eye["delta"][:, k - 1]
            sum_ri = sum_ri + xp.where(can, ri, 0.0)
    return 1.0 / (1.0 + sum_ri)


def _mis_weight_t1(light, s, rev_l_s, rev_l_sm1, max_eye_depth, xp):
    """Weight for the t = 1 (light tracing) strategy splatting light tape
    vertex ``s`` to the camera. Alternatives move the split light-ward:
    after moving past light index k, k light vertices remain and the eye
    side has s + 1 - k surface vertices (k = 0 is the pure eye hit).
    rev_l_s   = area pdf of light vertex s generated from the camera;
    rev_l_sm1 = area pdf of light vertex s-1 generated from light vertex s
                with incoming from the camera.
    """
    sum_ri = xp.zeros_like(rev_l_s)
    ri = xp.ones_like(rev_l_s)
    for k in range(s, -1, -1):
        rev = rev_l_s if k == s else (rev_l_sm1 if k == s - 1 else light["pdf_rev"][:, k])
        ri = ri * (_remap0(xp, rev) / _remap0(xp, light["pdf_fwd"][:, k]))
        if (s + 1 - k) <= max_eye_depth:
            can = ~light["delta"][:, k]
            if k >= 1:
                can = can & ~light["delta"][:, k - 1]
            sum_ri = sum_ri + xp.where(can, ri, 0.0)
    return 1.0 / (1.0 + sum_ri)


def trace_bdpt(scene, camera, cfg, seed, sample_idx, pixel_idx,
               intersect_fn, occlude_fn, xp, lane_mask=None):
    """One BDPT sample per pixel -> ([N, 3] radiance, [W*H, 3] splat film).

    The first return is per-traced-pixel radiance (t >= 2 strategies and
    s = 0); the second is the whole-film t = 1 light-tracing splat image
    (zeros when t = 1 is disabled) — a light path traced for pixel i may
    splat anywhere. The final image is radiance_image + splat_film where
    both are averaged over spp.

    ``lane_mask`` ([N] bool) excludes lanes from the SPLAT: the t = 1
    estimator's normalization assumes exactly W*H light subpaths per
    sample, so callers that pad the pixel axis (sharded render with a
    pixel count not divisible by the device count) must mask their pad
    lanes or the splat film gains (n_pad/W*H) extra energy. Per-lane
    radiance needs no mask — callers slice it.
    """
    n = pixel_idx.shape[0]
    t1 = _t1_enabled(scene, camera, cfg)
    n_film = camera.width * camera.height
    splat = xp.zeros((n_film, 3), xp.float32)
    eye, L_env = _trace_eye_subpath(
        scene, camera, cfg, seed, sample_idx, pixel_idx, intersect_fn, xp
    )
    light = _trace_light_subpath(
        scene, cfg, seed, sample_idx, pixel_idx, intersect_fn, xp
    )
    # environment radiance along escaped eye segments (the escape is the
    # only strategy producing env paths, so its MIS weight is 1)
    L = L_env

    # All connection/splat visibility rays are queued and answered by ONE
    # batched occlusion launch at the end (the fused-launch idea from
    # path.py:370-381 applied across every (s,t) pair): eye_depth x
    # light_depth (+ light-tracing) launches collapse to one, which keeps
    # the device fed with a single large wavefront instead of ~12 small
    # ones.
    # Entries: (o, d, t_max, payload) with payload ("conn"|"splat", ...).
    shadow_q = []

    cap = cfg.max_vertices if cfg.max_vertices > 0 else 1 << 30

    # ---- s = 0: eye path hits an emitter ----
    for t in range(cfg.eye_depth):
        if t + 1 > cap:
            break
        mat_id = eye["mat_id"][:, t]
        Le = mat_mod.emission(scene.materials, scene.textures, mat_id, eye["uv"][:, t])
        dsided = mat_mod.emissive_double_sided(scene.materials, mat_id)
        front = dot(-eye["wo"][:, t], eye["ng"][:, t]) < 0.0
        ok = eye["valid"][:, t] & (dsided | front)
        if t == 0 and not t1:
            w = xp.ones((n,), xp.float32)
        else:
            li = geom.light_of_prim(scene, xp.maximum(eye["prim"][:, t], 0), xp)
            sel_pdf = xp.take(scene.lights.pdf, xp.maximum(li, 0))
            _, _, _, _, area = light_mod._light_tri_data(scene, xp.maximum(eye["prim"][:, t], 0))
            pdf_l_area = sel_pdf / xp.maximum(area, 1e-12)
            if t >= 1:
                # area pdf of eye vertex t-1 generated from the (hit) light
                # point by cosine emission-direction sampling
                w_back = normalize(eye["p"][:, t - 1] - eye["p"][:, t], eps=1e-20)
                cos_emit = xp.abs(dot(eye["ng"][:, t], w_back))
                pdf_emit_tm1 = _sa_to_area(
                    sampling.cosine_hemisphere_pdf(xp.maximum(cos_emit, 1e-9)),
                    eye["p"][:, t], eye["p"][:, t - 1], eye["ns"][:, t - 1], xp,
                )
            else:
                pdf_emit_tm1 = xp.zeros((n,), xp.float32)  # unused at t=0
            w = _mis_weight_s0(
                eye, t, pdf_l_area, pdf_emit_tm1, cfg.light_depth, xp, t1=t1
            )
            ok = ok & (li >= 0)
        L = L + eye["beta"][:, t] * Le * (ok * w)[..., None]

    if scene.lights.n_lights == 0:
        return L, splat

    # ---- t = 1: light tracing — splat light vertices to the camera ----
    if t1:
        for s in range(cfg.light_depth):
            if s + 1 > cap:  # path has s+1 surface/light vertices
                break
            pl = light["p"][:, s]
            w_cam, dist, pix, in_f, we, pdf_cam_dir, cos_cam, cam_o = \
                _camera_connect(camera, pl, xp)
            cos_l = xp.abs(dot(light["ns"][:, s], w_cam))
            # area pdf of light vertex s generated from the camera
            rev_l_s = _sa_to_area(pdf_cam_dir, cam_o[None, :], pl,
                                  light["ns"][:, s], xp)
            if s == 0:
                # the light point itself: emission already in beta; gate on
                # the emitting side (ref: one-sided AreaLight, light.h:66)
                mat0 = geom.mat_of_prim(scene, xp.maximum(light["prim"][:, 0], 0), xp)
                dsided0 = mat_mod.emissive_double_sided(scene.materials, mat0)
                emit_cos = dot(light["ng"][:, 0], w_cam)
                f_l = xp.where(
                    (dsided0 | (emit_cos > 0))[..., None],
                    xp.ones((n, 3), xp.float32), 0.0,
                )
                rev_l_sm1 = xp.zeros((n,), xp.float32)
                can = light["valid"][:, 0]
            else:
                l_params = _params_at(light, s)
                l_frame = bsdf_mod.make_frame(light["ns"][:, s])
                f_l = bsdf_mod.eval_world(l_params, l_frame, light["wo"][:, s], w_cam)
                w_back = normalize(light["p"][:, s - 1] - pl, eps=1e-20)
                rev_l_sm1 = _sa_to_area(
                    bsdf_mod.pdf_world(l_params, l_frame, w_cam, w_back),
                    pl, light["p"][:, s - 1], light["ns"][:, s - 1], xp,
                )
                can = (
                    light["valid"][:, s]
                    & (light["kind"][:, s] != bsdf_mod.CLOSURE_NULL)
                    & ~light["delta"][:, s]
                )
            # importance transport: beta * f * We * cos_l * cos_cam / d^2
            contrib = light["beta"][:, s] * f_l * (
                we * cos_l * cos_cam / xp.maximum(dist * dist, 1e-12)
            )[..., None]
            ok = can & in_f & (xp.max(contrib, axis=-1) > 0.0)
            if lane_mask is not None:
                ok = ok & lane_mask
            o_sh = pl + w_cam * (
                RAY_EPS / xp.maximum(xp.abs(dot(light["ng"][:, s], w_cam)), 1e-4)
            )[..., None]
            w = _mis_weight_t1(light, s, rev_l_s, rev_l_sm1, cfg.eye_depth, xp)
            shadow_q.append((
                o_sh, w_cam, dist * (1.0 - SHADOW_EPS),
                ("splat", contrib, ok, w, pix),
            ))

    # ---- connections (s >= 1, t >= 1) ----
    for t in range(cfg.eye_depth):
        pe = eye["p"][:, t]
        e_params = _params_at(eye, t)
        e_frame = bsdf_mod.make_frame(eye["ns"][:, t])
        e_scatterable = (
            eye["valid"][:, t]
            & (eye["kind"][:, t] != bsdf_mod.CLOSURE_NULL)
            & ~eye["delta"][:, t]   # delta vertices are non-connectible
        )
        for s in range(cfg.light_depth):
            if t + s + 2 > cap:
                break
            pl = light["p"][:, s]
            g, w_el, dist, cos_e, cos_l = _geo_term(
                pe, eye["ns"][:, t], pl, light["ns"][:, s], xp
            )
            f_e = bsdf_mod.eval_world(e_params, e_frame, eye["wo"][:, t], w_el)
            # rev pdfs the OTHER side would use to create the connection
            # vertices (area measure at the respective vertex):
            # eye vertex t generated from light vertex s:
            if s == 0:
                # light vertex 0 emits: one-sided emission factor
                mat0 = geom.mat_of_prim(scene, xp.maximum(light["prim"][:, 0], 0), xp)
                dsided = mat_mod.emissive_double_sided(scene.materials, mat0)
                emit_cos = dot(light["ng"][:, 0], -w_el)
                f_l = xp.where(
                    (dsided | (emit_cos > 0))[..., None],
                    xp.ones((n, 3), xp.float32), 0.0,
                )
                rev_e_t = _sa_to_area(
                    sampling.cosine_hemisphere_pdf(xp.abs(emit_cos)),
                    pl, pe, eye["ns"][:, t], xp,
                )
            else:
                l_params = _params_at(light, s)
                l_frame = bsdf_mod.make_frame(light["ns"][:, s])
                f_l = bsdf_mod.eval_world(l_params, l_frame, light["wo"][:, s], -w_el)
                rev_e_t = _sa_to_area(
                    bsdf_mod.pdf_world(l_params, l_frame, light["wo"][:, s], -w_el),
                    pl, pe, eye["ns"][:, t], xp,
                )
            # light vertex s generated from eye vertex t:
            rev_l_s = _sa_to_area(
                bsdf_mod.pdf_world(e_params, e_frame, eye["wo"][:, t], w_el),
                pe, pl, light["ns"][:, s], xp,
            )
            # eye vertex t-1 generated from eye vertex t (incoming = conn):
            if t >= 1:
                w_e_back = normalize(eye["p"][:, t - 1] - pe, eps=1e-20) \
                    if t >= 1 else w_el
                rev_e_tm1 = _sa_to_area(
                    bsdf_mod.pdf_world(e_params, e_frame, w_el, w_e_back),
                    pe, eye["p"][:, max(t - 1, 0)],
                    eye["ns"][:, max(t - 1, 0)], xp,
                )
            else:
                rev_e_tm1 = xp.zeros((n,), xp.float32)
            # light vertex s-1 generated from light vertex s (incoming = conn):
            if s >= 1:
                w_l_back = normalize(light["p"][:, s - 1] - pl, eps=1e-20)
                rev_l_sm1 = _sa_to_area(
                    bsdf_mod.pdf_world(l_params, l_frame, -w_el, w_l_back),
                    pl, light["p"][:, s - 1], light["ns"][:, s - 1], xp,
                )
            else:
                rev_l_sm1 = xp.zeros((n,), xp.float32)

            contrib = (
                eye["beta"][:, t] * f_e * light["beta"][:, s] * f_l * g[..., None]
            )
            ok = (
                e_scatterable
                & light["valid"][:, s]
                & ~light["delta"][:, s]
                & (xp.max(contrib, axis=-1) > 0.0)
            )
            # visibility
            o_sh = pe + w_el * (
                RAY_EPS / xp.maximum(xp.abs(dot(eye["ng"][:, t], w_el)), 1e-4)
            )[..., None]
            w = _mis_weight(
                eye, light, s, t, rev_e_t, rev_e_tm1, rev_l_s, rev_l_sm1,
                cfg.light_depth, xp, t1=t1,
            )
            shadow_q.append((
                o_sh, w_el, dist * (1.0 - SHADOW_EPS),
                ("conn", contrib, ok, w),
            ))

    # ---- batched occlusion launches for the queued connections ----
    # Queue entries are flushed in groups of at most BDPT_OCC_CHUNK_RAYS
    # rays: large fused launches keep the device fed, the cap bounds the
    # transient shadow-wavefront memory at high resolution/depth (the full
    # queue is ~eye_depth*light_depth*n rays — depth^2 x a plain launch).
    if shadow_q:
        group, groups, group_rays = [], [], 0
        per_entry = n
        for q in shadow_q:
            if group and group_rays + per_entry > BDPT_OCC_CHUNK_RAYS:
                groups.append(group)
                group, group_rays = [], 0
            group.append(q)
            group_rays += per_entry
        groups.append(group)
        occ_parts = []
        for g in groups:
            o_all = xp.concatenate([q[0] for q in g], axis=0)
            d_all = xp.concatenate([q[1] for q in g], axis=0)
            t_all = xp.concatenate([q[2] for q in g], axis=0)
            occ_parts.append(occlude_fn(
                o_all, d_all, xp.zeros((o_all.shape[0],), xp.float32), t_all
            ))
        occ_all = xp.concatenate(occ_parts, axis=0)
        for i, (_, _, _, payload) in enumerate(shadow_q):
            occluded = occ_all[i * n:(i + 1) * n]
            if payload[0] == "splat":
                _, contrib, ok, w, pix = payload
                val = contrib * ((ok & ~occluded) * w)[..., None]
                if cfg.ray_clamp > 0:
                    val = xp.minimum(val, cfg.ray_clamp)
                val = xp.where(xp.isfinite(val), val, 0.0)
                splat = _scatter_add(splat, pix, val, xp)
            else:
                _, contrib, ok, w = payload
                L = L + contrib * (ok & ~occluded)[..., None] * w[..., None]

    if cfg.ray_clamp > 0:
        L = xp.minimum(L, cfg.ray_clamp)
    return xp.where(xp.isfinite(L), L, 0.0), splat


def render_bdpt(scene, camera, cfg, seed=0):
    """Full-frame BDPT render -> [H, W, 3] (JAX)."""
    import jax
    import jax.numpy as jnp

    n = camera.width * camera.height
    pixel_idx = jnp.arange(n, dtype=jnp.uint32)
    intersect_fn, occlude_fn, fused_fn = _jax_intersectors(scene)

    def body(carry, smp):
        acc, spl = carry
        li, sp = trace_bdpt(
            scene, camera, cfg, seed, smp, pixel_idx,
            intersect_fn, occlude_fn, jnp,
        )
        return (acc + li, spl + sp), None

    (acc, spl), _ = jax.lax.scan(
        body,
        (jnp.zeros((n, 3), jnp.float32), jnp.zeros((n, 3), jnp.float32)),
        jnp.arange(cfg.spp, dtype=jnp.uint32),
    )
    return ((acc + spl) / cfg.spp).reshape(camera.height, camera.width, 3)
