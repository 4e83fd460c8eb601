"""Component-SoA shading: the wavefront hot path (core/v3.py layout).

Same math as shading/{bsdf,material,light,microfacet}.py — Lambert +
GGX/Beckmann/Phong microfacet + specular mirror closures, the Mix-tree
walk, power-CDF NEE — but every per-ray quantity is an [N] array and
every 3-vector/RGB a V3 of [N] components (see core/v3.py). The AoS
modules remain the API for the BDPT/AO integrators;
this module serves integrators/path.py's trace loop.

Ref parity anchors: BSDF closures kernel/material.h:57-191, microfacet
models kernel/microfacet.h:28-160, Mix walk material.h:255-271, area
light kernel/light.h:47-76. Backend-generic (jnp / np — the oracle runs
this exact code).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..core.distribution import sample_discrete
from ..core.v3 import V3, from_rows, onb3, reflect3, to_local3, to_world3, v3where, _xp
from ..scene.arrays import (
    MAT_DIFFUSE,
    MAT_EMISSIVE,
    MAT_GLASS,
    MAT_GLOSSY,
    MAT_MIRROR,
    MAT_MIX,
    MAX_MIX_DEPTH,
)
from . import microfacet as mf
from .bsdf import (
    CLOSURE_DIFFUSE,
    CLOSURE_GLASS,
    CLOSURE_MICROFACET,
    CLOSURE_NULL,
    CLOSURE_SPECULAR,
    DELTA_PDF,
)
from .material import _resolved_closure_table

INV_PI = 1.0 / np.pi
PI = np.pi


# ------------------------- sampling warps (scalar u) ------------------------

def concentric_disk(u1, u2):
    """Two [N] uniforms -> ([N] px, [N] py) on the unit disk."""
    xp = _xp(u1)
    x = 2.0 * u1 - 1.0
    y = 2.0 * u2 - 1.0
    ax, ay = xp.abs(x), xp.abs(y)
    use_x = ax > ay
    r = xp.where(use_x, x, y)
    safe = lambda d: xp.where(d == 0.0, 1.0, d)
    theta = xp.where(
        use_x,
        (PI / 4.0) * (y / safe(x)),
        (PI / 2.0) - (PI / 4.0) * (x / safe(y)),
    )
    degenerate = (x == 0.0) & (y == 0.0)
    px = xp.where(degenerate, 0.0, r * xp.cos(theta))
    py = xp.where(degenerate, 0.0, r * xp.sin(theta))
    return px, py


def cosine_hemisphere(u1, u2):
    """-> V3 local direction (Z-up), cosine-weighted."""
    xp = _xp(u1)
    px, py = concentric_disk(u1, u2)
    z = xp.sqrt(xp.maximum(0.0, 1.0 - px * px - py * py))
    return V3(px, py, z)


def uniform_triangle(u1, u2):
    """-> ([N] b0, [N] b1) uniform barycentrics."""
    xp = _xp(u1)
    su0 = xp.sqrt(u1)
    return 1.0 - su0, u2 * su0


def power_heuristic(pdf_a, pdf_b):
    xp = _xp(pdf_a)
    a2 = pdf_a * pdf_a
    return xp.where(pdf_a > 0.0, a2 / xp.maximum(a2 + pdf_b * pdf_b, 1e-30), 0.0)


# --------------------- microfacet distributions (local V3) ------------------
# Identical formulas to shading/microfacet.py on component scalars.

def _tan2_theta(w):
    # c2 clamp keeps tan^2 <= 1e8 (within 1e-4 rad of grazing): the exact
    # 1e-20 guard made the BACKWARD (-s2/c2^2) overflow to inf, and a
    # masked-out closure branch then turned 0 * inf into NaN parameter
    # gradients (r5: the dryrun's depth-5 NEE NaN).
    xp = _xp(w.z)
    c2 = w.z * w.z
    s2 = xp.maximum(0.0, 1.0 - c2)
    return s2 / xp.maximum(c2, 1e-8)


def _mf_d(dist, alpha, m):
    xp = _xp(m.z)
    c2 = m.z * m.z
    t2 = _tan2_theta(m)
    a2 = alpha * alpha
    at = a2 + t2
    # Guard at 1e-12 (not 1e-20): the quotient rule's backward divides by
    # denom^2, and a 1e-20 denom UNDERFLOWS squared in f32 -> 1/0 = inf
    # -> 0 * inf = NaN parameter gradients on masked grazing lanes.
    d_ggx = a2 / (PI * c2 * c2 * at * at + 1e-12)
    d_beck = xp.exp(-t2 / a2) / (PI * a2 * c2 * c2 + 1e-12)
    # power base clamped away from 0: d(x^a)/da = x^a ln(x) is NaN at
    # x = 0 even when this (masked) branch is never selected.
    d_phong = (alpha + 2.0) / (2.0 * PI) * xp.power(
        xp.maximum(m.z, 1e-6), alpha
    )
    d = xp.where(dist == mf.GGX, d_ggx, xp.where(dist == mf.BECKMANN, d_beck, d_phong))
    return xp.where(m.z > 0.0, d, 0.0)


def _rational_g1(a):
    xp = _xp(a)
    g = (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a)
    return xp.where(a < 1.6, g, 1.0)


def _mf_g1(dist, alpha, v, m):
    xp = _xp(v.z)
    back = v.dot(m) * v.z <= 0.0
    t2 = _tan2_theta(v)
    g_ggx = 2.0 / (1.0 + xp.sqrt(1.0 + alpha * alpha * t2))
    # +1e-12 inside sqrt: d(sqrt)/dt2 at t2 = 0 is inf, which poisons
    # masked lanes' parameter gradients (0 * inf = NaN).
    tt = xp.sqrt(xp.maximum(t2, 0.0) + 1e-12)
    a_beck = 1.0 / (xp.maximum(alpha, 1e-4) * xp.maximum(tt, 1e-9))
    a_phong = xp.sqrt(0.5 * alpha + 1.0) / xp.maximum(tt, 1e-9)
    g = xp.where(
        dist == mf.GGX,
        g_ggx,
        xp.where(
            dist == mf.BECKMANN, _rational_g1(a_beck), _rational_g1(a_phong)
        ),
    )
    return xp.where(back, 0.0, g)


def _mf_sample_wh(dist, alpha, u1, u2):
    xp = _xp(u1)
    phi = 2.0 * PI * u2
    t2_ggx = alpha * alpha * u1 / xp.maximum(1.0 - u1, 1e-9)
    t2_beck = -alpha * alpha * xp.log(xp.maximum(1.0 - u1, 1e-9))
    cos_p = xp.power(xp.maximum(u1, 1e-20), 1.0 / (alpha + 2.0))
    t2 = xp.where(dist == mf.GGX, t2_ggx, t2_beck)
    cos_t = 1.0 / xp.sqrt(1.0 + t2)
    cos_t = xp.where(dist == mf.PHONG, cos_p, cos_t)
    sin_t = xp.sqrt(xp.maximum(0.0, 1.0 - cos_t * cos_t))
    return V3(sin_t * xp.cos(phi), sin_t * xp.sin(phi), cos_t)


def _mf_pdf_wh(dist, alpha, m):
    xp = _xp(m.z)
    return _mf_d(dist, alpha, m) * xp.abs(m.z)


# --------------------------- local-frame closures ---------------------------

def _same_hemisphere(wo, wi):
    return wo.z * wi.z > 0.0


def _diffuse_eval(color, wo, wi):
    return v3where(_same_hemisphere(wo, wi), color * INV_PI, 0.0)


def _diffuse_pdf(wo, wi):
    xp = _xp(wo.z)
    return xp.where(_same_hemisphere(wo, wi), xp.abs(wi.z) * INV_PI, 0.0)


def _diffuse_sample(color, wo, u1, u2):
    xp = _xp(wo.z)
    wi = cosine_hemisphere(u1, u2)
    flip = wo.z < 0.0
    wi = V3(wi.x, wi.y, xp.where(flip, -wi.z, wi.z))
    pdf = xp.abs(wi.z) * INV_PI
    return wi, color * INV_PI, pdf


def _micro_eval(color, dist, alpha, wo, wi):
    xp = _xp(wo.z)
    same = _same_hemisphere(wo, wi)
    cos_o = xp.abs(wo.z)
    cos_i = xp.abs(wi.z)
    wh_raw = wo + wi
    wh2 = wh_raw.dot(wh_raw)
    # Degenerate half vectors (wi ~ -wo, e.g. an NEE direction opposite
    # the outgoing ray) are replaced by the pole BEFORE the microfacet
    # math: normalizing near-zero vectors gives wh components whose
    # backward is singular, and the 0-masked result still emits NaN
    # parameter cotangents.
    degen = wh2 < 1e-12
    wh = v3where(
        degen,
        V3(xp.zeros_like(wh2), xp.zeros_like(wh2), xp.ones_like(wh2)),
        wh_raw * (1.0 / xp.sqrt(xp.maximum(wh2, 1e-20))),
    )
    wh = v3where(wh.z < 0.0, -wh, wh)
    d_val = _mf_d(dist, alpha, wh)
    g_val = _mf_g1(dist, alpha, wo, wh) * _mf_g1(dist, alpha, wi, wh)
    denom = 4.0 * cos_i * cos_o
    scale = d_val * g_val / xp.maximum(denom, 1e-9)
    ok = same & (cos_i > 0) & (cos_o > 0) & ~degen
    return v3where(ok, color * scale, 0.0)


def _micro_pdf(dist, alpha, wo, wi):
    xp = _xp(wo.z)
    wh_raw = wo + wi
    wh2 = wh_raw.dot(wh_raw)
    degen = wh2 < 1e-12  # see _micro_eval: sanitize before the math
    wh = v3where(
        degen,
        V3(xp.zeros_like(wh2), xp.zeros_like(wh2), xp.ones_like(wh2)),
        wh_raw * (1.0 / xp.sqrt(xp.maximum(wh2, 1e-20))),
    )
    wh = v3where(wh.z < 0.0, -wh, wh)
    pdf = _mf_pdf_wh(dist, alpha, wh) / xp.maximum(4.0 * xp.abs(wo.dot(wh)), 1e-9)
    return xp.where(_same_hemisphere(wo, wi) & ~degen, pdf, 0.0)


def _micro_sample(color, dist, alpha, wo, u1, u2):
    xp = _xp(wo.z)
    flip = wo.z < 0.0
    wo_up = V3(wo.x, wo.y, xp.where(flip, -wo.z, wo.z))
    wh = _mf_sample_wh(dist, alpha, u1, u2)
    wi_up = reflect3(wo_up, wh)
    wi = V3(wi_up.x, wi_up.y, xp.where(flip, -wi_up.z, wi_up.z))
    pdf = _mf_pdf_wh(dist, alpha, wh) / xp.maximum(
        4.0 * xp.abs(wo_up.dot(wh)), 1e-9
    )
    f = _micro_eval(color, dist, alpha, wo, wi)
    ok = _same_hemisphere(wo, wi)
    return wi, f, xp.where(ok, pdf, 0.0)


def _specular_sample(color, wo):
    xp = _xp(wo.z)
    wi = V3(-wo.x, -wo.y, wo.z)
    cos_i = xp.maximum(xp.abs(wi.z), 1e-6)
    f = color * (DELTA_PDF / cos_i)
    pdf = xp.full(wo.z.shape, DELTA_PDF, xp.float32)
    return wi, f, pdf


def _glass_sample(color, ior, wo, u1):
    """Smooth dielectric: Fresnel-weighted delta reflection / refraction
    with the (1/eta)^2 radiance scale; TIR reflects. Same math as the AoS
    bsdf._glass_sample (ref: bsdf-funcs.h fr_dielectric/refract — declared
    there, consumed by no reference closure)."""
    from .bsdf import fresnel_dielectric

    xp = _xp(wo.z)
    cos_i = wo.z
    entering = cos_i > 0.0
    eta = xp.where(entering, 1.0 / ior, ior)
    fr = fresnel_dielectric(cos_i, xp.ones_like(ior), ior)
    nz = xp.where(entering, 1.0, -1.0)
    ci = xp.abs(cos_i)
    sin2_t = eta * eta * xp.maximum(0.0, 1.0 - ci * ci)
    tir = sin2_t >= 1.0
    cos_t = xp.sqrt(xp.maximum(0.0, 1.0 - sin2_t))
    wt = V3(-eta * wo.x, -eta * wo.y, -eta * wo.z + (eta * ci - cos_t) * nz)
    wr = V3(-wo.x, -wo.y, wo.z)
    reflect_p = xp.where(tir, 1.0, fr)
    pick_r = (u1 < reflect_p) | tir
    wi = v3where(pick_r, wr, wt)
    cos_o = xp.maximum(xp.abs(wi.z), 1e-6)
    w_refl = DELTA_PDF * reflect_p / cos_o
    w_refr = DELTA_PDF * (1.0 - reflect_p) * (eta * eta) / cos_o
    f = color * xp.where(pick_r, w_refl, w_refr)
    pdf = xp.maximum(
        DELTA_PDF * xp.where(pick_r, reflect_p, 1.0 - reflect_p), 1e-12
    )
    return wi, f, pdf


# ------------------------------ dispatch ----------------------------------

def eval_local(params, wo, wi):
    fd = _diffuse_eval(params["color"], wo, wi)
    fm = _micro_eval(params["color"], params["dist"], params["alpha"], wo, wi)
    f = v3where(params["kind"] == CLOSURE_MICROFACET, fm, fd)
    zero = (
        (params["kind"] == CLOSURE_NULL)
        | (params["kind"] == CLOSURE_SPECULAR)
        | (params["kind"] == CLOSURE_GLASS)
    )
    return v3where(zero, 0.0, f)


def pdf_local(params, wo, wi):
    xp = _xp(wo.z)
    pd = _diffuse_pdf(wo, wi)
    pm = _micro_pdf(params["dist"], params["alpha"], wo, wi)
    pdf = xp.where(params["kind"] == CLOSURE_MICROFACET, pm, pd)
    zero = (
        (params["kind"] == CLOSURE_NULL)
        | (params["kind"] == CLOSURE_SPECULAR)
        | (params["kind"] == CLOSURE_GLASS)
    )
    return xp.where(zero, 0.0, pdf) * params["choice_pdf"]


def sample_local(params, wo, u1, u2):
    xp = _xp(wo.z)
    wi_d, f_d, p_d = _diffuse_sample(params["color"], wo, u1, u2)
    wi_m, f_m, p_m = _micro_sample(
        params["color"], params["dist"], params["alpha"], wo, u1, u2
    )
    wi_s, f_s, p_s = _specular_sample(params["color"], wo)
    ior = params.get("ior")
    if ior is None:
        ior = xp.full(wo.z.shape, 1.5, xp.float32)
    wi_g, f_g, p_g = _glass_sample(params["color"], ior, wo, u1)
    is_mf = params["kind"] == CLOSURE_MICROFACET
    is_sp = params["kind"] == CLOSURE_SPECULAR
    is_gl = params["kind"] == CLOSURE_GLASS
    wi = v3where(is_sp, wi_s, v3where(is_mf, wi_m, wi_d))
    f = v3where(is_sp, f_s, v3where(is_mf, f_m, f_d))
    pdf = xp.where(is_sp, p_s, xp.where(is_mf, p_m, p_d))
    wi = v3where(is_gl, wi_g, wi)
    f = v3where(is_gl, f_g, f)
    pdf = xp.where(is_gl, p_g, pdf)
    null = params["kind"] == CLOSURE_NULL
    f = v3where(null, 0.0, f)
    pdf = xp.where(null, 0.0, pdf) * params["choice_pdf"]
    return wi, f, pdf


def make_frame(ns):
    t, b = onb3(ns)
    return t, b, ns


def eval_world(params, frame, wo_w, wi_w):
    t, b, n = frame
    return eval_local(params, to_local3(t, b, n, wo_w), to_local3(t, b, n, wi_w))


def pdf_world(params, frame, wo_w, wi_w):
    t, b, n = frame
    return pdf_local(params, to_local3(t, b, n, wo_w), to_local3(t, b, n, wi_w))


def sample_world(params, frame, wo_w, u1, u2):
    t, b, n = frame
    wi_l, f, pdf = sample_local(params, to_local3(t, b, n, wo_w), u1, u2)
    return to_world3(t, b, n, wi_l), f, pdf


# ------------------------------ materials ----------------------------------

def select_material(materials, textures, mat_id, u, uv_u, uv_v):
    """Mix-tree walk (ref material.h:255-271) -> (leaf_id, choice_pdf).

    Constant-texture scenes walk the resolved closure table via transposed
    fat gathers; image-texture scenes sample the fraction texture at uv.
    """
    xp = _xp(u)
    if not materials.has_mix:
        return mat_id, xp.ones_like(u)
    from ..ops.gather import gather_rows_t

    choice_pdf = xp.ones_like(u)
    cur = mat_id
    if not textures.has_images:
        ct = _resolved_closure_table(materials, textures, xp)
        for _ in range(MAX_MIX_DEPTH):
            fat = gather_rows_t(ct, cur)
            is_mix = fat[12] > 0.5
            frac = fat[9]
            safe_frac = xp.clip(frac, 1e-4, 1.0 - 1e-4)
            pick_b = u < safe_frac
            next_id = xp.where(pick_b, fat[11], fat[10]).astype(xp.int32)
            new_u = xp.where(
                pick_b, u / safe_frac, (u - safe_frac) / (1.0 - safe_frac)
            )
            step_pdf = xp.where(pick_b, 1.0 / safe_frac, 1.0 / (1.0 - safe_frac))
            cur = xp.where(is_mix, next_id, cur)
            u = xp.where(is_mix, new_u, u)
            choice_pdf = xp.where(is_mix, choice_pdf * step_pdf, choice_pdf)
        return cur, choice_pdf
    from . import texture as tex

    uv = xp.stack([uv_u, uv_v], axis=-1)
    for _ in range(MAX_MIX_DEPTH):
        kind = xp.take(materials.kind, cur)
        is_mix = kind == MAT_MIX
        frac_tex = xp.take(materials.fraction_tex, cur)
        frac = xp.clip(tex.evaluate_scalar(textures, frac_tex, uv), 1e-4, 1.0 - 1e-4)
        pick_b = u < frac
        next_id = xp.where(
            pick_b, xp.take(materials.mix_b, cur), xp.take(materials.mix_a, cur)
        )
        new_u = xp.where(pick_b, u / frac, (u - frac) / (1.0 - frac))
        step_pdf = xp.where(pick_b, 1.0 / frac, 1.0 / (1.0 - frac))
        cur = xp.where(is_mix, next_id, cur)
        u = xp.where(is_mix, new_u, u)
        choice_pdf = xp.where(is_mix, choice_pdf * step_pdf, choice_pdf)
    return cur, choice_pdf


def closure_params(materials, textures, leaf_id, choice_pdf, uv_u, uv_v):
    """Leaf ids -> SoA closure params: kind [N], color V3, alpha [N],
    dist [N], choice_pdf [N]. One transposed fat gather on the hot path."""
    xp = _xp(choice_pdf)
    if not textures.has_images:
        from ..ops.gather import gather_rows_t

        ct = _resolved_closure_table(materials, textures, xp)
        fat = gather_rows_t(ct, leaf_id)
        return {
            "kind": fat[0].astype(xp.int32),
            "color": from_rows(fat, 1),
            "alpha": fat[4],
            "dist": xp.full(leaf_id.shape, mf.GGX, xp.int32),
            "ior": fat[13],
            "choice_pdf": choice_pdf,
        }
    from . import texture as tex

    uv = xp.stack([uv_u, uv_v], axis=-1)
    kind = xp.take(materials.kind, leaf_id)
    color = tex.evaluate(textures, xp.take(materials.color_tex, leaf_id), uv)
    rough = tex.evaluate_scalar(
        textures, xp.take(materials.roughness_tex, leaf_id), uv
    )
    # clip: roughness is physically in [0,1]; non-glossy rows point their
    # roughness_tex at arbitrary texels (e.g. radiance), and an unbounded
    # alpha makes the (masked) microfacet branch numerically wild.
    alpha = xp.clip(rough * rough, 1e-4, 1.0)
    closure_kind = xp.where(
        kind == MAT_DIFFUSE,
        CLOSURE_DIFFUSE,
        xp.where(
            kind == MAT_GLOSSY,
            CLOSURE_MICROFACET,
            xp.where(
                kind == MAT_MIRROR,
                CLOSURE_SPECULAR,
                xp.where(kind == MAT_GLASS, CLOSURE_GLASS, CLOSURE_NULL),
            ),
        ),
    )
    ior_t = (
        xp.take(xp.asarray(materials.ior), leaf_id)
        if materials.ior is not None
        else xp.full(leaf_id.shape, 1.5, xp.float32)
    )
    return {
        "kind": closure_kind,
        "color": V3(color[..., 0], color[..., 1], color[..., 2]),
        "alpha": alpha,
        "dist": xp.full_like(closure_kind, mf.GGX),
        "ior": ior_t,
        "choice_pdf": choice_pdf,
    }


def emission_and_sided(materials, textures, mat_id, uv_u, uv_v):
    """(V3 Le, [N] double_sided) — one transposed fat gather."""
    xp = _xp(mat_id)
    if not textures.has_images:
        from ..ops.gather import gather_rows_t

        ct = _resolved_closure_table(materials, textures, xp)
        fat = gather_rows_t(ct, mat_id)
        return from_rows(fat, 5), fat[8] > 0.5
    from . import texture as tex

    uv = xp.stack([uv_u, uv_v], axis=-1)
    kind = xp.take(materials.kind, mat_id)
    color = tex.evaluate(textures, xp.take(materials.color_tex, mat_id), uv)
    Le = v3where(
        kind == MAT_EMISSIVE, V3(color[..., 0], color[..., 1], color[..., 2]), 0.0
    )
    return Le, xp.take(materials.double_sided, mat_id)


# ------------------------------- lights -------------------------------------

class LightSampleSoA(NamedTuple):
    wi: V3            # unit, surface -> light
    dist: object      # [N]
    L: V3             # emitted radiance toward the surface
    pdf: object       # [N] solid-angle pdf * selection pmf
    valid: object     # [N] bool


def light_sample(scene, u_select, u_pos1, u_pos2, p_ref):
    """Power-select a light triangle, sample a point, return the NEE record
    (ref: light.h:47-74 + scene.cpp power CDF). p_ref is a V3."""
    xp = _xp(u_select)
    lights = scene.lights
    li, sel_pdf = sample_discrete(lights.cdf, u_select)

    fast = scene.instances is None and not scene.textures.has_images
    if fast:
        from ..ops.gather import gather_rows_t
        from .light import _light_fat_table

        fat = gather_rows_t(_light_fat_table(scene, xp), li)
        v0, e1, e2 = from_rows(fat, 0), from_rows(fat, 3), from_rows(fat, 6)
        ng = from_rows(fat, 9)
        area = fat[12]
        L = from_rows(fat, 13)
        double_sided = fat[16] > 0.5
    else:
        from ..core.v3 import from_stack
        from .light import _light_tri_data
        from . import material as mat_aos
        from ..scene import geom

        tri = xp.take(lights.tri_id, li)
        v0_a, e1_a, e2_a, ng_a, area = _light_tri_data(scene, tri)
        v0, e1, e2, ng = (
            from_stack(v0_a), from_stack(e1_a), from_stack(e2_a), from_stack(ng_a)
        )
        mat_id = geom.mat_of_prim(scene, tri, xp)
        double_sided = mat_aos.emissive_double_sided(scene.materials, mat_id)
        from .light import _light_uv

        b = xp.stack(uniform_triangle(u_pos1, u_pos2), axis=-1)
        uv_tex = _light_uv(scene, tri, b)
        L_a = mat_aos.emission(scene.materials, scene.textures, mat_id, uv_tex)
        L = from_stack(L_a)

    b0, b1 = uniform_triangle(u_pos1, u_pos2)
    p = v0 + e1 * b0 + e2 * b1

    wi_raw = p - p_ref
    dist2 = xp.maximum(wi_raw.dot(wi_raw), 1e-12)
    dist = xp.sqrt(dist2)
    wi = wi_raw * (1.0 / dist)

    cos_light = -wi.dot(ng)  # emission from the front face (ref light.h:66)
    cos_eff = xp.where(double_sided, xp.abs(cos_light), cos_light)
    area_ok = cos_eff > 1e-6
    pdf = dist2 / (xp.maximum(cos_eff, 1e-6) * area) * sel_pdf
    valid = area_ok & (scene.lights.n_lights > 0)
    return LightSampleSoA(wi, dist, L, pdf, valid)


# --------------------------- environment light ------------------------------
# Equirectangular mapping: u = (atan2(x, -z) + pi) / 2pi, v = acos(y) / pi
# (v = 0 at +Y). Importance sampling uses the flattened luminance*sin(v*pi)
# texel CDF (SceneArrays.env_cdf); pdf conversion image -> solid angle is
# pmf * He*We / (2 pi^2 sin(theta)).

def env_uv_of_dir(d):
    """V3 unit direction -> ([N] u, [N] v) equirect coords."""
    xp = _xp(d.x)
    u = (xp.arctan2(d.x, -d.z) + PI) / (2.0 * PI)
    v = xp.arccos(xp.clip(d.y, -1.0, 1.0)) / PI
    return u, v


def env_eval(scene, d):
    """Bilinear radiance of the environment map along V3 d -> V3."""
    xp = _xp(d.x)
    img = scene.env_image
    he, we = img.shape[0], img.shape[1]
    u, v = env_uv_of_dir(d)
    x = u * we - 0.5
    y = v * he - 0.5
    x0 = xp.floor(x)
    y0 = xp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.astype(xp.int32) % we
    x1i = (x0i + 1) % we                      # wrap in longitude
    y0i = xp.clip(y0.astype(xp.int32), 0, he - 1)
    y1i = xp.clip(y0i + 1, 0, he - 1)         # clamp at poles
    flat = img.reshape(-1, 3)

    def texel(yi, xi):
        t = xp.take(flat, yi * we + xi, axis=0)
        return V3(t[..., 0], t[..., 1], t[..., 2])

    c00, c01 = texel(y0i, x0i), texel(y0i, x1i)
    c10, c11 = texel(y1i, x0i), texel(y1i, x1i)
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def env_pdf_sa(scene, d):
    """Solid-angle NEE pdf of sampling direction d from the env CDF
    (EXCLUDING the strategy-mixture factor env_p_select)."""
    xp = _xp(d.x)
    he = scene.env_image.shape[0]
    we = scene.env_image.shape[1]
    u, v = env_uv_of_dir(d)
    xi = xp.clip((u * we).astype(xp.int32), 0, we - 1)
    yi = xp.clip((v * he).astype(xp.int32), 0, he - 1)
    pmf = xp.take(scene.env_pmf, yi * we + xi)
    sin_t = xp.maximum(xp.sin(v * PI), 1e-6)
    return pmf * (he * we) / (2.0 * PI * PI * sin_t)


def env_sample(scene, u1, u2):
    """Importance-sample a direction from the env CDF: texel via ONE
    searchsorted on the flattened CDF (u1; the in-texel longitude comes
    free from the continuous inverse-CDF remainder), latitude jitter
    from u2. Both in-texel coordinates are uniform, so the sampling
    density is exactly pmf * He*We per unit image area.

    Returns (wi V3, Le V3, pdf_sa [N]).
    """
    from ..core.distribution import sample_continuous

    xp = _xp(u1)
    he = scene.env_image.shape[0]
    we = scene.env_image.shape[1]
    x_flat, pdf_flat, idx = sample_continuous(scene.env_cdf, u1)
    # de-flatten: texel (yi, xi) + uniform position inside it
    frac = x_flat * (he * we) - idx.astype(xp.float32)
    yi = idx // we
    xi = idx % we
    u = (xi.astype(xp.float32) + frac) / we
    v = (yi.astype(xp.float32) + u2) / he
    theta = v * PI
    phi = u * 2.0 * PI - PI
    sin_t = xp.sin(theta)
    wi = V3(sin_t * xp.sin(phi), xp.cos(theta), -sin_t * xp.cos(phi))
    Le = env_eval(scene, wi)
    pmf = xp.take(scene.env_pmf, idx)
    pdf = pmf * (he * we) / (2.0 * PI * PI * xp.maximum(sin_t, 1e-6))
    return wi, Le, pdf


# Shadow-ray length used for environment NEE samples (the occlusion query
# is "anything between here and the sky?").
ENV_SHADOW_DIST = np.float32(1e7)


def light_sample_mixed(scene, u_select, u_p1, u_p2, p_ref):
    """NEE sample from the area-light/environment strategy mixture.

    No env: plain area sampling. Env only: pure env sampling. Both: pick
    the env with probability ``scene.env_p_select`` (u_select split +
    rescale), and fold the mixture pmf into the returned pdf so MIS
    weights stay consistent (integrators/path.py).
    """
    xp = _xp(u_select)
    has_env = scene.env_image is not None
    if not has_env:
        return light_sample(scene, u_select, u_p1, u_p2, p_ref)
    if scene.lights.n_lights == 0:
        wi, Le, pdf = env_sample(scene, u_p1, u_p2)
        dist = xp.full(u_select.shape, ENV_SHADOW_DIST, xp.float32)
        return LightSampleSoA(wi, dist, Le, pdf, pdf > 0.0)
    p_env = scene.env_p_select
    is_env = u_select < p_env
    u_area = xp.clip(
        (u_select - p_env) / xp.maximum(1.0 - p_env, 1e-6), 0.0, 0.999999
    )
    ls = light_sample(scene, u_area, u_p1, u_p2, p_ref)
    wi_e, Le_e, pdf_e = env_sample(scene, u_p1, u_p2)
    wi = v3where(is_env, wi_e, ls.wi)
    dist = xp.where(
        is_env, xp.full(u_select.shape, ENV_SHADOW_DIST, xp.float32), ls.dist
    )
    L = v3where(is_env, Le_e, ls.L)
    pdf = xp.where(is_env, pdf_e * p_env, ls.pdf * (1.0 - p_env))
    valid = xp.where(is_env, pdf_e > 0.0, ls.valid)
    return LightSampleSoA(wi, dist, L, pdf, valid)


def light_pdf_direction_from(e1, e2, sel_pdf, hit_ok, wi, dist, double_sided):
    """MIS light pdf from already-gathered hit data (V3 e1/e2/wi)."""
    xp = _xp(dist)
    ng_raw = e1.cross(e2)
    area2 = xp.sqrt(xp.maximum(ng_raw.dot(ng_raw), 1e-20))
    ng = ng_raw * (1.0 / area2)
    area = 0.5 * area2
    cos_light = -wi.dot(ng)
    cos_eff = xp.where(double_sided, xp.abs(cos_light), cos_light)
    is_light = (sel_pdf > 0.0) & hit_ok
    d = xp.where(is_light, dist, 1.0)  # avoid inf*inf on missed lanes
    pdf = d * d / (xp.maximum(cos_eff, 1e-6) * area) * sel_pdf
    return xp.where(is_light & (cos_eff > 1e-6), pdf, 0.0)
