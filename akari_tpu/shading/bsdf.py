"""BSDF closures, batched over rays in local Z-up shading frames.

Capability parity with ref: src/akari/kernel/material.h:57-191
(DiffuseBSDF Lambert + cosine sampling; MicrofacetReflection GGX;
``BSDF`` wrapper doing frame transforms and choice_pdf scaling).
The reference's ``BSDFClosure`` Variant dispatch becomes masked
evaluation of both closures + a per-lane select — there are only two
closure kinds and both are pure arithmetic, so evaluating both costs less
than any divergent-control alternative on a vector machine (SURVEY.md §7).

``params`` is an SoA dict per-ray: kind [N] (CLOSURE_*), color [N,3],
alpha [N] (microfacet roughness^2), dist [N] (microfacet model id),
choice_pdf [N]. Backend-generic (jnp / np).
"""

from __future__ import annotations

import numpy as np

from .. import sampling
from ..core.vecmath import (
    _xp,
    abs_cos_theta,
    cos_theta,
    dot,
    normalize,
    onb,
    reflect,
    same_hemisphere,
    to_local,
    to_world,
)
from . import microfacet as mf

CLOSURE_NULL = -1
CLOSURE_DIFFUSE = 0
CLOSURE_MICROFACET = 1
CLOSURE_SPECULAR = 2  # perfect mirror (delta)
CLOSURE_GLASS = 3     # smooth dielectric (delta reflect + refract)

INV_PI = 1.0 / np.pi

# Delta distributions report this as their sample pdf. The sampled f is
# scaled by the same constant so throughput f*cos/pdf is exact, while MIS
# power weights against any finite area/solid-angle pdf evaluate to ~1.
DELTA_PDF = np.float32(1e8)


# --------------------------- local-frame closures --------------------------

def _diffuse_eval(color, wo, wi):
    xp = _xp(wo)
    f = color * INV_PI
    return xp.where(same_hemisphere(wo, wi)[..., None], f, 0.0)


def _diffuse_pdf(wo, wi):
    xp = _xp(wo)
    pdf = sampling.cosine_hemisphere_pdf(abs_cos_theta(wi))
    return xp.where(same_hemisphere(wo, wi), pdf, 0.0)


def _diffuse_sample(color, wo, u):
    xp = _xp(wo)
    wi = sampling.cosine_hemisphere(u)
    # flip into wo's hemisphere (ref: material.h:57-66)
    flip = cos_theta(wo) < 0.0
    wi = xp.where(flip[..., None], wi * xp.asarray([1.0, 1.0, -1.0], xp.float32), wi)
    pdf = sampling.cosine_hemisphere_pdf(abs_cos_theta(wi))
    return wi, color * INV_PI, pdf


def _micro_eval(color, dist, alpha, wo, wi):
    xp = _xp(wo)
    same = same_hemisphere(wo, wi)
    cos_o = abs_cos_theta(wo)
    cos_i = abs_cos_theta(wi)
    wh = wo + wi
    wh_len = xp.sqrt(xp.maximum(dot(wh, wh), 1e-20))
    wh = wh / wh_len[..., None]
    # canonical upper-hemisphere half vector
    wh = xp.where((cos_theta(wh) < 0.0)[..., None], -wh, wh)
    d_val = mf.d(dist, alpha, wh)
    g_val = mf.g(dist, alpha, wo, wi, wh)
    denom = 4.0 * cos_i * cos_o
    f = color * (d_val * g_val / xp.maximum(denom, 1e-9))[..., None]
    ok = same & (cos_i > 0) & (cos_o > 0) & (dot(wh, wh) > 0)
    return xp.where(ok[..., None], f, 0.0)


def _micro_pdf(dist, alpha, wo, wi):
    xp = _xp(wo)
    wh = normalize(wo + wi, eps=1e-20)
    wh = xp.where((cos_theta(wh) < 0.0)[..., None], -wh, wh)
    pdf = mf.pdf_wh(dist, alpha, wh) / xp.maximum(4.0 * xp.abs(dot(wo, wh)), 1e-9)
    return xp.where(same_hemisphere(wo, wi), pdf, 0.0)


def _micro_sample(color, dist, alpha, wo, u):
    xp = _xp(wo)
    # sample in wo's hemisphere: mirror wo up, sample, mirror back
    flip = cos_theta(wo) < 0.0
    z_flip = xp.asarray([1.0, 1.0, -1.0], xp.float32)
    wo_up = xp.where(flip[..., None], wo * z_flip, wo)
    wh = mf.sample_wh(dist, alpha, wo_up, u)
    wi_up = reflect(wo_up, wh)
    wi = xp.where(flip[..., None], wi_up * z_flip, wi_up)
    pdf = mf.pdf_wh(dist, alpha, wh) / xp.maximum(
        4.0 * xp.abs(dot(wo_up, wh)), 1e-9
    )
    f = _micro_eval(color, dist, alpha, wo, wi)
    ok = same_hemisphere(wo, wi)
    pdf = xp.where(ok, pdf, 0.0)
    return wi, f, pdf


def _glass_sample(color, ior, wo, u1):
    """Smooth dielectric: Fresnel-weighted choice between delta
    reflection and delta refraction (with the (1/eta)^2 radiance scale;
    TIR reflects). Local Z-up frame; handles rays from either side.
    ref: kernel/bsdf-funcs.h fr_dielectric/refract (declared, unused)."""
    xp = _xp(wo)
    cos_i = cos_theta(wo)
    entering = cos_i > 0.0
    eta = xp.where(entering, 1.0 / ior, ior)  # eta_i / eta_t
    fr = fresnel_dielectric(cos_i, xp.ones_like(ior), ior)
    # refraction about the +side normal
    nz = xp.where(entering, 1.0, -1.0)
    ci = xp.abs(cos_i)
    sin2_t = eta * eta * xp.maximum(0.0, 1.0 - ci * ci)
    tir = sin2_t >= 1.0
    cos_t = xp.sqrt(xp.maximum(0.0, 1.0 - sin2_t))
    # wt = -eta*wo + (eta*ci - cos_t) * n  (n = (0,0,nz))
    wt = xp.stack([
        -eta * wo[..., 0],
        -eta * wo[..., 1],
        -eta * wo[..., 2] + (eta * ci - cos_t) * nz,
    ], axis=-1)
    wr = wo * xp.asarray([-1.0, -1.0, 1.0], xp.float32)
    reflect_p = xp.where(tir, 1.0, fr)
    pick_r = (u1 < reflect_p) | tir
    wi = xp.where(pick_r[..., None], wr, wt)
    cos_o = xp.maximum(abs_cos_theta(wi), 1e-6)
    # f/pdf carry the lobe probability, so throughput f*cos/pdf is exact
    w_refl = DELTA_PDF * reflect_p / cos_o
    w_refr = DELTA_PDF * (1.0 - reflect_p) * (eta * eta) / cos_o
    f = color * xp.where(pick_r, w_refl, w_refr)[..., None]
    pdf = DELTA_PDF * xp.where(pick_r, reflect_p, 1.0 - reflect_p)
    pdf = xp.maximum(pdf, 1e-12)
    return wi, f, pdf


def _specular_sample(color, wo):
    """Perfect mirror: delta reflection about the shading normal."""
    xp = _xp(wo)
    z_flip = xp.asarray([-1.0, -1.0, 1.0], xp.float32)
    wi = wo * z_flip
    cos_i = xp.maximum(abs_cos_theta(wi), 1e-6)
    f = color * (DELTA_PDF / cos_i)[..., None]
    pdf = xp.full(wo.shape[:-1], DELTA_PDF, xp.float32)
    return wi, f, pdf


# ------------------------------ dispatch ----------------------------------

def eval_local(params, wo, wi):
    xp = _xp(wo)
    fd = _diffuse_eval(params["color"], wo, wi)
    fm = _micro_eval(params["color"], params["dist"], params["alpha"], wo, wi)
    is_mf = (params["kind"] == CLOSURE_MICROFACET)[..., None]
    f = xp.where(is_mf, fm, fd)
    # delta closures evaluate to zero for any sampled direction
    zero = (
        (params["kind"] == CLOSURE_NULL)
        | (params["kind"] == CLOSURE_SPECULAR)
        | (params["kind"] == CLOSURE_GLASS)
    )
    return xp.where(zero[..., None], 0.0, f)


def pdf_local(params, wo, wi):
    xp = _xp(wo)
    pd = _diffuse_pdf(wo, wi)
    pm = _micro_pdf(params["dist"], params["alpha"], wo, wi)
    pdf = xp.where(params["kind"] == CLOSURE_MICROFACET, pm, pd)
    zero = (
        (params["kind"] == CLOSURE_NULL)
        | (params["kind"] == CLOSURE_SPECULAR)
        | (params["kind"] == CLOSURE_GLASS)
    )
    pdf = xp.where(zero, 0.0, pdf)
    return pdf * params["choice_pdf"]


def sample_local(params, wo, u):
    xp = _xp(wo)
    wi_d, f_d, p_d = _diffuse_sample(params["color"], wo, u)
    wi_m, f_m, p_m = _micro_sample(
        params["color"], params["dist"], params["alpha"], wo, u
    )
    wi_s, f_s, p_s = _specular_sample(params["color"], wo)
    ior = params.get("ior", 1.5)
    if not hasattr(ior, "shape"):
        ior = xp.full(wo.shape[:-1], ior, xp.float32)
    wi_g, f_g, p_g = _glass_sample(params["color"], ior, wo, u[..., 0])
    is_mf = params["kind"] == CLOSURE_MICROFACET
    is_sp = params["kind"] == CLOSURE_SPECULAR
    is_gl = params["kind"] == CLOSURE_GLASS
    wi = xp.where(is_sp[..., None], wi_s, xp.where(is_mf[..., None], wi_m, wi_d))
    f = xp.where(is_sp[..., None], f_s, xp.where(is_mf[..., None], f_m, f_d))
    pdf = xp.where(is_sp, p_s, xp.where(is_mf, p_m, p_d))
    wi = xp.where(is_gl[..., None], wi_g, wi)
    f = xp.where(is_gl[..., None], f_g, f)
    pdf = xp.where(is_gl, p_g, pdf)
    null = params["kind"] == CLOSURE_NULL
    f = xp.where(null[..., None], 0.0, f)
    pdf = xp.where(null, 0.0, pdf) * params["choice_pdf"]
    return wi, f, pdf


# --------------------------- world-frame wrapper ---------------------------

def make_frame(ns):
    """Shading frame from shading normal (ref: BSDF ctor, material.h:157)."""
    t, b = onb(ns)
    return t, b, ns


def eval_world(params, frame, wo_w, wi_w):
    t, b, n = frame
    return eval_local(params, to_local(t, b, n, wo_w), to_local(t, b, n, wi_w))


def pdf_world(params, frame, wo_w, wi_w):
    t, b, n = frame
    return pdf_local(params, to_local(t, b, n, wo_w), to_local(t, b, n, wi_w))


def sample_world(params, frame, wo_w, u):
    t, b, n = frame
    wi_l, f, pdf = sample_local(params, to_local(t, b, n, wo_w), u)
    return to_world(t, b, n, wi_l), f, pdf


# ---------------------- Fresnel terms (ref: bsdf-funcs.h) -------------------

def fresnel_dielectric(cos_i, eta_i, eta_t):
    """Unpolarized dielectric Fresnel reflectance.

    ref: kernel/bsdf-funcs.h fr_dielectric (declared there, unused by the
    reference's closures; provided here for the specular/transmission
    closures and for API parity). Handles total internal reflection.
    """
    xp = _xp(cos_i)
    cos_i = xp.clip(cos_i, -1.0, 1.0)
    # swap indices when exiting
    entering = cos_i > 0.0
    ei = xp.where(entering, eta_i, eta_t)
    et = xp.where(entering, eta_t, eta_i)
    ci = xp.abs(cos_i)
    sin_t = ei / et * xp.sqrt(xp.maximum(0.0, 1.0 - ci * ci))
    tir = sin_t >= 1.0
    ct = xp.sqrt(xp.maximum(0.0, 1.0 - sin_t * sin_t))
    r_par = (et * ci - ei * ct) / xp.maximum(et * ci + ei * ct, 1e-9)
    r_perp = (ei * ci - et * ct) / xp.maximum(ei * ci + et * ct, 1e-9)
    fr = 0.5 * (r_par * r_par + r_perp * r_perp)
    return xp.where(tir, 1.0, fr)


def fresnel_conductor(cos_i, eta, k):
    """Conductor Fresnel reflectance (ref: bsdf-funcs.h fr_conductor).

    eta, k may be per-channel [..., 3] for colored metals.
    """
    xp = _xp(cos_i)
    ci = xp.clip(xp.abs(cos_i), 0.0, 1.0)
    if getattr(eta, "ndim", 0) > getattr(ci, "ndim", 0):
        ci = ci[..., None]
    ci2 = ci * ci
    si2 = 1.0 - ci2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - si2
    a2b2 = xp.sqrt(xp.maximum(t0 * t0 + 4.0 * e2 * k2, 0.0))
    t1 = a2b2 + ci2
    a = xp.sqrt(xp.maximum(0.5 * (a2b2 + t0), 0.0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / xp.maximum(t1 + t2, 1e-9)
    t3 = ci2 * a2b2 + si2 * si2
    t4 = t2 * si2
    rp = rs * (t3 - t4) / xp.maximum(t3 + t4, 1e-9)
    return 0.5 * (rp + rs)


def fresnel_schlick(cos_i, f0):
    """Schlick approximation (common production shorthand)."""
    xp = _xp(cos_i)
    m = xp.clip(1.0 - xp.abs(cos_i), 0.0, 1.0)
    if getattr(f0, "ndim", 0) > getattr(cos_i, "ndim", 0):
        m = m[..., None]
    return f0 + (1.0 - f0) * (m ** 5)
