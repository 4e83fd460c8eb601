"""Microfacet distributions: GGX / Beckmann / Phong (Z-up local frame).

Capability parity with ref: src/akari/kernel/microfacet.h:28-160
(unified MicrofacetModel with D, G1, sample_wh, pdf). Branchless over
lanes; ``dist`` selects the model per-lane via where (all three are cheap
arithmetic). Backend-generic (jnp / np).
"""

from __future__ import annotations

import numpy as np

from ..core.vecmath import (
    _xp,
    abs_cos_theta,
    cos2_theta,
    cos_theta,
    dot,
    tan2_theta,
    tan_theta,
)

GGX = 0
BECKMANN = 1
PHONG = 2

PI = np.pi


def ggx_d(alpha, m):
    xp = _xp(m)
    cz = cos_theta(m)
    c2 = cos2_theta(m)
    t2 = tan2_theta(m)
    a2 = alpha * alpha
    at = a2 + t2
    d = a2 / (PI * c2 * c2 * at * at + 1e-20)
    return xp.where(cz > 0.0, d, 0.0)


def ggx_g1(alpha, v, m):
    xp = _xp(v)
    back = dot(v, m) * cos_theta(v) <= 0.0
    g = 2.0 / (1.0 + xp.sqrt(1.0 + alpha * alpha * tan2_theta(v)))
    return xp.where(back, 0.0, g)


def beckmann_d(alpha, m):
    xp = _xp(m)
    cz = cos_theta(m)
    c2 = cos2_theta(m)
    t2 = tan2_theta(m)
    a2 = alpha * alpha
    d = xp.exp(-t2 / a2) / (PI * a2 * c2 * c2 + 1e-20)
    return xp.where(cz > 0.0, d, 0.0)


def _rational_g1(a):
    """Smith G1 rational fit shared by Beckmann/Phong (ref microfacet.h)."""
    xp = _xp(a)
    g = (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a)
    return xp.where(a < 1.6, g, 1.0)


def beckmann_g1(alpha, v, m):
    xp = _xp(v)
    back = dot(v, m) * cos_theta(v) <= 0.0
    tt = xp.abs(tan_theta(v))
    a = 1.0 / (alpha * xp.maximum(tt, 1e-9))
    return xp.where(back, 0.0, _rational_g1(a))


def phong_d(alpha, m):
    """alpha here is the Phong exponent."""
    xp = _xp(m)
    cz = cos_theta(m)
    d = (alpha + 2.0) / (2.0 * PI) * xp.power(xp.maximum(cz, 0.0), alpha)
    return xp.where(cz > 0.0, d, 0.0)


def phong_g1(alpha, v, m):
    xp = _xp(v)
    back = dot(v, m) * cos_theta(v) <= 0.0
    tt = xp.abs(tan_theta(v))
    a = xp.sqrt(0.5 * alpha + 1.0) / xp.maximum(tt, 1e-9)
    return xp.where(back, 0.0, _rational_g1(a))


def d(dist, alpha, m):
    xp = _xp(m)
    return xp.where(
        dist == GGX,
        ggx_d(alpha, m),
        xp.where(dist == BECKMANN, beckmann_d(alpha, m), phong_d(alpha, m)),
    )


def g1(dist, alpha, v, m):
    xp = _xp(v)
    return xp.where(
        dist == GGX,
        ggx_g1(alpha, v, m),
        xp.where(dist == BECKMANN, beckmann_g1(alpha, v, m), phong_g1(alpha, v, m)),
    )


def g(dist, alpha, wo, wi, m):
    return g1(dist, alpha, wo, m) * g1(dist, alpha, wi, m)


def sample_wh(dist, alpha, wo, u):
    """Sample the half-vector from D(m)|cos| (classic NDF sampling;
    ref: microfacet.h sample_wh). Returns [...,3] local wh (upper hemi)."""
    xp = _xp(u)
    u0, u1 = u[..., 0], u[..., 1]
    phi = 2.0 * PI * u1
    # GGX: tan2 = a^2 u/(1-u)
    t2_ggx = alpha * alpha * u0 / xp.maximum(1.0 - u0, 1e-9)
    # Beckmann: tan2 = -a^2 ln(1-u)
    t2_beck = -alpha * alpha * xp.log(xp.maximum(1.0 - u0, 1e-9))
    cos_p = xp.power(xp.maximum(u0, 1e-20), 1.0 / (alpha + 2.0))  # Phong
    t2 = xp.where(dist == GGX, t2_ggx, t2_beck)
    cos_t = 1.0 / xp.sqrt(1.0 + t2)
    cos_t = xp.where(dist == PHONG, cos_p, cos_t)
    sin_t = xp.sqrt(xp.maximum(0.0, 1.0 - cos_t * cos_t))
    wh = xp.stack(
        [sin_t * xp.cos(phi), sin_t * xp.sin(phi), cos_t], axis=-1
    )
    return wh


def pdf_wh(dist, alpha, m):
    """pdf of sample_wh = D(m) * |cos_theta(m)|."""
    return d(dist, alpha, m) * abs_cos_theta(m)
