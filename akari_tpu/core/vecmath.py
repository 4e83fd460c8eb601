"""Vector math over ``[..., 3]`` arrays.

Redesign of the reference's fixed-size array math
(ref: src/akari/common/array.h:115, src/akari/common/math.h:202 Frame).
Instead of an ``Array<T,N>`` class with named lanes, everything is a plain
``[..., 3]`` array and every op is a pure function usable under ``jit``/
``vmap``/``grad``. All functions are backend-generic: they work with either
``jax.numpy`` or ``numpy`` inputs (the NumPy oracle reuses them verbatim).

Local shading frames are **Z-up**: the shading normal maps to ``(0, 0, 1)``
in local space (the reference uses Y-up, kernel/bsdf-funcs.h; the convention
is internal and does not affect rendered output).
"""

from __future__ import annotations

import numpy as np


def _xp(*arrays):
    """Pick the array namespace (jax.numpy or numpy) from the arguments."""
    for a in arrays:
        if type(a).__module__.startswith("jax"):
            import jax.numpy as jnp

            return jnp
    return np


def _highest(xp):
    """Keyword arguments that pin a jnp matrix product to full float32:
    on the GPU, XLA may otherwise compute it in TF32 (about 1e-3
    relative), which moves ray origins and hit points."""
    if xp is np:
        return {}
    import jax

    return {"precision": jax.lax.Precision.HIGHEST}


def einsum(spec, *operands, xp=None):
    """``xp.einsum`` at full float32 precision (see ``_highest``)."""
    xp = xp or _xp(*operands)
    return xp.einsum(spec, *operands, **_highest(xp))


def matmul(a, b, xp=None):
    """``a @ b`` at full float32 precision (see ``_highest``)."""
    xp = xp or _xp(a, b)
    return xp.matmul(a, b, **_highest(xp))


def vec3(x, y, z, xp=None):
    xp = xp or _xp(x, y, z)
    return xp.stack(xp.broadcast_arrays(
        xp.asarray(x, dtype=xp.float32),
        xp.asarray(y, dtype=xp.float32),
        xp.asarray(z, dtype=xp.float32)), axis=-1)


def dot(a, b, keepdims=False):
    xp = _xp(a, b)
    return xp.sum(a * b, axis=-1, keepdims=keepdims)


def cross(a, b):
    xp = _xp(a, b)
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return xp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def length2(a, keepdims=False):
    return dot(a, a, keepdims=keepdims)


def length(a, keepdims=False):
    xp = _xp(a)
    return xp.sqrt(length2(a, keepdims=keepdims))


def normalize(a, eps=0.0):
    """Normalize; with eps>0 guards against zero vectors (returns 0)."""
    xp = _xp(a)
    n2 = length2(a, keepdims=True)
    if eps > 0.0:
        inv = xp.where(n2 > eps, 1.0 / xp.sqrt(xp.maximum(n2, eps)), 0.0)
        return a * inv
    return a / xp.sqrt(n2)


def distance(a, b):
    return length(a - b)


def lerp(a, b, t):
    return a + (b - a) * t


def reflect(w, n):
    """Mirror ``w`` about normal ``n`` (both pointing away from surface).

    ref convention: kernel/bsdf-funcs.h reflect = -w + 2*dot(w,n)*n.
    """
    return -w + 2.0 * dot(w, n, keepdims=True) * n


def refract(wi, n, eta):
    """Refract ``wi`` about ``n`` with relative IOR ``eta``.

    Returns (ok_mask, wt). ref: kernel/bsdf-funcs.h fr_dielectric companion.
    """
    xp = _xp(wi, n)
    cos_i = dot(n, wi)
    sin2_i = xp.maximum(0.0, 1.0 - cos_i * cos_i)
    sin2_t = eta * eta * sin2_i
    ok = sin2_t < 1.0
    cos_t = xp.sqrt(xp.maximum(0.0, 1.0 - sin2_t))
    wt = eta * -wi + (eta * cos_i - cos_t)[..., None] * n
    return ok, wt


def face_forward(n, v):
    """Flip n so it lies in the same hemisphere as v."""
    xp = _xp(n, v)
    return xp.where(dot(n, v, keepdims=True) < 0.0, -n, n)


# ---------------------------------------------------------------------------
# Orthonormal frames (ref: Frame, src/akari/common/math.h:202 — but Z-up here)
# ---------------------------------------------------------------------------

def onb(n):
    """Build an orthonormal basis (t, b) around unit normal n (Z axis).

    Branchless Duff et al. / Pixar construction; stable for all n, and works
    under vmap/jit (no data-dependent branches).
    """
    xp = _xp(n)
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    s = xp.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    t = xp.stack([1.0 + s * nx * nx * a, s * b, -s * nx], axis=-1)
    bt = xp.stack([b, s + ny * ny * a, -ny], axis=-1)
    return t, bt


def to_local(t, b, n, w):
    """World direction -> local Z-up shading space."""
    xp = _xp(w)
    return xp.stack([dot(w, t), dot(w, b), dot(w, n)], axis=-1)


def to_world(t, b, n, w):
    """Local Z-up shading space -> world."""
    return (
        w[..., 0:1] * t + w[..., 1:2] * b + w[..., 2:3] * n
    )


# ---------------------------------------------------------------------------
# Local-frame trig helpers (Z-up; ref: kernel/bsdf-funcs.h:26-114 uses Y-up)
# ---------------------------------------------------------------------------

def cos_theta(w):
    return w[..., 2]


def abs_cos_theta(w):
    xp = _xp(w)
    return xp.abs(w[..., 2])


def cos2_theta(w):
    return w[..., 2] * w[..., 2]


def sin2_theta(w):
    xp = _xp(w)
    return xp.maximum(0.0, 1.0 - cos2_theta(w))


def sin_theta(w):
    xp = _xp(w)
    return xp.sqrt(sin2_theta(w))


def tan_theta(w):
    xp = _xp(w)
    return sin_theta(w) / xp.where(cos_theta(w) == 0.0, 1e-20, cos_theta(w))


def tan2_theta(w):
    xp = _xp(w)
    return sin2_theta(w) / xp.where(cos2_theta(w) == 0.0, 1e-20, cos2_theta(w))


def same_hemisphere(wa, wb):
    return wa[..., 2] * wb[..., 2] > 0.0
