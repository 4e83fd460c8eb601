"""Component-SoA 3-vectors: a V3 is three separate [N] arrays.

Carrying each component of a per-ray 3-vector as its own 1-D ``[N]``
array keeps every elementwise op dense over the ray axis and every
scan-carry/residual minimal, with no narrow minor dimension for the
compiler to pad or relayout. It is this renderer's answer to the
reference's ``SOA<T>`` codegen (ref: src/akari/common/soa.h:47-104,
tools/soac.cpp): there the compiler generated per-field parallel arrays;
here the pytree IS the SoA.

Works identically with jax.numpy and numpy leaves (the oracle runs it).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np


def _xp(*arrays):
    for a in arrays:
        if type(a).__module__.startswith("jax"):
            import jax.numpy as jnp

            return jnp
    return np


class V3(NamedTuple):
    """Three parallel [N] components. Also used for RGB (x=r, y=g, z=b)."""

    x: Any
    y: Any
    z: Any

    # -- elementwise arithmetic (V3 op V3, or V3 op [N]/scalar) ------------
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    # -- reductions ---------------------------------------------------------
    def dot(self, o):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o):
        return V3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def max_comp(self):
        xp = _xp(self.x)
        return xp.maximum(xp.maximum(self.x, self.y), self.z)

    def norm2(self):
        return self.dot(self)

    def normalized(self, eps=0.0):
        xp = _xp(self.x)
        n2 = self.norm2()
        if eps > 0.0:
            inv = xp.where(n2 > eps, 1.0 / xp.sqrt(xp.maximum(n2, eps)), 0.0)
        else:
            inv = 1.0 / xp.sqrt(n2)
        return self * inv

    def astype(self, dtype):
        return V3(
            self.x.astype(dtype), self.y.astype(dtype), self.z.astype(dtype)
        )

    def isfinite_all(self):
        xp = _xp(self.x)
        return xp.isfinite(self.x) & xp.isfinite(self.y) & xp.isfinite(self.z)

    # -- boundary conversions ------------------------------------------------
    def stack(self, xp=None):
        """-> [N, 3] (film/API boundary only; never inside the hot loop)."""
        xp = xp or _xp(self.x)
        return xp.stack(xp.broadcast_arrays(self.x, self.y, self.z), axis=-1)


def v3where(m, a, b):
    """Per-lane select with an [N] mask."""
    xp = _xp(m)
    if not isinstance(a, V3):
        a = V3(a, a, a)
    if not isinstance(b, V3):
        b = V3(b, b, b)
    return V3(
        xp.where(m, a.x, b.x), xp.where(m, a.y, b.y), xp.where(m, a.z, b.z)
    )


def v3splat(v, xp=np):
    """Constant 3-vector (python/np scalars) -> V3 of 0-d arrays."""
    v = np.asarray(v, np.float32)
    return V3(
        xp.asarray(v[0], xp.float32),
        xp.asarray(v[1], xp.float32),
        xp.asarray(v[2], xp.float32),
    )


def from_stack(arr):
    """[..., 3] -> V3 (boundary helper)."""
    return V3(arr[..., 0], arr[..., 1], arr[..., 2])


def from_rows(arr, row0=0):
    """[C, N] gathered row block -> V3 of three consecutive rows."""
    return V3(arr[row0], arr[row0 + 1], arr[row0 + 2])


def reflect3(w, n):
    """Mirror w about n (both away from surface): -w + 2*dot(w,n)*n."""
    return -w + n * (2.0 * w.dot(n))


def onb3(n):
    """Branchless Duff/Pixar orthonormal basis about unit normal n."""
    xp = _xp(n.x)
    s = xp.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n.z)
    b = n.x * n.y * a
    t = V3(1.0 + s * n.x * n.x * a, s * b, -s * n.x)
    bt = V3(b, s + n.y * n.y * a, -n.y)
    return t, bt


def to_local3(t, b, n, w):
    return V3(w.dot(t), w.dot(b), w.dot(n))


def to_world3(t, b, n, w):
    return t * w.x + b * w.y + n * w.z
