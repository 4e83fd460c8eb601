"""Deterministic counter-based RNG (stateless, seed-matched across backends).

Replaces the reference's stateful PCG32/LCG samplers (ref:
src/akari/kernel/sampler.h:28-76, seeded per pixel, drawn sequentially).
A stateful sequential sampler is hostile to SPMD tracing; instead every
sample is a pure function of ``(seed, pixel, sample_index, dimension)``
via PCG output-function hashing (O'Neill 2014 / Jarzynski & Olano 2020 —
public-domain constructions). The exact same integer arithmetic runs under
``jax.numpy`` (device) and ``numpy`` (oracle), which is what makes the
"matched sampler seeds, allclose images" golden tests possible.

Sample-stream layout (fixed, documented so the oracle consumes identically):

- dims 0-1: camera film jitter;  dims 2-3: lens (reserved)
- per bounce ``b``: base = 4 + b * DIMS_PER_BOUNCE, offsets:
  +0,+1 bsdf sample u;  +2 material mix select;  +3 light select;
  +4,+5 light surface sample;  +6 russian roulette;  +7 reserved
"""

from __future__ import annotations

import numpy as np

DIM_CAMERA = 0
DIM_LENS = 2
DIMS_BASE = 4
DIMS_PER_BOUNCE = 8
OFF_BSDF_U = 0
OFF_MIX = 2
OFF_LIGHT_SELECT = 3
OFF_LIGHT_U = 4
OFF_RR = 6


def _xp_of(x):
    if type(x).__module__.startswith("jax"):
        import jax.numpy as jnp

        return jnp
    return np


def _u32(xp, x):
    return xp.asarray(x, dtype=xp.uint32)


def pcg_hash(x):
    """PCG output-function hash: uint32 -> uint32 (well-distributed)."""
    xp = _xp_of(x)
    x = _u32(xp, x)
    with np.errstate(over="ignore"):
        state = x * np.uint32(747796405) + np.uint32(2891336453)
        word = (
            (state >> ((state >> np.uint32(28)) + np.uint32(4))) ^ state
        ) * np.uint32(277803737)
        return (word >> np.uint32(22)) ^ word


def hash_combine(a, b):
    """Mix two uint32 streams: h(a ^ h(b))."""
    xp = _xp_of(a)
    return pcg_hash(_u32(xp, a) ^ pcg_hash(b))


def random_u32(seed, pixel, sample, dim):
    """uint32 random word for lattice point (seed, pixel, sample, dim).

    All args broadcastable uint32/int arrays. Two rounds of PCG hashing over
    the mixed counter gives high-quality decorrelation between dimensions.
    """
    xp = _xp_of(pixel)
    seed = _u32(xp, seed)
    pixel = _u32(xp, pixel)
    sample = _u32(xp, sample)
    dim = _u32(xp, dim)
    with np.errstate(over="ignore"):
        key = pcg_hash(seed ^ pcg_hash(dim ^ pcg_hash(sample)))
        return pcg_hash(pixel * np.uint32(0x9E3779B9) + key)


def uniform(seed, pixel, sample, dim):
    """float32 uniform in [0, 1) for the given lattice point."""
    xp = _xp_of(pixel)
    bits = random_u32(seed, pixel, sample, dim)
    # 2^-32 scaling; cap below 1.0 in f32.
    u = bits.astype(xp.float32) * xp.float32(2.3283064365386963e-10)
    return xp.minimum(u, xp.float32(0.99999994))


def uniform2(seed, pixel, sample, dim):
    """Two consecutive dims as a [..., 2] array."""
    xp = _xp_of(pixel)
    return xp.stack(
        [uniform(seed, pixel, sample, dim), uniform(seed, pixel, sample, dim + 1)],
        axis=-1,
    )


def bounce_dim(bounce, offset):
    """Dimension index for a per-bounce draw (static python ints or arrays)."""
    return DIMS_BASE + bounce * DIMS_PER_BOUNCE + offset
