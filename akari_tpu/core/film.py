"""Film: radiance + weight accumulation planes (ref: src/akari/core/film.h:33-116).

The reference accumulates per-tile ``Pixel{radiance, weight}`` then merges
tiles under a mutex. Here the whole frame's samples are produced as a
``[S, H, W, 3]`` batch (or per-shard slices), so accumulation is a plain
sum-reduce — and the multi-chip merge is a ``psum`` (parallel/render.py)
instead of a mutex.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .spectrum import to_uint8_srgb
from .vecmath import _xp


@dataclass
class Film:
    """Host-side accumulation state; value arrays may be numpy or jax."""

    radiance: object  # [H, W, 3] float32
    weight: object    # [H, W] float32

    @staticmethod
    def zeros(height, width, xp=np):
        return Film(
            radiance=xp.zeros((height, width, 3), dtype=xp.float32),
            weight=xp.zeros((height, width), dtype=xp.float32),
        )

    def add(self, radiance, weight):
        return Film(self.radiance + radiance, self.weight + weight)

    def develop(self):
        """Normalize to a [H,W,3] linear image (ref: film.h write_image)."""
        xp = _xp(self.radiance)
        w = xp.where(self.weight > 0.0, self.weight, 1.0)[..., None]
        return self.radiance / w

    def to_srgb_u8(self):
        return to_uint8_srgb(np.asarray(self.develop()))


def accumulate_samples(sample_radiance):
    """[S, H, W, 3] per-sample radiance -> (radiance [H,W,3], weight [H,W])."""
    xp = _xp(sample_radiance)
    s = sample_radiance.shape[0]
    radiance = xp.sum(sample_radiance, axis=0)
    weight = xp.full(sample_radiance.shape[1:3], float(s), dtype=xp.float32)
    return radiance, weight
