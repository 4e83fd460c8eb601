"""Dtype policy — the analog of the reference's build-time variant
system (ref: resources/akari.conf + tools/configure.cpp generating
Config<Float, Spectrum> instantiations): here a "variant" is just the
dtype the wavefront state carries — JAX retraces automatically, so variants
are runtime values. Consumed by integrators.path.PathConfig (``dtypes``)
and selectable from the render CLI (``--spectrum-dtype``).
"""

from __future__ import annotations

from dataclasses import dataclass

import ml_dtypes
import numpy as np


@dataclass(frozen=True)
class DtypePolicy:
    """Numeric policy for the render pipeline.

    spectrum: dtype radiance/throughput (L, beta) are carried in across the
    bounce scan — bf16 halves the wavefront state's memory footprint at
    some quantization-noise cost (the experiment the reference's
    float/double variants gesture at; `bench.py --full` times the A/B).
    geometry: dtype for vertices / traversal (keep f32: Moeller-Trumbore
    dets cancel catastrophically in bf16).
    accum: film accumulation (keep f32: many-sample sums need the mantissa).
    """

    spectrum: object = np.float32
    geometry: object = np.float32
    accum: object = np.float32


RGB = DtypePolicy()
RGB_BF16 = DtypePolicy(spectrum=ml_dtypes.bfloat16)


def variant_string(policy=RGB):
    """ref: get_variant_string (generated config.h)."""

    def name(dt):
        return np.dtype(dt).name

    return f"rgb-{name(policy.spectrum)}-{name(policy.geometry)}"
