"""HDR image ingestion + continuous Distribution1D (env-map readiness).

ref: src/akari/core/image.cpp:86-128 (.hdr reader),
src/akari/common/distribution.h:47-134 (sample_continuous/pdf_continuous).
"""

import numpy as np
import pytest

from akari_tpu.core import distribution as dist
from akari_tpu.core.image import read_image, write_hdr


def _hdr_test_image(h=16, w=32):
    rng = np.random.default_rng(7)
    # dynamic range well past LDR, incl. zeros
    img = rng.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32) ** 2 * 50.0
    img[0, 0] = 0.0
    img[3, 4] = (1e3, 2.5, 1e-3)
    return img


def test_hdr_roundtrip(tmp_path):
    img = _hdr_test_image()
    p = str(tmp_path / "t.hdr")
    write_hdr(p, img)
    back = read_image(p)
    assert back.shape == img.shape
    # RGBE shares one exponent across channels: error bounded by the max
    # channel's quantum (1/256 of 2^e ~ maxc/128)
    maxc = img.max(axis=-1, keepdims=True)
    assert (np.abs(back - img) <= maxc / 128.0 + 1e-6).all()
    # exact zeros survive (e == 0 encodes black)
    assert (back[img.max(axis=-1) < 1e-32] == 0.0).all()


def test_hdr_rle_scanlines(tmp_path):
    """Read a hand-built RLE-compressed .hdr (runs + literals)."""
    w, h = 16, 2
    img_row = np.zeros((w, 4), np.uint8)
    img_row[:, 0] = 100  # constant R: a run
    img_row[:, 1] = np.arange(w)  # ramp G: literals
    img_row[:, 2] = 7
    img_row[:, 3] = 130
    payload = bytearray()
    for _ in range(h):
        payload += bytes([2, 2, (w >> 8) & 0xFF, w & 0xFF])
        # R: one run of 16 x 100
        payload += bytes([128 + 16, 100])
        # G: 16 literals
        payload += bytes([16]) + bytes(range(16))
        # B: run
        payload += bytes([128 + 16, 7])
        # E: run
        payload += bytes([128 + 16, 130])
    p = str(tmp_path / "rle.hdr")
    with open(p, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(bytes(payload))
    img = read_image(p)
    assert img.shape == (h, w, 3)
    scale = 2.0 ** (130 - 136)
    np.testing.assert_allclose(img[0, :, 0], (100 + 0.5) * scale, rtol=1e-6)
    np.testing.assert_allclose(
        img[1, :, 1], (np.arange(16) + 0.5) * scale, rtol=1e-6
    )


def test_hdr_rejects_non_radiance(tmp_path):
    p = str(tmp_path / "bad.hdr")
    with open(p, "wb") as f:
        f.write(b"not a radiance file")
    with pytest.raises(ValueError):
        read_image(p)


# ---------------------------------------------------------------------------
# Continuous distribution


def test_sample_continuous_histogram():
    w = np.asarray([1.0, 3.0, 0.0, 4.0], np.float64)
    _, cdf = dist.build_cdf(w)
    u = (np.arange(40000, dtype=np.float64) + 0.5) / 40000
    x, pdf, idx = dist.sample_continuous(cdf, u.astype(np.float32))
    # stratified u -> histogram of x matches the weights
    hist, _ = np.histogram(x, bins=4, range=(0.0, 1.0))
    np.testing.assert_allclose(hist / hist.sum(), w / w.sum(), atol=2e-4)
    # returned pdf is the continuous density of the selected bin
    np.testing.assert_allclose(pdf, (w / w.sum() * 4)[idx], rtol=1e-5)
    # zero-weight bin never selected
    assert not np.any(idx == 2)


def test_pdf_continuous_matches_sample():
    w = np.asarray([0.5, 2.0, 1.5], np.float64)
    _, cdf = dist.build_cdf(w)
    u = np.linspace(0.01, 0.99, 100).astype(np.float32)
    x, pdf, _ = dist.sample_continuous(cdf, u)
    np.testing.assert_allclose(dist.pdf_continuous(cdf, x), pdf, rtol=1e-4)
    # integral of density == 1
    xs = np.linspace(0, 0.999, 3000).astype(np.float32)
    assert abs(np.mean(dist.pdf_continuous(cdf, xs)) - 1.0) < 1e-3


def test_sample_continuous_jax():
    import jax.numpy as jnp

    w = np.asarray([1.0, 2.0], np.float64)
    _, cdf = dist.build_cdf(w)
    x, pdf, idx = dist.sample_continuous(jnp.asarray(cdf), jnp.asarray([0.2, 0.9]))
    xn, pdfn, idxn = dist.sample_continuous(cdf, np.asarray([0.2, 0.9], np.float32))
    np.testing.assert_allclose(np.asarray(x), xn, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(pdf), pdfn, rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(idx), idxn)


# ---------------------------------------------------------------------------
# HDR-textured emissive quad end-to-end (ref: nodes/scene.cpp:62-88 —
# image-integral-weighted emitter power)


def test_hdr_emissive_quad_selection_weight(tmp_path):
    from akari_tpu.integrators.path import PathConfig, render
    from akari_tpu.scene.nodes import (
        DiffuseMaterial, EmissiveMaterial, ImageTexture, Mesh, Scene,
    )

    hdr = np.full((4, 4, 3), 6.0, np.float32)
    hdr[:2] = 2.0  # mean luminance = 4.0
    p = str(tmp_path / "emit.hdr")
    write_hdr(p, hdr)
    tex = ImageTexture.load(p)

    def quad(y, mat):
        v = np.asarray(
            [[-1, y, -1], [1, y, -1], [1, y, 1], [-1, y, 1]], np.float32
        )
        f = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
        return Mesh(vertices=v, indices=f, materials=[mat])

    from akari_tpu.core import transform as xform
    from akari_tpu.scene.arrays import make_camera

    cam = make_camera(xform.translate((0.0, 0.5, 4.0)), 60, 32, 32)
    sc = Scene(
        shapes=[
            quad(1.0, EmissiveMaterial(color=tex)),          # hdr emitter
            quad(1.5, EmissiveMaterial(color=(1.0, 1.0, 1.0))),  # constant
            quad(0.0, DiffuseMaterial(color=(0.7, 0.7, 0.7))),
        ],
        camera=cam,
    )
    scene = sc.compile(intersector="bvh")
    assert scene.lights.n_lights == 4
    pdf = np.asarray(scene.lights.pdf)
    # equal areas: selection pmf ratio == texture-mean ratio = 4.0 : 1.0
    # (up to RGBE quantization of the stored texels)
    np.testing.assert_allclose(pdf[:2] / pdf[2:], 4.0, rtol=1e-2)
    img = np.asarray(render(scene, cam, PathConfig(spp=2, max_depth=2), seed=0))
    assert np.isfinite(img).all() and img.mean() > 0.05


def _read_png_rgb(path):
    """Minimal decoder for write_png's output (8-bit RGB, filter 0 rows)."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        if kind == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            assert (depth, color) == (8, 2)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert np.all(raw[:, 0] == 0)
    return raw[:, 1:].reshape(h, w, 3)


def test_write_png_stdlib_roundtrip(tmp_path):
    """PNG output needs only zlib + struct: valid chunks and CRCs, and the
    pixels are the sRGB-encoded image."""
    from akari_tpu.core.image import write_png
    from akari_tpu.core.spectrum import to_uint8_srgb

    img = np.random.default_rng(0).uniform(0, 1.5, (7, 11, 3))
    path = str(tmp_path / "a.png")
    write_png(path, img.astype(np.float32))
    np.testing.assert_array_equal(
        _read_png_rgb(path), to_uint8_srgb(img.astype(np.float32))
    )


def test_write_image_by_extension(tmp_path):
    """``.npy`` keeps linear float radiance, ``.hdr`` round-trips through
    RGBE, anything else is a PNG."""
    from akari_tpu.core.image import read_image, write_image

    img = np.random.default_rng(1).uniform(0, 4, (5, 6, 3)).astype(np.float32)
    write_image(str(tmp_path / "a.npy"), img)
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), img)
    write_image(str(tmp_path / "a.hdr"), img)
    np.testing.assert_allclose(read_image(str(tmp_path / "a.hdr")), img,
                               rtol=2e-2, atol=1e-2)
    write_image(str(tmp_path / "a.png"), img)
    assert _read_png_rgb(str(tmp_path / "a.png")).shape == (5, 6, 3)
