"""Image read/write (ref: src/akari/core/image.{hpp,cpp} — stb-based I/O,
gamma post-processing). Here: a standard-library PNG writer, Pillow (an
optional dependency) to read PNG/JPEG textures, a pure-numpy Radiance
``.hdr`` (RGBE) reader/writer for HDR assets (ref reads .hdr via
stbi_loadf, image.cpp:86-128), numpy ``.npy`` as a lossless float format,
plus the post-process chain.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .spectrum import linear_to_srgb, srgb_to_linear, to_uint8_srgb


def _png_chunk(kind, data):
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(
        ">I", zlib.crc32(body) & 0xFFFFFFFF
    )


def write_png(path, img_linear):
    """[H,W,3] linear float -> 8-bit sRGB PNG (zlib + struct only)."""
    rgb = np.ascontiguousarray(to_uint8_srgb(img_linear)[..., :3])
    h, w = rgb.shape[:2]
    # every scanline starts with filter type 0 (none)
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1
    ).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", ihdr))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_png_chunk(b"IEND", b""))


def write_hdr_npy(path, img_linear):
    np.save(path, np.asarray(img_linear, dtype=np.float32))


def write_image(path, img_linear):
    """Write by extension: ``.npy`` / ``.hdr`` keep linear float radiance,
    anything else is an 8-bit sRGB PNG."""
    path = str(path)
    if path.endswith(".npy"):
        write_hdr_npy(path, img_linear)
    elif path.endswith(".hdr"):
        write_hdr(path, img_linear)
    else:
        write_png(path, img_linear)


# --------------------------------------------------------------------------
# Radiance .hdr (RGBE). ref: core/image.cpp:86-128 reads .hdr through stb;
# here the codec is implemented directly (vectorized mantissa/exponent
# decode; scanline RLE handled per the Radiance "new RLE" spec with the
# flat-file fallback).

def _rgbe_to_float(rgbe):
    """[..., 4] uint8 RGBE -> [..., 3] float32 linear."""
    rgbe = rgbe.astype(np.float32)
    e = rgbe[..., 3]
    scale = np.where(e > 0.0, np.ldexp(1.0, (e - 136.0).astype(np.int32)), 0.0)
    return (rgbe[..., :3] + 0.5) * scale[..., None] * (e > 0.0)[..., None]


def _float_to_rgbe(img):
    """[..., 3] float32 -> [..., 4] uint8 RGBE (max-component exponent)."""
    img = np.maximum(np.asarray(img, np.float32), 0.0)
    maxc = img.max(axis=-1)
    mant, expo = np.frexp(maxc)
    # v * 256/2^e for each channel, rounded down (Radiance convention)
    scale = np.where(maxc > 1e-32, np.ldexp(256.0, -expo), 0.0)
    rgbe = np.zeros(img.shape[:-1] + (4,), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(maxc > 1e-32, expo + 128, 0).astype(np.uint8)
    return rgbe


def _read_hdr(path):
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance .hdr file")
    # header: lines until the blank line; then the resolution line
    pos = data.index(b"\n\n") + 2
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported resolution line {res!r}")
    h, w = int(res[1]), int(res[3])
    buf = np.frombuffer(data, np.uint8, offset=eol + 1)
    out = np.empty((h, w, 4), np.uint8)
    p = 0
    for y in range(h):
        is_rle = (
            8 <= w <= 0x7FFF
            and buf[p] == 2 and buf[p + 1] == 2
            and (int(buf[p + 2]) << 8 | int(buf[p + 3])) == w
        )
        if not is_rle:
            # flat scanline: w RGBE pixels verbatim
            out[y] = buf[p:p + 4 * w].reshape(w, 4)
            p += 4 * w
            continue
        p += 4
        for c in range(4):  # each component RLE'd separately
            x = 0
            while x < w:
                count = int(buf[p])
                if count > 128:  # run
                    out[y, x:x + count - 128, c] = buf[p + 1]
                    x += count - 128
                    p += 2
                else:  # literal
                    out[y, x:x + count, c] = buf[p + 1:p + 1 + count]
                    x += count
                    p += 1 + count
            if x != w:
                raise ValueError(f"{path}: RLE overrun at row {y}")
    return _rgbe_to_float(out)


def write_hdr(path, img_linear):
    """[H,W,3] linear float -> Radiance .hdr (flat scanlines, no RLE)."""
    img = np.asarray(img_linear, np.float32)
    h, w = img.shape[:2]
    rgbe = _float_to_rgbe(img.reshape(h, w, 3))
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def read_image(path, to_linear=True):
    """Read PNG/JPEG (sRGB -> linear float), .hdr (RGBE) or .npy (linear).

    Returns [H, W, 3] float32. ref: image.cpp:86-128 ldr/hdr readers.
    """
    path = str(path)
    if path.endswith(".npy"):
        img = np.load(path).astype(np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        return img[..., :3]
    if path.endswith(".hdr"):
        return _read_hdr(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"reading {path!r} needs Pillow (pip install pillow); "
            ".hdr and .npy images need no extra package"
        ) from e

    raw = np.asarray(Image.open(path).convert("RGB"), dtype=np.float32) / 255.0
    return srgb_to_linear(raw).astype(np.float32) if to_linear else raw


# Post-processing chain (ref: image.hpp PostProcessor / GammaCorrection /
# PostProcessingPipeline) — functional composition instead of virtual classes.

def gamma_correction(img, gamma=1.0 / 2.4):
    return linear_to_srgb(img)


def identity(img):
    return img


def pipeline(*stages):
    def run(img):
        for s in stages:
            img = s(img)
        return img

    return run
