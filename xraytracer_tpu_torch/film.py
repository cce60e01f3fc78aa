"""Framebuffer: gamma, and the image writers.

PyTorch counterpart of ``xraytracer_tpu/film.py`` and of the reference's
``Image`` (reference: Src/image.h:11-150). Accumulation happens on the
device in float32 (renderer.py); gamma and 8-bit quantization run on the
host image and mirror ``gammaCorrection``/``writeMat`` (Src/image.h:80-90,
116-143). The OpenCV dependency is replaced with PPM and zlib-PNG writers:
the native C++ tier's (``native.py``) when it loads, the pure-Python ones
below otherwise; these are also the writers' plain versions.
"""

import struct
import zlib

import numpy as np


def gamma_correct(img, gamma):
    """x^(1/gamma), matching Src/image.h:80-90."""
    arr = np.maximum(np.asarray(img, np.float32), np.float32(0.0))
    return np.power(arr, np.float32(1.0 / gamma))


def to_u8(img):
    """255*x clamped to [0,255], truncation semantics as the C++ static_cast
    (Src/image.h:121-127)."""
    arr = np.asarray(img)
    return np.clip((255.0 * arr).astype(np.int64), 0, 255).astype(np.uint8)


def write_ppm(path, img_u8):
    """ASCII PPM (reference: Src/image.h:92-114)."""
    h, w, _ = img_u8.shape
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        for row in img_u8.reshape(h, w * 3):
            f.write(" ".join(map(str, row.tolist())) + "\n")


def write_png(path, img_u8):
    """Minimal zlib PNG writer (RGB8), no external deps."""
    h, w, _ = img_u8.shape
    raw = b"".join(
        b"\x00" + img_u8[i].tobytes() for i in range(h)
    )

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(
            ">I", zlib.crc32(c) & 0xFFFFFFFF
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def write_image(path, img, gamma=2.2):
    """Gamma-correct float HDR (H,W,3) -> 8-bit file by extension.

    Encoding uses the native C++ tier when available (ascii-P3 PPM parity
    with the reference is kept on the Python path; the native PPM is binary
    P6)."""
    from . import native

    u8 = to_u8(gamma_correct(img, gamma))
    if str(path).endswith(".ppm"):
        if not native.write_ppm(path, u8):
            write_ppm(path, u8)
    else:
        if not native.write_png(path, u8):
            write_png(path, u8)
    return u8
