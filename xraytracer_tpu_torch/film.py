"""Framebuffer: gamma and pure-Python image writers.

PyTorch counterpart of ``xraytracer_tpu/film.py`` and of the reference's
``Image`` (reference: Src/image.h:11-150). Accumulation happens on the
device in float32 (renderer.py); gamma and 8-bit quantization run on the
host image and mirror ``gammaCorrection``/``writeMat`` (Src/image.h:80-90,
116-143). The OpenCV dependency is replaced with PPM and zlib-PNG writers.
The ctypes tier over ``native/libxrt_native.so`` is not ported yet
(ROADMAP.md); the pure-Python writers below are the JAX package's fallback
path.
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
    """Gamma-correct float HDR (H,W,3) -> 8-bit file by extension (ASCII
    P3 PPM for ``.ppm``, PNG otherwise)."""
    u8 = to_u8(gamma_correct(img, gamma))
    if str(path).endswith(".ppm"):
        write_ppm(path, u8)
    else:
        write_png(path, u8)
    return u8
