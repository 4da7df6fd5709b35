"""Image post-processing and PNG I/O.

Reference: RTrace/image.swift — fp16 texture readback + CPU exposure/Reinhard/
gamma (saveTextureToImage, :15-100), raw RGBA8 writing (savePixelArrayToImage,
:102-157), and the gradient test pattern (createGradientPixels, :160-178).

Counterpart of ``gpuraytracer_tpu/image.py``, numpy only. The tonemap here is
the host-side post step for the variant-B HDR output; PNGs are written by the
native C++ encoder (``native.py``) where ``g++`` could build it, else by a
pure-python encoder.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def tonemap(hdr: np.ndarray, exposure: float = 2.0, gamma: float = 2.2) -> np.ndarray:
    """Variant-B CPU post: value *= exposure; Reinhard v/(v+1); gamma 1/2.2
    (image.swift:41-65). Input [H, W, 3] linear f32; output [H, W, 3] uint8."""
    v = np.asarray(hdr, np.float32) * exposure
    v = v / (v + 1.0)
    v = np.power(np.clip(v, 0.0, 1.0), 1.0 / gamma)
    return (np.clip(v, 0.0, 1.0) * 255.0).astype(np.uint8)


def to_uint8(ldr: np.ndarray) -> np.ndarray:
    """[0,1] floats -> uint8, truncating like ``uchar(color * 255)``
    (sampling.metal:32-34)."""
    return (np.clip(np.asarray(ldr, np.float32), 0.0, 1.0) * 255.0).astype(np.uint8)


def write_png(path: str, rgb: np.ndarray) -> None:
    """PNG writer (RGB8 or RGBA8). Replaces the CGImage/ImageIO pipeline
    (image.swift:68-99). Uses the native C++ encoder where it is built;
    ``write_png_python`` otherwise."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8:
        rgb = to_uint8(rgb)
    if rgb.ndim != 3 or rgb.shape[2] not in (3, 4):
        raise ValueError(f"expected [H, W, 3|4] uint8, got {rgb.shape}")
    from . import native
    if native.available():
        native.write_png(path, rgb)
        return
    write_png_python(path, rgb)


def write_png_python(path: str, rgb: np.ndarray) -> None:
    """The pure-python zlib PNG encoder of [H, W, 3|4] uint8."""
    h, w, c = rgb.shape
    color_type = 2 if c == 3 else 6

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(
            ">I", zlib.crc32(body) & 0xFFFFFFFF)

    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))
    png = b"".join([
        b"\x89PNG\r\n\x1a\n",
        chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)),
        chunk(b"IDAT", zlib.compress(raw, 6)),
        chunk(b"IEND", b""),
    ])
    with open(path, "wb") as f:
        f.write(png)


def read_png(path: str) -> np.ndarray:
    """Read a PNG written by write_png (8-bit RGB/RGBA, no interlace)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    idat = b""
    w = h = c = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color_type = struct.unpack(">IIBB", body[:10])
            assert depth == 8, "only 8-bit supported"
            c = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * c
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        line = np.frombuffer(
            raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)], np.uint8
        ).copy()
        if ftype == 0:
            pass
        elif ftype == 2:  # Up
            line = (line.astype(np.int32) + prev).astype(np.uint8)
        elif ftype == 1:  # Sub
            for x in range(c, stride):
                line[x] = (int(line[x]) + int(line[x - c])) & 0xFF
        elif ftype == 3:  # Average
            for x in range(stride):
                left = int(line[x - c]) if x >= c else 0
                line[x] = (int(line[x]) + (left + int(prev[x])) // 2) & 0xFF
        elif ftype == 4:  # Paeth
            for x in range(stride):
                a = int(line[x - c]) if x >= c else 0
                b = int(prev[x])
                cc = int(prev[x - c]) if x >= c else 0
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                line[x] = (int(line[x]) + pred) & 0xFF
        out[y] = line
        prev = line
    return out.reshape(h, w, c)


def gradient_pixels(width: int, height: int) -> np.ndarray:
    """Test-pattern generator (createGradientPixels, image.swift:160-178):
    red ramps left->right, green ramps top->bottom, blue = 128."""
    x = np.arange(width, dtype=np.float32)
    y = np.arange(height, dtype=np.float32)
    r = np.broadcast_to((x / width * 255.0).astype(np.uint8), (height, width))
    g = np.broadcast_to((y / height * 255.0).astype(np.uint8)[:, None],
                        (height, width))
    b = np.full((height, width), 128, np.uint8)
    a = np.full((height, width), 255, np.uint8)
    return np.stack([r, g, b, a], axis=-1)


def row_means(hdr: np.ndarray) -> np.ndarray:
    """Row-averaged debug statistics — the reference's
    ``writeDebugArrayToFile`` trick (computeShader.swift:211-230): average
    each row's float3 values for numeric inspection of a stochastic render."""
    return np.asarray(hdr, np.float32).mean(axis=1)


def write_debug_file(path: str, hdr: np.ndarray) -> None:
    """debugOutput.txt equivalent (computeShader.swift:211-230)."""
    means = row_means(hdr)
    with open(path, "w") as f:
        for row in means:
            f.write(f"{row[0]:.6f} {row[1]:.6f} {row[2]:.6f}\n")
