"""Host-side image files: EXR (half RGBA, uncompressed; written and read
back) and PNG.

A numpy-only copy of `drt_tpu.utils.image` (whose package imports jax).
The reference writes RGBA half EXRs through OpenEXR
(reference: src/write.hpp:9-26); this is a dependency-free writer for the
same on-disk format: EXR 2.0, scanline, NO compression, half-float
R/G/B/A channels — readable by OpenEXR tooling. PNG (8-bit,
gamma-encoded) is provided for quick previews.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _exr_attr(name: bytes, type_: bytes, value: bytes) -> bytes:
    return name + b"\x00" + type_ + b"\x00" + struct.pack("<i", len(value)) + value


def write_exr(path: str, img: np.ndarray) -> None:
    """Write f[H,W,3] (or [H,W,4]) linear radiance as an uncompressed
    half-float RGBA EXR (alpha = 1 if absent), matching the reference's
    output format (src/write.hpp:20 `WRITE_RGBA`)."""
    img = np.asarray(img, dtype=np.float32)
    h, w = img.shape[:2]
    if img.shape[2] == 3:
        img = np.concatenate([img, np.ones((h, w, 1), np.float32)], axis=2)
    half = img.astype(np.float16)

    # Channel list: alphabetical (A, B, G, R), planar per scanline.
    chan = b""
    for name in (b"A", b"B", b"G", b"R"):
        chan += name + b"\x00" + struct.pack("<iiii", 1, 0, 1, 1)
    chan += b"\x00"

    header = b""
    header += _exr_attr(b"channels", b"chlist", chan)
    header += _exr_attr(b"compression", b"compression", b"\x00")  # NONE
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _exr_attr(b"dataWindow", b"box2i", box)
    header += _exr_attr(b"displayWindow", b"box2i", box)
    header += _exr_attr(b"lineOrder", b"lineOrder", b"\x00")  # INCREASING_Y
    header += _exr_attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _exr_attr(b"screenWindowCenter", b"v2f",
                        struct.pack("<ff", 0.0, 0.0))
    header += _exr_attr(b"screenWindowWidth", b"float",
                        struct.pack("<f", 1.0))
    header += b"\x00"  # end of header

    magic = struct.pack("<i", 20000630) + struct.pack("<i", 2)
    offset_table_pos = len(magic) + len(header)
    first_scanline = offset_table_pos + 8 * h
    scanline_bytes = 8 + 4 * w * 2  # y + size + 4 channels of half

    offsets = b"".join(
        struct.pack("<Q", first_scanline + y * scanline_bytes)
        for y in range(h))

    with open(path, "wb") as f:
        f.write(magic)
        f.write(header)
        f.write(offsets)
        for y in range(h):
            f.write(struct.pack("<ii", y, 4 * w * 2))
            # planar, channels in header (alphabetical) order: A, B, G, R
            f.write(half[y, :, 3].tobytes())
            f.write(half[y, :, 2].tobytes())
            f.write(half[y, :, 1].tobytes())
            f.write(half[y, :, 0].tobytes())


def read_exr(path: str) -> np.ndarray:
    """Read back EXRs written by `write_exr` (uncompressed half RGBA only).
    Returns f32[H,W,4]. For test roundtrips; not a general EXR reader."""
    with open(path, "rb") as f:
        data = f.read()
    if struct.unpack("<i", data[0:4])[0] != 20000630:
        raise ValueError(f"{path} is not an EXR")
    pos = 8
    attrs = {}
    while data[pos] != 0:
        e = data.index(b"\x00", pos)
        name = data[pos:e]
        pos = e + 1
        e = data.index(b"\x00", pos)
        type_ = data[pos:e]
        pos = e + 1
        size = struct.unpack("<i", data[pos:pos + 4])[0]
        pos += 4
        attrs[name] = (type_, data[pos:pos + size])
        pos += size
    pos += 1
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs[b"dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    if attrs[b"compression"][1] != b"\x00":
        raise ValueError(f"{path}: only NONE compression is read")
    pos += 8 * h  # skip offset table
    out = np.zeros((h, w, 4), np.float32)
    for y in range(h):
        _, size = struct.unpack("<ii", data[pos:pos + 8])
        pos += 8
        row = np.frombuffer(data[pos:pos + size], np.float16)
        pos += size
        a, b, g, r = (row[0:w], row[w:2 * w], row[2 * w:3 * w],
                      row[3 * w:4 * w])
        out[y, :, 0] = r
        out[y, :, 1] = g
        out[y, :, 2] = b
        out[y, :, 3] = a
    return out


def write_png(path: str, img: np.ndarray, gamma: float = 2.2) -> None:
    """Write f[H,W,3] linear radiance as an 8-bit gamma-encoded PNG
    (dependency-free; stdlib zlib)."""
    img = np.asarray(img, dtype=np.float32)
    enc = np.clip(img, 0.0, 1.0) ** (1.0 / gamma)
    u8 = (enc * 255.0 + 0.5).astype(np.uint8)
    h, w = u8.shape[:2]
    raw = b"".join(b"\x00" + u8[y].tobytes() for y in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
