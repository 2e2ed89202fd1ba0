"""The port's PNG reader (zlib and numpy only).

The JAX package reads dataset images through Pillow
(`dvm_slam_tpu/io/datasets.py::_read_gray`, `RgbdSequence._read_depth`). The
port reads them here, so it needs no image library: `read_gray` returns what
`np.asarray(Image.open(p).convert("L"), np.float32)` returns, bit for bit,
and `read_raw` what `np.asarray(Image.open(p), np.float32)` returns for a
grayscale file (the raw 16-bit values of a depth map).

Formats: 8-bit grayscale, 8-bit RGB and RGBA (reduced to Pillow's integer
ITU-R 601 luma, `(19595 R + 38470 G + 7471 B + 2^15) >> 16`) and 16-bit
grayscale, not interlaced, with any of the five row filters. Anything else
raises `ValueError` naming the format.

Sub, Average and Paeth read the reconstructed left neighbour, so the rows
are rebuilt as a wavefront: pixel (r, x) depends on (r, x-1), (r-1, x) and
(r-1, x-1) only, so every anti-diagonal r + x = d is one vector step over
the rows, whatever their filters.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> (name, channels); bit depths each supports here
_COLOR = {0: ("grayscale", 1), 2: ("RGB", 3), 3: ("palette", 1), 4: ("grayscale+alpha", 2),
          6: ("RGBA", 4)}
_SUPPORTED = {(0, 8), (0, 16), (2, 8), (6, 8)}


def _chunks(data: bytes, path: str):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: corrupt {kind.decode('latin-1')} chunk (CRC mismatch)")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def decode(data: bytes, path: str = "<bytes>"):
    """The pixels of a PNG file's bytes: uint8 [H,W] (grayscale), [H,W,3]
    (RGB), [H,W,4] (RGBA) or uint16 [H,W] (16-bit grayscale)."""
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, color, compression, filt, interlace = header
    name, channels = _COLOR.get(color, (f"color type {color}", 1))
    if (color, depth) not in _SUPPORTED:
        raise ValueError(f"{path}: unsupported PNG format: {depth}-bit {name} (the reader "
                         f"takes 8-bit grayscale, RGB or RGBA and 16-bit grayscale)")
    if interlace != 0:
        raise ValueError(f"{path}: unsupported PNG format: Adam7-interlaced {depth}-bit {name}")
    if compression != 0 or filt != 0:
        raise ValueError(f"{path}: unsupported PNG compression {compression} / filter method "
                         f"{filt}")
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected {h * (1 + w * bpp)}")
    rows = raw.reshape(h, 1 + w * bpp)
    kinds = rows[:, 0].astype(np.int64)
    if (kinds > 4).any():
        raise ValueError(f"{path}: unknown PNG row filter {int(kinds.max())}")
    px = _unfilter(rows[:, 1:].reshape(h, w, bpp), kinds)
    if depth == 16:
        return (px[..., 0].astype(np.uint16) << 8) | px[..., 1].astype(np.uint16)
    return px[..., 0] if channels == 1 else px


def _unfilter(filtered, kinds):
    """Reconstruct [H,W,bpp] bytes from their filtered values and the row
    filter types (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w, bpp = filtered.shape
    # the wavefront: S[d, r] holds pixel (r, x = d - r); one padding row and
    # column of zeros stand for the pixels left of and above the image
    r_idx = np.arange(h)[None, :]
    d_idx = np.arange(h + w - 1)[:, None]
    x_idx = d_idx - r_idx
    inside = (x_idx >= 0) & (x_idx < w)
    skew = np.zeros((h + w - 1, h, bpp), np.int16)
    skew[inside] = filtered[np.broadcast_to(r_idx, inside.shape)[inside], x_idx[inside]]
    S = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    kind = kinds[:, None]
    for d in range(h + w - 1):
        r0, r1 = max(0, d - w + 1), min(h, d + 1)
        a = S[d + 1, r0 + 1:r1 + 1]       # left: (r, x-1) on diagonal d-1
        b = S[d + 1, r0:r1]               # above: (r-1, x) on diagonal d-1
        c = S[d, r0:r1]                   # upper left: (r-1, x-1) on diagonal d-2
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(kind[r0:r1], (np.zeros_like(a), a, b, (a + b) >> 1, paeth))
        S[d + 2, r0 + 1:r1 + 1] = (skew[d, r0:r1] + pred) & 255
    rr, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return S[rr + xx + 2, rr + 1].astype(np.uint8)


def _luma(rgb):
    """Pillow's `convert("L")` of 8-bit RGB(A): ITU-R 601 in 16-bit fixed
    point, rounded (the alpha channel is dropped)."""
    v = rgb[..., :3].astype(np.uint32)
    return ((v[..., 0] * 19595 + v[..., 1] * 38470 + v[..., 2] * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def read(path: str):
    """The decoded pixels of the PNG file at `path` (see `decode`)."""
    with open(path, "rb") as f:
        return decode(f.read(), path)


def read_gray(path: str) -> np.ndarray:
    """[H,W] float32 gray levels: Pillow's `convert("L")` of the file (a
    16-bit grayscale file saturates at 255, as Pillow's does)."""
    px = read(path)
    if px.ndim == 3:
        return _luma(px).astype(np.float32)
    if px.dtype == np.uint16:
        return np.minimum(px, 255).astype(np.float32)
    return px.astype(np.float32)


def read_raw(path: str) -> np.ndarray:
    """[H,W] float32 raw values of a grayscale file (a 16-bit depth map's
    sensor units)."""
    px = read(path)
    if px.ndim == 3:
        raise ValueError(f"{path}: a raw read takes a grayscale PNG, not {px.shape[-1]} channels")
    return px.astype(np.float32)
