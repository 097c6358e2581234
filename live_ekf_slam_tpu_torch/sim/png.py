"""PNG decoding and Pillow's bilinear reduce, in numpy: the image path of the
occupancy-map ingest without Pillow.

``read_png`` decodes the PNGs the map assets use: 8-bit, non-interlaced,
RGB or RGBA, any of the five row filters (PNG spec, section 9). Every other
format raises, naming it. ``resize_bilinear`` is Pillow's ``Image.resize(
(w, h), Image.BILINEAR)`` on a uint8 RGB array, bit for bit: per axis a
triangle filter whose support is scaled by in/out, coefficients normalised
and then turned into 22-bit fixed point (round half away from zero), the
horizontal pass first and stored as uint8, then the vertical pass; each pass
adds 1 << 21, shifts right by 22 and clips to 0-255 (Pillow's
``libImaging/Resample.c``).
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}  # PNG colour type -> channels: RGB, RGBA
_COLOR_NAMES = {0: "grayscale", 2: "RGB", 3: "palette", 4: "grayscale+alpha",
                6: "RGBA"}

PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed point for 8-bit images


def _unfilter_row(ftype: int, raw: np.ndarray, prior: np.ndarray,
                  bpp: int) -> np.ndarray:
    """One reconstructed scanline (uint8) from its filtered bytes."""
    if ftype == 0:
        return raw
    if ftype == 1:  # Sub: a running sum per channel, mod 256
        return np.cumsum(raw.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    if ftype == 2:  # Up
        return raw + prior
    if ftype not in (3, 4):
        raise ValueError(f"PNG: unknown row filter {ftype}")
    # Average and Paeth depend on the byte reconstructed just before
    out = bytearray(len(raw))
    rb, pb = raw.tobytes(), prior.tobytes()
    for i in range(len(rb)):
        a = out[i - bpp] if i >= bpp else 0
        b = pb[i]
        if ftype == 3:
            pred = (a + b) >> 1
        else:
            c = pb[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pbb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pbb and pa <= pc else (b if pbb <= pc else c)
        out[i] = (rb[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path) -> np.ndarray:
    """(H, W, C) uint8 pixels of an 8-bit, non-interlaced RGB (C = 3) or RGBA
    (C = 4) PNG, as ``np.asarray(PIL.Image.open(path))`` gives them."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(
            f"{path}: unsupported PNG format ({depth}-bit "
            f"{_COLOR_NAMES.get(color, f'colour type {color}')}"
            f"{', interlaced' if interlace else ''}); only 8-bit "
            "non-interlaced RGB and RGBA are read")
    bpp = _CHANNELS[color]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: PNG image data has {raw.size} bytes, "
                         f"expected {height * (stride + 1)}")
    rows = raw.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        prior = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prior, bpp)
    return out.reshape(height, width, bpp)


def _coeffs(in_size: int, out_size: int):
    """(first input index (out,), fixed-point weights (out, ksize)) of one
    axis: Pillow's ``precompute_coeffs`` with the bilinear filter, then
    ``normalize_coeffs_8bpc``."""
    scale = filterscale = in_size / out_size
    filterscale = max(filterscale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k, ww = [], 0.0
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * ss)
            k.append(1.0 - t if t < 1.0 else 0.0)
            ww += k[-1]  # in index order, as the C loop adds (not sum())
        if ww != 0.0:
            k = [w / ww for w in k]
        first[xx] = xmin
        kk[xx, :xmax] = [int(-0.5 + w * (1 << PRECISION_BITS)) if w < 0
                         else int(0.5 + w * (1 << PRECISION_BITS)) for w in k]
    return first, kk


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit resampling pass of (H, W, C) uint8 along ``axis``."""
    in_size = img.shape[axis]
    first, kk = _coeffs(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int64)
    extra = (None,) * (src.ndim - 1)
    for tap in range(kk.shape[1]):
        idx = np.minimum(first + tap, in_size - 1)  # zero weight past xmax
        acc += src[idx] * kk[(slice(None), tap) + extra]
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """(height, width, C) uint8: ``Image.fromarray(img).resize((width,
    height), Image.BILINEAR)`` of an (H, W, C) uint8 RGB array, as Pillow
    computes it (an axis of unchanged size is not resampled)."""
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError("resize_bilinear takes an (H, W, C) uint8 array")
    out = img
    if width != img.shape[1]:
        out = _pass(out, width, 1)
    if height != img.shape[0]:
        out = _pass(out, height, 0)
    return np.ascontiguousarray(out)
