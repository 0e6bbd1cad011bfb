"""PNG decoding and encoding in numpy (zlib and the five row filters), for
machines without OpenCV.

Reads non-interlaced 8-bit grey, RGB and RGBA and 16-bit grey images: the
depth maps of ScanNet and 7-Scenes (16-bit grey, millimetres), 7-Scenes
colour (8-bit RGB) and what `encode` writes. Any other PNG raises a
ValueError that names the file. `encode` writes the same formats with row
filter 0 (None).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (bit depth, colour type) -> samples per pixel
_FORMATS = {(8, 0): 1, (8, 2): 3, (8, 6): 4, (16, 0): 1}
_COLOUR_TYPE = {1: 0, 3: 2, 4: 6}  # samples per pixel -> colour type


def is_png(data: bytes) -> bool:
    return data[:8] == SIGNATURE


def _chunks(data: bytes, name: str):
    """(type, body) of each chunk up to IEND, CRCs checked."""
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{name}: truncated PNG")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{name}: bad CRC in PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: PNG ends without an IEND chunk")


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> [H, W] (grey) or [H, W, C] (RGB, RGBA) array, uint8 or
    uint16, channels in the file's order."""
    if not is_png(data):
        raise ValueError(f"{name}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: PNG without an IHDR chunk")
    w, h, depth, ctype, method, filtering, interlace = header
    samples = _FORMATS.get((depth, ctype))
    if samples is None or method or filtering or interlace:
        raise ValueError(
            f"{name}: unsupported PNG (bit depth {depth}, colour type "
            f"{ctype}, interlace {interlace}); only non-interlaced 8-bit "
            f"grey, RGB, RGBA and 16-bit grey are read")
    bpp = samples * depth // 8  # bytes per pixel
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"{name}: PNG image data has {raw.size} bytes, "
                         f"expected {h * (w * bpp + 1)}")
    rows = raw.reshape(h, w * bpp + 1)
    types = rows[:, 0]
    if (types > 4).any():
        raise ValueError(f"{name}: unknown PNG row filter {types.max()}")
    pixels = _unfilter(types, rows[:, 1:].reshape(h, w, bpp))
    if depth == 16:
        return pixels.reshape(h, w * 2).view(">u2").astype(np.uint16)
    return pixels[..., 0] if samples == 1 else pixels


def _unfilter(types: np.ndarray, filtered: np.ndarray) -> np.ndarray:
    """Undo the row filters: filtered [H, W, bpp] bytes -> pixel bytes."""
    if (types <= 2).all():
        # None, Sub and Up only: whole rows at a time
        out = np.empty_like(filtered)
        prev = np.zeros_like(filtered[0])
        for r, kind in enumerate(types):
            row = filtered[r]
            if kind == 1:  # Sub: running sum along the row, modulo 256
                row = np.cumsum(row, axis=0, dtype=np.uint8)
            elif kind == 2:  # Up
                row = row + prev
            out[r] = row
            prev = out[r]
        return out
    return _unfilter_diagonals(types, filtered)


def _unfilter_diagonals(types: np.ndarray, filtered: np.ndarray):
    """Every filter type. Pixel (r, x) depends on (r, x-1), (r-1, x) and
    (r-1, x-1) only, so the pixels of one anti-diagonal r + x = d are
    reconstructed together, H + W - 1 steps for the image."""
    h, w, bpp = filtered.shape
    n = h + w - 1
    rows = np.arange(h)[:, None]
    x = np.arange(n)[None] - rows  # column of diagonal d's pixel in row r
    inside = (x >= 0) & (x < w)
    # diagonal-major copies: raw[d, r] is pixel (r, d - r), 0 off the image
    raw = np.where(inside[..., None], filtered[rows, np.clip(x, 0, w - 1)],
                   0).astype(np.int16).transpose(1, 0, 2).copy()
    inside = inside.T[..., None].astype(np.int16)
    # skew[d + 2, r + 1] holds pixel (r, d - r); the first two diagonals,
    # row 0 and the cells left of the image stay 0 (PNG's outside value)
    skew = np.zeros((n + 2, h + 1, bpp), np.int16)
    sub, up, avg, paeth = ((types[:, None] == t).astype(np.int16)
                           for t in (1, 2, 3, 4))
    for d in range(n):
        a, b, c = skew[d + 1, 1:], skew[d + 1, :-1], skew[d, :-1]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        nearest = np.where((pa <= pb) & (pa <= pc), a,
                           np.where(pb <= pc, b, c))
        pred = sub * a + up * b + avg * ((a + b) >> 1) + paeth * nearest
        skew[d + 2, 1:] = ((raw[d] + pred) & 0xFF) * inside[d]
    r = np.arange(h)[:, None]
    return skew[r + np.arange(w)[None] + 2, r + 1].astype(np.uint8)


def encode(img: np.ndarray) -> bytes:
    """[H, W] uint8 or uint16, or [H, W, 3 | 4] uint8 -> PNG bytes, at
    cv2.imwrite's default zlib level 1 (the fastest)."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, ctype, data = 16, 0, img.astype(">u2")
    elif img.dtype == np.uint8 and (img.ndim == 2 or (
            img.ndim == 3 and img.shape[2] in _COLOUR_TYPE)):
        depth, data = 8, img
        ctype = _COLOUR_TYPE[1 if img.ndim == 2 else img.shape[2]]
    else:
        raise ValueError(f"cannot write a PNG of {img.dtype} {img.shape}: "
                         f"takes [H, W] uint8/uint16 or [H, W, 3|4] uint8")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(data).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                         0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + chunk(b"IEND", b""))


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read(), path)


def write(path: str, img: np.ndarray) -> None:
    data = encode(img)
    with open(path, "wb") as f:
        f.write(data)
