"""A small PNG codec on the standard library's zlib and numpy.

The sequence loaders and the viewers read and write images through it, on
every machine, so the port needs no imaging library.  It covers what the
loaders meet: gray (1 to 16 bits; 16 for depth maps), palette (1 to 8
bits), 8-bit gray+alpha, RGB and RGBA images; not interlaced images or
16-bit color.  `to_gray` converts to 8-bit luma as PIL's `convert("L")`
does: L = (19595 R + 38470 G + 7471 B + 2^15) >> 16, alpha ignored.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # color type -> samples a pixel


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters -> (h, stride) uint8."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:      # Sub: a running sum (mod 256) per byte lane
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:      # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            cur = _unfilter_row(ftype, line.tolist(), prev.tolist(), bpp)
        else:
            raise ValueError(f"PNG: unknown filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def _unfilter_row(ftype: int, line: list, up: list, bpp: int) -> np.ndarray:
    cur = [0] * len(line)
    for i, x in enumerate(line):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:
            cur[i] = (x + ((a + b) >> 1)) & 0xFF
            continue
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (x + pred) & 0xFF
    return np.asarray(cur, np.uint8)


def read_png(path: str) -> np.ndarray:
    """The image as stored: (H, W) or (H, W, C) uint8, (H, W) uint16 for
    16-bit gray; palette images come back as (H, W, 3) RGB."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, plte, hdr = 8, [], None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    depths = {0: (1, 2, 4, 8, 16), 3: (1, 2, 4, 8)}.get(ctype, (8,))
    if interlace or ctype not in _CHANNELS or depth not in depths:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, color type {ctype}, "
                         f"interlace {interlace})")
    ch = _CHANNELS[ctype]
    bpp = max(1, ch * depth // 8)
    px = _unfilter(zlib.decompress(b"".join(idat)), h, (w * ch * depth + 7) // 8, bpp)
    if depth == 16:
        return px.view(">u2").reshape(h, w).astype(np.uint16)
    if depth < 8:   # packed samples, most significant bits first
        bits = np.unpackbits(px, axis=1).reshape(h, -1, depth)[:, :w]
        px = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(-1, dtype=np.uint8)
        if ctype == 0:   # gray scaled to 8 bits, as PIL reads it
            px = px * np.uint8(255 // ((1 << depth) - 1))
    img = px.reshape(h, w, ch) if ch > 1 else px.reshape(h, w)
    if ctype == 3:
        if plte is None:
            raise ValueError(f"{path}: palette image without PLTE")
        img = plte[img]
    return img


def to_gray(img: np.ndarray) -> np.ndarray:
    """8-bit luma of an image from `read_png` (PIL's `convert("L")`)."""
    if img.dtype != np.uint8:
        raise ValueError(f"8-bit image expected, got {img.dtype}")
    if img.ndim == 2:
        return img
    if img.shape[2] == 2:            # gray + alpha
        return np.ascontiguousarray(img[..., 0])
    rgb = img[..., :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write (H, W) uint8 gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8, or
    (H, W) uint16 gray; every row with the Up filter (the first: None)."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, ctype, px = 16, 0, img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1)
    elif img.dtype == np.uint8 and (img.ndim == 2 or img.shape[2] in (3, 4)):
        depth, ctype = 8, 0 if img.ndim == 2 else {3: 2, 4: 6}[img.shape[2]]
        px = img.reshape(img.shape[0], -1)
    else:
        raise ValueError(f"cannot write a {img.dtype} image of shape {img.shape}")
    h, w = img.shape[:2]
    up = px.copy()
    up[1:] = px[1:] - px[:-1]                   # uint8 arithmetic wraps mod 256
    ftype = np.full((h, 1), 2, np.uint8)
    ftype[0] = 0
    raw = np.concatenate([ftype, up], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(_SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw, level)) + _chunk(b"IEND", b""))
