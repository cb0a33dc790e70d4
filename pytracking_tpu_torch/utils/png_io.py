"""Indexed PNG files of segmentation masks, DAVIS / YouTube-VOS style
(counterpart of pytracking_tpu/utils/png_io.py, which goes through PIL).

Written with the standard library alone (zlib, struct), so that the harness
saves and reads masks on a machine without PIL: one IHDR, PLTE and IDAT
chunk, 8 bits per pixel, palette colour type, no filtering. PIL reads
it to the same array and palette (its own encoder, which feeds zlib row by
row, may compress the same rows to other bytes). The reader takes any
non-interlaced PNG of 1-16 bits per sample (all five row filters) and
returns the first channel, as the JAX package's reader does.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# the DAVIS palette's first entries; the rest black
_PALETTE = np.concatenate([
    np.array([[0, 0, 0], [128, 0, 0], [0, 128, 0], [128, 128, 0], [0, 0, 128],
              [128, 0, 128], [0, 128, 128], [128, 128, 128]], np.uint8),
    np.zeros((248, 3), np.uint8)])

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}      # colour type -> samples per pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def imwrite_indexed(filename: str, array: np.ndarray, color_palette=None):
    """Save a (H, W) label map as an 8-bit palette PNG."""
    im = np.ascontiguousarray(np.asarray(array, np.uint8))
    if im.ndim != 2:
        raise ValueError(f"imwrite_indexed takes a (H, W) array, got {im.shape}")
    palette = np.asarray(_PALETTE if color_palette is None else color_palette, np.uint8)
    H, W = im.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8), im], axis=1)   # filter 0 per row
    with open(filename, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 3, 0, 0, 0)))
        f.write(_chunk(b"PLTE", palette.reshape(-1)[:768].tobytes()))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes())))
        f.write(_chunk(b"IEND", b""))


def _read_chunks(filename: str):
    with open(filename, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{filename} is not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    return header, palette, b"".join(idat)


def _unfilter(raw: np.ndarray, H: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: (H, stride) bytes."""
    out = np.zeros((H, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(H):
        kind = raw[y, 0]
        line = raw[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 2:
            cur = (line + prev) & 0xFF
        else:
            cur = line.copy()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) >> 1
                elif kind == 4:
                    c = prev[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                else:
                    raise ValueError(f"unknown PNG row filter {kind}")
                cur[x] = (cur[x] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out


def read_png(filename: str):
    """(H, W, C) samples (uint8, or uint16 at 16 bits) and the palette
    ((N, 3) uint8 or None) of a non-interlaced PNG."""
    header, palette, idat = _read_chunks(filename)
    W, H, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError(f"{filename}: interlaced PNGs are not supported")
    C = _CHANNELS[ctype]
    bits = depth * C * W
    stride = (bits + 7) // 8
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)[:H * (stride + 1)]
    rows = _unfilter(raw.reshape(H, stride + 1), H, stride, max(1, depth * C // 8))
    if depth == 16:
        samples = rows.view(">u2").astype(np.uint16).reshape(H, W, C)
    elif depth == 8:
        samples = rows.reshape(H, W, C)
    else:
        samples = np.unpackbits(rows, axis=1)[:, :W * depth].reshape(H, W, depth)
        samples = (samples * (1 << np.arange(depth - 1, -1, -1))).sum(-1).astype(np.uint8)
        samples = samples[..., None]
    return samples, palette


def imread_indexed(filename: str) -> np.ndarray:
    """The (H, W) label map of a segmentation PNG (its first channel)."""
    return read_png(filename)[0][..., 0]
