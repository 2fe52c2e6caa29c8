"""A numpy + zlib PNG codec for the dataset contract's images (counterpart
of the PIL calls `Image.open` / `Image.fromarray(...).save` in
`autoposeestimation_tpu/utils/io.py`), so that the port reads and writes
datasets where PIL is not installed.

Reads non-interlaced 8-bit grayscale (labels), 16-bit big-endian grayscale
(depth), 8-bit RGB (colour) and 8-bit RGBA, with all five row filters
(PIL's encoder picks a filter per row: None, Sub, Up or Paeth). Writes the
first three with filter 0 (None) on every row.

Filter reconstruction: rows filtered with None, Sub or Up are undone one row
at a time with whole-row numpy operations. Average and Paeth depend on the
reconstructed pixel to the left as well as on the row above, so an image
holding any such row is reconstructed along anti-diagonals instead: every
pixel (r, c) with r + c = d depends only on diagonals d - 1 and d - 2, so
each of the H + W - 1 steps is one vectorized operation over a diagonal.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def _unfilter_rows(raw: np.ndarray, ftype: np.ndarray, bpp: int
                   ) -> np.ndarray:
    """Rows of None/Sub/Up filters, (H, stride) uint8 -> (H, stride)."""
    h, stride = raw.shape
    out = np.empty_like(raw)
    prior = np.zeros(stride, np.uint8)
    for r in range(h):
        x = raw[r]
        if ftype[r] == 0:
            row = x
        elif ftype[r] == 1:
            row = np.cumsum(x.reshape(-1, bpp), axis=0, dtype=np.uint8
                            ).reshape(-1)
        elif ftype[r] == 2:
            row = x + prior
        else:
            raise ValueError(f"row filter {ftype[r]} in the row path")
        out[r] = row
        prior = row
    return out


def _unfilter_diagonals(raw: np.ndarray, ftype: np.ndarray, bpp: int
                        ) -> np.ndarray:
    """Any mix of the five filters, (H, stride) uint8 -> (H, stride)."""
    h, stride = raw.shape
    w = stride // bpp
    x = raw.reshape(h, w, bpp).astype(np.int16)
    # one zero row above and one zero pixel to the left
    rec = np.zeros((h + 1, w + 1, bpp), np.int16)
    ft = ftype.astype(np.int16)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        c = d - r
        a = rec[r + 1, c]            # left
        b = rec[r, c + 1]            # above
        ul = rec[r, c]               # above left
        p_a = np.abs(b - ul)
        p_b = np.abs(a - ul)
        p_c = np.abs(a + b - 2 * ul)
        paeth = np.where((p_a <= p_b) & (p_a <= p_c), a,
                         np.where(p_b <= p_c, b, ul))
        f = ft[r][:, None]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, paeth, 0))))
        rec[r + 1, c + 1] = (x[r, c] + pred) & 255
    return rec[1:, 1:].astype(np.uint8).reshape(h, stride)


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) uint8 / uint16 or (H, W, C) uint8."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or interlace != 0 or depth not in (8, 16) \
            or (depth == 16 and ctype != 0):
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}")
    channels = _CHANNELS[ctype]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    raw = raw.reshape(height, stride + 1)
    ftype, rows = raw[:, 0], raw[:, 1:]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"unknown PNG row filter {ftype.max()}")
    if (ftype >= 3).any():
        pix = _unfilter_diagonals(rows, ftype, bpp)
    else:
        pix = _unfilter_rows(rows, ftype, bpp)
    if depth == 16:
        return pix.view(">u2").reshape(height, width).astype(np.uint16)
    if channels == 1:
        return pix.reshape(height, width)
    return pix.reshape(height, width, channels)


def encode(array: np.ndarray) -> bytes:
    """(H, W) uint8 / uint16 or (H, W, 3) uint8 -> PNG bytes (filter 0)."""
    array = np.asarray(array)
    if array.ndim == 2 and array.dtype == np.uint8:
        depth, ctype = 8, 0
    elif array.ndim == 2 and array.dtype == np.uint16:
        depth, ctype = 16, 0
        array = array.astype(">u2")
    elif array.ndim == 3 and array.dtype == np.uint8 and array.shape[2] == 3:
        depth, ctype = 8, 2
    else:
        raise ValueError(f"cannot write {array.dtype} {array.shape} as PNG")
    h, w = array.shape[:2]
    rows = np.ascontiguousarray(array).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xffffffff))

    return (_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + chunk(b"IEND", b""))


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode(data)
    except ValueError as exc:
        raise ValueError(f"{path}: {exc}") from exc


def write(path: str, array: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode(array))
