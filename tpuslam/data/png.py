"""PNG codec for TUM frames with nothing but `zlib` and numpy.

Reads and writes the two formats a TUM RGB-D sequence holds: 16-bit
greyscale depth (colour type 0) and 8-bit RGB colour (colour type 2),
non-interlaced.  The reader undoes all five scanline filters (PNG spec
§9.2); the writer uses filter Up on every row, so reading what it wrote
takes one vectorised cumulative sum.  Malformed input — a bad signature,
a chunk CRC mismatch, a truncated or undecompressable stream — raises
`ValueError`.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
# (colour type, bit depth) -> (channels, numpy dtype)
_FORMATS = {(0, 16): (1, ">u2"), (2, 8): (3, "u1")}


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W) uint16 depth or (H, W, 3) uint8 RGB -> PNG bytes."""
    if img.dtype == np.uint16 and img.ndim == 2:
        ctype, depth = 0, 16
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        ctype, depth = 2, 8
    else:
        raise ValueError(f"unsupported PNG image: {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    _, dt = _FORMATS[(ctype, depth)]
    raw = np.ascontiguousarray(img.astype(dt)).view(np.uint8).reshape(h, -1)
    filt = np.empty((h, raw.shape[1] + 1), np.uint8)
    filt[:, 0] = 2                                  # filter Up on every row
    filt[0, 1:] = raw[0]
    filt[1:, 1:] = raw[1:] - raw[:-1]               # wraps mod 256
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(filt.tobytes(), level))
            + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(filt: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters of an (H, 1 + rowbytes) scanline array."""
    types = filt[:, 0]
    data = filt[:, 1:]
    if np.all(types == 2):
        return np.cumsum(data, axis=0, dtype=np.uint8)
    if types.max() > 4:
        raise ValueError(f"invalid PNG filter type {int(types.max())}")
    out = np.empty_like(data)
    prev = np.zeros(data.shape[1], np.uint8)
    for y, ft in enumerate(types):
        row = data[y]
        if ft == 0:
            cur = row.copy()
        elif ft == 1:
            cur = np.cumsum(row.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ft == 2:
            cur = row + prev
        else:
            # Average (3) and Paeth (4) depend on the reconstructed byte
            # to the left, so they run byte by byte.
            cur = bytearray(row.tobytes())
            up = prev.tobytes()
            for i in range(len(cur)):
                a = cur[i - bpp] if i >= bpp else 0
                if ft == 3:
                    pred = (a + up[i]) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    pred = _paeth(a, up[i], c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        out[y] = cur
        prev = out[y]
    return out


def decode_png(buf: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) uint16 or (H, W, 3) uint8."""
    if buf[:8] != _SIG:
        raise ValueError("not a PNG file (bad signature)")
    pos, header, idat = 8, None, []
    while True:
        if pos + 8 > len(buf):
            raise ValueError("truncated PNG (no IEND chunk)")
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        kind = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + n]
        crc = buf[pos + 8 + n:pos + 12 + n]
        if len(data) != n or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {kind!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + data) & 0xFFFFFFFF:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if (ctype, depth) not in _FORMATS or interlace:
        raise ValueError(f"unsupported PNG format: colour type {ctype}, "
                         f"bit depth {depth}, interlace {interlace}")
    ch, dt = _FORMATS[(ctype, depth)]
    bpp = ch * depth // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from None
    if len(raw) != h * (1 + w * bpp):
        raise ValueError(f"PNG image data has {len(raw)} bytes, expected "
                         f"{h * (1 + w * bpp)}")
    rows = _unfilter(np.frombuffer(raw, np.uint8).reshape(h, -1), bpp)
    img = rows.view(dt).reshape((h, w, ch) if ch > 1 else (h, w))
    return img.astype(dt[-2:])


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
