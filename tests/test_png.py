"""The zlib + numpy PNG codec (data/png.py): round trips, every scanline
filter type on read, and malformed input."""

import json
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

from tpuslam.data.png import decode_png, encode_png


def _depth(rng, h=9, w=13):
    d = rng.integers(0, 65536, size=(h, w)).astype(np.uint16)
    d[0, 0], d[-1, -1] = 0, 65535
    return d


def _rgb(rng, h=9, w=13):
    return rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _encode_with_filters(img, filters):
    """Reference encoder straight from the PNG spec: row y uses filter
    `filters[y % len(filters)]`."""
    if img.dtype == np.uint16:
        ctype, depth, raw = 0, 16, img.astype(">u2")
    else:
        ctype, depth, raw = 2, 8, img
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(raw).view(np.uint8).reshape(h, -1)
    bpp = rows.shape[1] // w
    out = bytearray()
    prev = [0] * rows.shape[1]
    for y in range(h):
        cur = [int(v) for v in rows[y]]
        ft = filters[y % len(filters)]
        line = []
        for i, x in enumerate(cur):
            a = cur[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[ft]
            line.append((x - pred) & 0xFF)
        out += bytes([ft]) + bytes(line)
        prev = cur

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("make", [_depth, _rgb], ids=["depth16", "rgb8"])
def test_round_trip(rng, make):
    img = make(rng)
    out = decode_png(encode_png(img))
    assert out.dtype == img.dtype and out.shape == img.shape
    np.testing.assert_array_equal(out, img)


@pytest.mark.parametrize("make", [_depth, _rgb], ids=["depth16", "rgb8"])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth",
                              "mixed"])
def test_reads_every_filter_type(rng, make, filters):
    img = make(rng)
    np.testing.assert_array_equal(
        decode_png(_encode_with_filters(img, filters)), img)


@pytest.mark.parametrize("damage", ["signature", "crc", "truncated",
                                    "zlib"])
def test_corrupt_input_raises(rng, damage):
    buf = bytearray(encode_png(_depth(rng)))
    idat = buf.index(b"IDAT")
    if damage == "signature":
        buf[1] = ord("Q")
    elif damage == "crc":
        buf[idat + 10] ^= 0xFF
    elif damage == "truncated":
        buf = buf[:idat + 12]
    else:
        # valid CRC over a payload that is not a zlib stream
        n = struct.unpack(">I", buf[idat - 4:idat])[0]
        junk = bytes(n)
        crc = struct.pack(">I", zlib.crc32(b"IDAT" + junk) & 0xFFFFFFFF)
        buf[idat + 4:idat + 8 + n] = junk + crc
    with pytest.raises(ValueError):
        decode_png(bytes(buf))


def test_rejects_unsupported_image():
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4), np.float32))


def test_cli_round_trip_without_opencv_or_pil(tmp_path):
    """make_synthetic → run_slam → eval with cv2 and PIL unimportable: the
    main path needs neither."""
    code = f"""
import json, sys
sys.modules["cv2"] = None
sys.modules["PIL"] = None
from tpuslam.cli import main
seq = {str(tmp_path / "seq")!r}
assert main(["make_synthetic", "--out", seq, "--frames", "8", "--rgb"]) == 0
assert main(["run_slam", "--sequence", seq, "--traj-out", seq + "/t.txt"]) == 0
assert main(["eval", "--trajectory", seq + "/t.txt",
             "--groundtruth", seq + "/groundtruth.txt"]) == 0
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[1])["frames"] == 8
    assert json.loads(lines[-1])["ate"]["rmse"] < 1e-3
