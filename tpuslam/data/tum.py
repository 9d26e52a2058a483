"""TUM RGB-D dataset loader (SURVEY.md §2a R1, §2b N1).

Reference status: C++/OpenCV reader of TUM sequences — `depth.txt` /
`rgb.txt` / `groundtruth.txt` association lists, 16-bit depth PNGs scaled by
5000, Freiburg intrinsics (SURVEY.md §2a R1; provenance [B:8-11] + [PK]).

Host-side by design: PNG decode and timestamp association never touch the
device; the loader yields fixed-shape float32 depth arrays ready for
upload.  Decode prefers the optional native C++ extension
(csrc/tum_decode.cc, libpng) when built, else the zlib + numpy codec in
data/png.py.  A background prefetch pool keeps the device fed (SURVEY.md §7
Stage 7: decode must not bottleneck 60 fps).
"""

from __future__ import annotations

import os
import warnings
from typing import Iterator, NamedTuple, Optional, Sequence

import numpy as np

from tpuslam.config import Intrinsics
from tpuslam.data.png import read_png

try:  # native decoder (csrc/tum_decode.cc), optional
    from tpuslam.data import _tum_native  # type: ignore
except Exception:  # pragma: no cover
    _tum_native = None


def _decode_depth_png_raw(path: str) -> np.ndarray:
    """16-bit PNG -> raw uint16 depth counts (no scaling)."""
    if _tum_native is not None:
        return _tum_native.decode_png16(path)
    raw = read_png(path)
    if raw.dtype != np.uint16 or raw.ndim != 2:
        raise ValueError(f"{path}: depth PNG must be 16-bit greyscale")
    return raw


def _decode_depth_png(path: str, depth_scale: float) -> np.ndarray:
    """16-bit PNG -> float32 metres."""
    return _decode_depth_png_raw(path).astype(np.float32) / depth_scale


def read_file_list(path: str) -> list[tuple[float, list[str]]]:
    """Parse a TUM-format list file: `timestamp data...`, '#' comments."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1:]))
    return out


def associate(
    a: Sequence[tuple[float, list[str]]],
    b: Sequence[tuple[float, list[str]]],
    max_difference: float = 0.02,
    offset: float = 0.0,
) -> list[tuple[int, int]]:
    """Greedy nearest-timestamp association (the standard TUM tool algorithm:
    sort candidate pairs by |Δt|, take greedily while both sides unused).

    Vectorized: instead of materializing all N·M pairs, only each `a` entry's
    few nearest `b` neighbors (by searchsorted) are candidates — identical
    result for physically-sensible streams where max_difference is far below
    the frame period times neighbor window.

    Uses the native C++ matcher (csrc/tum_decode.cc) when built.
    """
    if _tum_native is not None:
        ta_n = np.array([t for t, _ in a])
        tb_n = np.array([t + offset for t, _ in b])
        idx = _tum_native.associate_native(ta_n, tb_n, max_difference)
        return [(i, int(j)) for i, j in enumerate(idx) if j >= 0]
    ta = np.array([t for t, _ in a])
    tb = np.array([t + offset for t, _ in b])
    order = np.argsort(tb)
    tb_sorted = tb[order]
    pos = np.searchsorted(tb_sorted, ta)
    pairs = []
    for k in range(-2, 3):
        j_sorted = np.clip(pos + k, 0, len(tb_sorted) - 1)
        d = np.abs(ta - tb_sorted[j_sorted])
        ok = d < max_difference
        for i in np.nonzero(ok)[0]:
            pairs.append((float(d[i]), int(i), int(order[j_sorted[i]])))
    pairs = sorted(set(pairs))
    used_a: set[int] = set()
    used_b: set[int] = set()
    matches = []
    for _, i, j in pairs:
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            matches.append((i, j))
    matches.sort()
    return matches


def intrinsics_for_sequence(name: str) -> Intrinsics:
    low = name.lower()
    if "freiburg1" in low or "fr1" in low:
        return Intrinsics.tum_fr1()
    if "freiburg2" in low or "fr2" in low:
        return Intrinsics.tum_fr2()
    if "freiburg3" in low or "fr3" in low:
        return Intrinsics.tum_fr3()
    return Intrinsics.tum_default()


def read_intrinsics_file(path: str) -> Intrinsics:
    """Parse an `intrinsics.txt` (one line: fx fy cx cy; # comments).

    Real TUM downloads carry no calibration file (intrinsics are implied by
    the freiburg1/2/3 sequence name), but synthetic fixtures and non-TUM
    captures are not VGA-Freiburg-shaped — guessing tum_default() for a
    160×120 synthetic sequence silently corrupts the camera model (this was
    an 18× ATE regression on the CLI path before the file existed)."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            fx, fy, cx, cy = (float(v) for v in line.split()[:4])
            return Intrinsics(fx, fy, cx, cy)
    raise ValueError(f"no intrinsics line in {path}")


def _decode_rgb_png(path: str) -> np.ndarray:
    """8-bit color PNG -> (H, W, 3) uint8 RGB."""
    raw = read_png(path)
    if raw.dtype != np.uint8 or raw.ndim != 3:
        raise ValueError(f"{path}: colour PNG must be 8-bit RGB")
    return raw


class TumFrame(NamedTuple):
    timestamp: float
    depth: np.ndarray                # (H, W) float32 metres
    gt_pose: Optional[np.ndarray]    # (4, 4) float64 world←cam, or None
    rgb: Optional[np.ndarray] = None  # (H, W, 3) uint8, when load_rgb


def quaternion_to_matrix(qx, qy, qz, qw) -> np.ndarray:
    q = np.array([qx, qy, qz, qw], dtype=np.float64)
    q /= np.linalg.norm(q)
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def matrix_to_quaternion(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (qx, qy, qz, qw), w >= 0."""
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(R).as_quat()  # x, y, z, w
    return q if q[3] >= 0 else -q


class TumSequence:
    """A TUM RGB-D sequence directory: depth frames + optional groundtruth.

    `depth_cache=True` (default) enables the decode-once raw-depth sidecar:
    the first full iteration of a sequence writes the decoded float32 depth
    to `<root>/depth_cache.npy` (np.lib.format — memmap-able) and subsequent
    runs stream from it, bypassing PNG decode entirely (PNG decode is the
    host-side bottleneck of a streaming run).  The sidecar is invalidated by `depth.txt` mtime/size and by a
    depth-scale mismatch; an unwritable dataset directory silently disables
    caching.
    """

    def __init__(self, root: str, max_difference: float = 0.02,
                 load_rgb: bool = False, depth_cache: bool = True):
        self.root = root
        self.name = os.path.basename(os.path.normpath(root))
        calib = os.path.join(root, "intrinsics.txt")
        self.intrinsics = (read_intrinsics_file(calib)
                           if os.path.exists(calib)
                           else intrinsics_for_sequence(self.name))
        self.depth_list = read_file_list(os.path.join(root, "depth.txt"))
        gt_path = os.path.join(root, "groundtruth.txt")
        self.groundtruth = read_file_list(gt_path) if os.path.exists(gt_path) else None
        if self.groundtruth:
            self._gt_matches = dict(
                associate(self.depth_list, self.groundtruth, max_difference)
            )
        else:
            self._gt_matches = {}
        self.load_rgb = load_rgb
        rgb_path = os.path.join(root, "rgb.txt")
        if load_rgb and not os.path.exists(rgb_path):
            # Silently yielding rgb=None would mask a wrong --sequence path
            # or an un-extracted dataset; surface it instead.
            raise FileNotFoundError(
                f"load_rgb=True but {rgb_path} does not exist — wrong "
                "sequence directory, or the dataset was not extracted?")
        self.rgb_list = read_file_list(rgb_path) if load_rgb else None
        self._rgb_matches = (
            dict(associate(self.depth_list, self.rgb_list, max_difference))
            if self.rgb_list else {}
        )
        if load_rgb and not self._rgb_matches:
            warnings.warn(
                f"load_rgb=True but timestamp association between depth.txt "
                f"and rgb.txt produced zero matches in {root}", stacklevel=2)
        self.depth_cache = depth_cache
        self._cache_mm: Optional[np.ndarray] = None   # read-only memmap
        self._cache_scale: Optional[float] = None

    def __len__(self) -> int:
        return len(self.depth_list)

    def gt_pose(self, index: int) -> Optional[np.ndarray]:
        j = self._gt_matches.get(index)
        if j is None:
            return None
        vals = [float(v) for v in self.groundtruth[j][1]]
        tx, ty, tz, qx, qy, qz, qw = vals[:7]
        T = np.eye(4)
        T[:3, :3] = quaternion_to_matrix(qx, qy, qz, qw)
        T[:3, 3] = [tx, ty, tz]
        return T

    # ---- decode-once raw-depth sidecar (SURVEY.md §7 Stage 7) ----

    def _cache_paths(self) -> tuple[str, str]:
        return (os.path.join(self.root, "depth_cache.npy"),
                os.path.join(self.root, "depth_cache.json"))

    def _depth_txt_stamp(self) -> tuple[int, int]:
        st = os.stat(os.path.join(self.root, "depth.txt"))
        return int(st.st_mtime_ns), int(st.st_size)

    def _png_stamp(self) -> tuple[int, int]:
        """Aggregate (total size, max mtime_ns) over every depth PNG —
        depth.txt alone misses in-place PNG regeneration (same filenames),
        which would silently serve stale cached depths.  One os.stat per
        frame, ~µs each — noise next to a single PNG decode."""
        total, newest = 0, 0
        for _, (rel_path, *_rest) in self.depth_list:
            st = os.stat(os.path.join(self.root, rel_path))
            total += int(st.st_size)
            newest = max(newest, int(st.st_mtime_ns))
        return total, newest

    def _open_cache(self, depth_scale: float) -> Optional[np.ndarray]:
        """Return the read-only depth memmap when the sidecar is valid."""
        if not self.depth_cache:
            return None
        if self._cache_mm is not None and self._cache_scale == depth_scale:
            return self._cache_mm
        npy, meta_path = self._cache_paths()
        try:
            import json

            with open(meta_path) as f:
                meta = json.load(f)
            mtime_ns, size = self._depth_txt_stamp()
            if (meta["n_frames"] != len(self.depth_list)
                    or meta["depth_scale"] != depth_scale
                    or meta["depth_txt_mtime_ns"] != mtime_ns
                    or meta["depth_txt_size"] != size):
                return None
            png_total, png_newest = self._png_stamp()
            if (meta.get("png_total_size") != png_total
                    or meta.get("png_max_mtime_ns") != png_newest):
                return None
            mm = np.load(npy, mmap_mode="r")
            if mm.shape[0] != len(self.depth_list) or mm.dtype != np.float32:
                return None
        except (OSError, ValueError, KeyError):
            return None
        self._cache_mm = mm
        self._cache_scale = depth_scale
        return mm

    def _build_cache(self, depth_scale: float):
        """Start a sidecar build: returns (write_row, finalize) or None.

        The build writes decoded rows into a temporary memmap and only
        publishes (atomic rename + metadata) when EVERY frame was written —
        an abandoned iteration leaves no partial cache behind."""
        if not self.depth_cache or not os.access(self.root, os.W_OK):
            return None
        npy, meta_path = self._cache_paths()
        tmp = npy + ".tmp"
        n = len(self.depth_list)
        written = set()
        state = {"mm": None}    # created lazily on the first decoded row —
        #                         probing the shape up front would decode
        #                         frame 0 twice on every cache-building pass

        def write_row(i: int, depth: np.ndarray) -> None:
            mm = state["mm"]
            if mm is None:
                try:
                    mm = np.lib.format.open_memmap(
                        tmp, mode="w+", dtype=np.float32,
                        shape=(n,) + depth.shape)
                except OSError:
                    state["mm"] = False
                    return
                state["mm"] = mm
            elif mm is False:
                return
            if depth.shape == mm.shape[1:]:
                mm[i] = depth
                written.add(i)

        def finalize() -> None:
            mm = state["mm"]
            if not isinstance(mm, np.memmap):
                return
            mm.flush()
            if len(written) != n:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                return
            import json

            # The stamps re-stat depth.txt and every PNG: a file deleted
            # between decode and publish must abandon the cache, not raise
            # out of the frames() iteration the caller already finished.
            try:
                mtime_ns, size = self._depth_txt_stamp()
                png_total, png_newest = self._png_stamp()
                h, w = mm.shape[1:]
                os.replace(tmp, npy)     # atomic publish (same filesystem)
                with open(meta_path, "w") as f:
                    json.dump({"n_frames": n, "depth_scale": depth_scale,
                               "depth_txt_mtime_ns": mtime_ns,
                               "depth_txt_size": size,
                               "png_total_size": png_total,
                               "png_max_mtime_ns": png_newest,
                               "shape": [h, w]}, f)
            except OSError:
                for path in (tmp, npy, meta_path):
                    try:
                        os.remove(path)
                    except OSError:
                        pass

        return write_row, finalize

    def frame(self, index: int, depth_scale: float = 5000.0,
              raw: bool = False) -> TumFrame:
        """`raw=True` yields the depth as uint16 COUNTS (no ÷depth_scale):
        the bit-exact 2-byte/px upload format — the device divides by
        depth_scale in frontend.preprocess (CLI --upload-raw).  A cached
        f32 sidecar reconstructs the counts exactly: the ÷scale relative
        error is ~2⁻²⁴, far below the 0.5-count rounding threshold."""
        ts, (rel_path, *_) = self.depth_list[index]
        mm = self._open_cache(depth_scale)
        if mm is not None:
            depth = np.asarray(mm[index])
            if raw:
                depth = np.round(depth * depth_scale).astype(np.uint16)
        elif raw:
            depth = _decode_depth_png_raw(os.path.join(self.root, rel_path))
        else:
            depth = _decode_depth_png(
                os.path.join(self.root, rel_path), depth_scale)
        rgb = None
        j = self._rgb_matches.get(index)
        if j is not None:
            rgb = _decode_rgb_png(
                os.path.join(self.root, self.rgb_list[j][1][0]))
        return TumFrame(timestamp=ts, depth=depth, gt_pose=self.gt_pose(index),
                        rgb=rgb)

    def frames(self, depth_scale: float = 5000.0, start: int = 0,
               stop: Optional[int] = None, prefetch: int = 8,
               decode_threads: Optional[int] = None,
               raw: bool = False) -> Iterator[TumFrame]:
        """Iterate frames, decoding ahead on a thread pool (in order).

        PNG decode is the host-side bottleneck; both the native libpng path
        and the zlib + numpy codec spend most of their time in code that
        releases the GIL, so a small pool scales.  `prefetch` bounds the in-flight window
        (memory), `decode_threads` the parallelism (defaults to
        min(4, cpu_count), 1 ⇒ the old single-thread prefetch behavior).
        """
        from concurrent.futures import ThreadPoolExecutor

        stop = len(self) if stop is None else min(stop, len(self))
        if decode_threads is None:
            decode_threads = min(4, os.cpu_count() or 1)
        prefetch = max(prefetch, decode_threads)
        # first full pass over an uncached sequence builds the raw-depth
        # sidecar as a byproduct (one memcpy per frame; published atomically
        # only when the iteration completes)
        build = None
        if (not raw and start == 0 and stop == len(self)
                and self._open_cache(depth_scale) is None):
            build = self._build_cache(depth_scale)
        with ThreadPoolExecutor(max_workers=max(1, decode_threads)) as ex:
            from collections import deque

            pending: "deque" = deque()
            idx = start
            out_idx = start
            try:
                while idx < stop or pending:
                    while idx < stop and len(pending) < prefetch:
                        pending.append(ex.submit(self.frame, idx, depth_scale,
                                                 raw))
                        idx += 1
                    f = pending.popleft().result()
                    if build is not None:
                        build[0](out_idx, f.depth)
                    out_idx += 1
                    yield f
            finally:
                if build is not None:
                    build[1]()


def write_trajectory(path: str, timestamps: Sequence[float],
                     poses: np.ndarray) -> None:
    """Write TUM-format trajectory: `t tx ty tz qx qy qz qw` per line."""
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for ts, T in zip(timestamps, np.asarray(poses)):
            t = T[:3, 3]
            q = matrix_to_quaternion(T[:3, :3])
            f.write(
                f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )


def read_trajectory(path: str):
    """Read TUM-format trajectory -> (timestamps (F,), poses (F, 4, 4))."""
    rows = read_file_list(path)
    ts = np.array([r[0] for r in rows])
    poses = np.zeros((len(rows), 4, 4))
    for i, (_, vals) in enumerate(rows):
        tx, ty, tz, qx, qy, qz, qw = [float(v) for v in vals[:7]]
        poses[i] = np.eye(4)
        poses[i, :3, :3] = quaternion_to_matrix(qx, qy, qz, qw)
        poses[i, :3, 3] = [tx, ty, tz]
    return ts, poses
