"""Cold-start / compile-cache-load profiling (VERDICT r4 #7).

Even with the persistent compilation cache warm, a fresh process pays a
start-up cost before its first useful frame.  `fps_steady` keeps that out
of throughput reports; this harness measures, per flagship program, where
the time goes —

  * trace+lower  — Python tracing to StableHLO.  NEVER cached: every
    process re-pays it (jaxpr tracing has no persistent cache).
  * compile      — `lowered.compile()`.  On a cache hit this is
    deserialization + backend load of the stored executable; on a miss,
    full XLA compilation.
  * first run    — first execution (device warmup, final transfers).

Run it twice back-to-back (same cache) from fresh processes to separate
miss from hit costs; `python -m tpuslam.cli bench --coldstart` prints one
JSON object.
"""

from __future__ import annotations

import json
import os
import time


def profile_coldstart(frames: int = 32, height: int = 480,
                      width: int = 640) -> dict:
    out: dict = {"phases": {}}
    t00 = time.perf_counter()

    t0 = time.perf_counter()
    import jax
    import jax.numpy as jnp

    import numpy as np

    out["phases"]["import_jax"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    from tpuslam.config import SLAMConfig
    from tpuslam.bench.harness import _render_sequence

    out["phases"]["import_tpuslam"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    dev = jax.devices()[0]
    out["phases"]["backend_init"] = time.perf_counter() - t0
    out["device"] = str(dev)

    cfg = SLAMConfig(height=height, width=width)
    K, _poses, depths_np = _render_sequence(frames, height, width)
    t0 = time.perf_counter()
    depths = jnp.asarray(depths_np)
    jax.block_until_ready(depths)
    out["phases"]["upload_inputs"] = time.perf_counter() - t0

    cache_dir = jax.config.jax_compilation_cache_dir
    out["cache_dir"] = cache_dir
    if cache_dir and os.path.isdir(cache_dir):
        entries = os.listdir(cache_dir)
        out["cache_entries"] = len(entries)
        out["cache_bytes"] = sum(
            os.path.getsize(os.path.join(cache_dir, e)) for e in entries)

    from tpuslam.frontend import (
        SuperChunkCarry,
        pack_pyramid_jit,
        preprocess_jit,
        process_frame_jit,
        scan_superchunk_frozen_jit,
        scan_odometry_jit,
    )

    # Build the non-traced prerequisites for each program's example args.
    pyr0 = preprocess_jit(depths[0], K, cfg)        # compiles preprocess
    kf_packed = pack_pyramid_jit(pyr0, cfg)
    jax.block_until_ready(kf_packed)
    eye = jnp.eye(4)
    carry = SuperChunkCarry(kf_packed=kf_packed, T_kf_cam=eye,
                            last_delta=eye)

    programs = {
        "preprocess": (preprocess_jit, (depths[0], K, cfg)),
        "process_frame": (process_frame_jit,
                          (depths[0], kf_packed, K, eye, eye, cfg)),
        "scan_superchunk_c8": (scan_superchunk_frozen_jit,
                               (depths[:8], K, carry, cfg, 8)),
        f"scan_odometry_f{frames}": (scan_odometry_jit, (depths, K, cfg)),
    }
    out["programs"] = {}
    for name, (fn, args) in programs.items():
        rec = {}
        t0 = time.perf_counter()
        lowered = fn.lower(*args)
        rec["trace_lower_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        compiled = lowered.compile()
        rec["compile_or_load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # static args (the config, the superchunk's `sub` int) are baked
        # into the compiled executable — only pass the traced operands
        r = compiled(*(a for a in args
                       if not isinstance(a, (SLAMConfig, int))))
        jax.block_until_ready(r)
        rec["first_run_s"] = time.perf_counter() - t0
        out["programs"][name] = {k: round(v, 3) for k, v in rec.items()}

    out["total_s"] = round(time.perf_counter() - t00, 3)
    out["phases"] = {k: round(v, 3) for k, v in out["phases"].items()}
    return out


def main() -> int:
    print(json.dumps(profile_coldstart()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
