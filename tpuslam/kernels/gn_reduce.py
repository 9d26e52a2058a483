"""Fused point-to-plane Gauss-Newton reduction (SURVEY.md §2a R7, §2b N8).

Reference status: per-point residual + Huber weight + 6x6 JJᵀ accumulation
loop in C++ (SURVEY.md §2a R7; BASELINE.json north-star: "fuse the
weighted-least-squares reduction into a single pass").

Math: residual rᵢ = nᵢ·(xᵢ − qᵢ) with xᵢ the transformed source point;
Jacobian of rᵢ w.r.t. a *left* twist δ = (ρ, φ) at δ=0 is
Jᵢ = [nᵢ, xᵢ×nᵢ] ∈ R⁶ (see tpuslam/geom/se3.py convention).  Huber weight
wᵢ = 1 for |r| ≤ δ_h else δ_h/|r|, times the {0,1} correspondence validity.
Output: H = Σ wᵢ Jᵢ Jᵢᵀ (6×6), b = Σ wᵢ rᵢ Jᵢ (6,), plus inlier count and
weighted squared-residual sum for convergence/quality stats.

`gn_reduce` is the jnp implementation (the (N,6)ᵀ(N,6) product of the
weighted Jacobian).  `kernels/gn_triton.py` is the GPU kernel for the same
reduce; this function and `solve_gn_step` are its test oracles (SURVEY.md
§4) and the path on every other platform.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class GNStats(NamedTuple):
    H: jnp.ndarray          # (6, 6)
    b: jnp.ndarray          # (6,)
    num_inliers: jnp.ndarray    # () float — Σ validity
    weighted_sq_sum: jnp.ndarray  # () float — Σ w·r²
    num_valid_src: jnp.ndarray    # () float — Σ source mask (for inlier frac)


def huber_weight(r: jnp.ndarray, delta: float) -> jnp.ndarray:
    """IRLS weight of the Huber loss: min(1, δ/|r|)."""
    ar = jnp.abs(r)
    return jnp.where(ar <= delta, 1.0, delta / jnp.maximum(ar, 1e-12))


def gn_reduce(
    x: jnp.ndarray,
    q: jnp.ndarray,
    n: jnp.ndarray,
    w_valid: jnp.ndarray,
    src_mask: jnp.ndarray,
    huber_delta: float,
) -> GNStats:
    """Pure-jnp fused reduction (oracle, and the path off the GPU).

    Args:
      x: (N, 3) source points in target frame (already transformed).
      q: (N, 3) matched target points.
      n: (N, 3) matched target normals.
      w_valid: (N,) {0,1} correspondence validity.
      src_mask: (N,) source-point validity (for inlier-fraction stats).
      huber_delta: Huber knee (metres).
    """
    r = jnp.sum(n * (x - q), axis=-1)
    w = w_valid * huber_weight(r, huber_delta)
    J = jnp.concatenate([n, jnp.cross(x, n)], axis=-1)  # (N, 6)
    wJ = J * w[:, None]
    H = jnp.einsum("ni,nj->ij", wJ, J, precision="highest")
    b = jnp.einsum("ni,n->i", wJ, r, precision="highest")
    return GNStats(
        H=H,
        b=b,
        num_inliers=jnp.sum(w_valid),
        weighted_sq_sum=jnp.sum(w * r * r),
        num_valid_src=jnp.sum(src_mask.astype(x.dtype)),
    )


def solve_gn_step(H: jnp.ndarray, b: jnp.ndarray, damping: float,
                  damping_abs: float = 1e-3,
                  max_trans_step: float = 0.3,
                  max_rot_step: float = 0.3) -> jnp.ndarray:
    """Damped 6×6 solve with trust-region clamp; safe on rank-deficient H.

    Two dampings: multiplicative λ·diag(H) (classic Levenberg) and an
    absolute λ_abs·(tr(H)/6)·I that pins *near-unobservable* directions —
    e.g. roll when a fronto-parallel plane dominates the view, where
    diag(H) itself is tiny along the null mode and multiplicative damping
    does nothing (a single undamped GN step can launch radians along it).
    The per-step clamp bounds translation/rotation magnitude so one bad
    linearization can never jump out of the convergence basin.
    """
    diag = jnp.diagonal(H)
    lam_abs = damping_abs * (jnp.sum(diag) / 6.0) + 1e-9
    Hd = H + jnp.diag(damping * diag) + lam_abs * jnp.eye(6, dtype=H.dtype)
    delta = jnp.linalg.solve(Hd, -b)
    ok = jnp.all(jnp.isfinite(delta))
    delta = jnp.where(ok, delta, jnp.zeros_like(delta))
    # trust region: scale the whole twist so neither part exceeds its cap
    t_norm = jnp.linalg.norm(delta[:3])
    r_norm = jnp.linalg.norm(delta[3:])
    scale = jnp.minimum(
        1.0,
        jnp.minimum(
            max_trans_step / jnp.maximum(t_norm, 1e-12),
            max_rot_step / jnp.maximum(r_norm, 1e-12),
        ),
    )
    return delta * scale
