"""Point-to-plane GN reduce and GN-step epilogue as Pallas kernels on the
Triton route (`backend="triton"`) — the ICP GN step on the GPU
(icp.gn_step selects them on CUDA; every other platform runs the plain
`gn_reduce` → `solve_gn_step` → `se3.exp` chain they are tested against).

  * `gn_partials` — the GN reduce.  Each program loads a 1-D block of
    points in place from the (N, 3) arrays (masked; no padding copies) and
    writes one (32,) row of partial sums: 21 upper-triangular H entries,
    6 b entries, Σw·r², Σvalid.  XLA's form of the same reduce is an
    (N, 6)ᵀ(N, 6) GEMM with a materialised w·J and a split-K pass.
  * `gn_epilogue` — fold of those rows, damped 6×6 solve, trust-region
    clamp, SE(3) exp and the left compose, in one program.  XLA's form is
    an LU factorisation, two triangular solves, pivot bookkeeping and a
    dozen small fusions, each its own launch.  `epilogue_math` is the same
    ops as plain jnp.

Triton wants every tensor a power of two in size, and Pallas lowers
concatenation only in a narrow form, so the epilogue works on (8, 8),
(4, 4) and (32,) tiles built from iota masks: the 6×6 system sits in the
top-left of an (8, 8) tile whose column 6 holds −b.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

NUM_SUMS = 32           # 21 H + 6 b + Σwr² + Σvalid, padded to 2^5
_B0 = 21
_WSQ, _NINL = 27, 28
_SINC_SERIES_THETA_SQ = 0.0625     # geom/se3.py threshold (θ < 0.25)


def _triu_pairs():
    return [(a, b) for a in range(6) for b in range(a, 6)]


# ---------------------------------------------------------------- reduce


def _reduce_kernel(x_ref, q_ref, n_ref, w_ref, out_ref, *, block, huber):
    n_pts = w_ref.shape[0]
    idx = pl.program_id(0) * block + jnp.arange(block)
    m = idx < n_pts

    def ld(ref, c):
        return plt.load(ref.at[idx * 3 + c], mask=m, other=0.0)

    x = [ld(x_ref, c) for c in range(3)]
    q = [ld(q_ref, c) for c in range(3)]
    n = [ld(n_ref, c) for c in range(3)]
    wv = plt.load(w_ref.at[idx], mask=m, other=0.0)
    r = n[0] * (x[0] - q[0]) + n[1] * (x[1] - q[1]) + n[2] * (x[2] - q[2])
    ar = jnp.abs(r)
    w = wv * jnp.where(ar <= huber, 1.0, huber / jnp.maximum(ar, 1e-12))
    j = (n[0], n[1], n[2],
         x[1] * n[2] - x[2] * n[1],
         x[2] * n[0] - x[0] * n[2],
         x[0] * n[1] - x[1] * n[0])
    wr = w * r
    vals = [jnp.sum(w * j[a] * j[b]) for a, b in _triu_pairs()]
    vals += [jnp.sum(wr * j[a]) for a in range(6)]
    vals += [jnp.sum(wr * r), jnp.sum(wv)]
    lane = jnp.arange(NUM_SUMS)
    row = jnp.zeros((NUM_SUMS,), jnp.float32)
    for k, v in enumerate(vals):
        row = jnp.where(lane == k, v, row)
    out_ref[...] = row


@functools.partial(jax.jit, static_argnames=("huber_delta", "block",
                                             "interpret"))
def gn_partials(x, q, n, w_valid, huber_delta: float, block: int = 2048,
                interpret: bool = False):
    """(G, 32) partial-sum rows of the GN reduce, G = ceil(N / block)."""
    n_pts = x.shape[0]
    grid = pl.cdiv(n_pts, block)
    flat = pl.no_block_spec
    return pl.pallas_call(
        functools.partial(_reduce_kernel, block=block,
                          huber=float(huber_delta)),
        out_shape=jax.ShapeDtypeStruct((grid, NUM_SUMS), jnp.float32),
        grid=(grid,),
        in_specs=[flat, flat, flat, flat],
        out_specs=pl.BlockSpec((None, NUM_SUMS), lambda i: (i, 0)),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="gn_reduce_partials",
    )(*(a.astype(jnp.float32).reshape(-1) for a in (x, q, n, w_valid)))


# -------------------------------------------------------------- epilogue


def _mm(a, b):
    """Small matrix product as broadcast-multiply-sum (no tensor cores)."""
    return jnp.sum(a[:, :, None] * b[None, :, :], axis=1)


def epilogue_math(sums, T, damping, damping_abs, max_trans, max_rot):
    """GN-step epilogue on a (32,) sum vector (see the module docstring).

    Returns (T_new (4,4), H (8,8) with the 6×6 system top-left,
    stats (4,) = [δ², Σwr², Σvalid, 0]).  Traceable both inside the
    Triton kernel and as plain jnp."""
    f32 = jnp.float32
    i8 = jax.lax.broadcasted_iota(jnp.int32, (8, 8), 0)
    j8 = jax.lax.broadcasted_iota(jnp.int32, (8, 8), 1)
    i4 = jax.lax.broadcasted_iota(jnp.int32, (4, 4), 0)
    j4 = jax.lax.broadcasted_iota(jnp.int32, (4, 4), 1)
    lane = jax.lax.broadcasted_iota(jnp.int32, (NUM_SUMS,), 0)
    rows8 = jax.lax.broadcasted_iota(jnp.int32, (8, 1), 0)
    rows4 = jax.lax.broadcasted_iota(jnp.int32, (4, 1), 0)

    def pat(cond):
        return cond.astype(f32)

    def s_at(k):
        return jnp.sum(jnp.where(lane == k, sums, 0.0))

    H = jnp.zeros((8, 8), f32)
    for k, (a, b) in enumerate(_triu_pairs()):
        sym = ((i8 == a) & (j8 == b)) | ((i8 == b) & (j8 == a))
        H = H + s_at(k) * pat(sym)
    bvec = jnp.zeros((8, 1), f32)
    for k in range(6):
        bvec = bvec + s_at(_B0 + k) * pat(rows8 == k)
    wsq, ninl = s_at(_WSQ), s_at(_NINL)

    # damping (solve_gn_step's two dampings)
    eye6 = pat((i8 == j8) & (i8 < 6))
    diag = H * eye6
    lam_abs = damping_abs * (jnp.sum(diag) / 6.0) + 1e-9
    A = H + damping * diag + lam_abs * eye6
    # augmented system: columns 0..5 = A, column 6 = −b, rows 6, 7 empty
    aug = jnp.where(j8 < 6, A, jnp.where(j8 == 6, -bvec, 0.0))
    for k in range(6):            # forward elimination, no pivoting (SPD)
        akk = jnp.sum(jnp.where((i8 == k) & (j8 == k), aug, 0.0))
        colk = jnp.sum(jnp.where(j8 == k, aug, 0.0), axis=1, keepdims=True)
        rowk = jnp.sum(jnp.where(i8 == k, aug, 0.0), axis=0, keepdims=True)
        aug = aug - (pat(rows8 > k) * colk / akk) * rowk
    for k in range(5, -1, -1):    # back substitution
        akk = jnp.sum(jnp.where((i8 == k) & (j8 == k), aug, 0.0))
        rowk = jnp.sum(jnp.where(i8 == k, aug, 0.0), axis=0,
                       keepdims=True) / akk
        colk = jnp.sum(jnp.where(j8 == k, aug, 0.0), axis=1, keepdims=True)
        aug = aug - (pat(rows8 < k) * colk) * rowk
        aug = jnp.where(i8 == k, rowk, aug)
    delta = jnp.sum(jnp.where(j8 == 6, aug, 0.0), axis=1, keepdims=True)

    # non-finite guard, then the trust region
    finite = jnp.min(jnp.where(jnp.isfinite(delta), 1.0, 0.0))
    delta = jnp.where(jnp.isfinite(delta), delta, 0.0) * finite
    rho_sq = jnp.sum(jnp.where(rows8 < 3, delta * delta, 0.0))
    phi_sq = jnp.sum(jnp.where((rows8 >= 3) & (rows8 < 6),
                               delta * delta, 0.0))
    scale = jnp.minimum(
        1.0, jnp.minimum(max_trans / jnp.maximum(jnp.sqrt(rho_sq), 1e-12),
                         max_rot / jnp.maximum(jnp.sqrt(phi_sq), 1e-12)))
    delta = delta * scale
    delta_sq = jnp.sum(delta * delta)

    # SE(3) exp through 4×4 generators, then T_new = exp(δ)·T
    def comp(k):
        return jnp.sum(jnp.where(rows8 == k, delta, 0.0))

    phx, phy, phz = comp(3), comp(4), comp(5)
    gx = pat((i4 == 2) & (j4 == 1)) - pat((i4 == 1) & (j4 == 2))
    gy = pat((i4 == 0) & (j4 == 2)) - pat((i4 == 2) & (j4 == 0))
    gz = pat((i4 == 1) & (j4 == 0)) - pat((i4 == 0) & (j4 == 1))
    W = phx * gx + phy * gy + phz * gz
    W2 = _mm(W, W)
    t2 = phx * phx + phy * phy + phz * phz
    ts_safe = jnp.maximum(t2, _SINC_SERIES_THETA_SQ)
    theta = jnp.sqrt(ts_safe)
    small = t2 < _SINC_SERIES_THETA_SQ
    a_co = jnp.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0,
                     jnp.sin(theta) / theta)
    b_co = jnp.where(small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0,
                     (1.0 - jnp.cos(theta)) / ts_safe)
    c_co = jnp.where(small, 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0,
                     (theta - jnp.sin(theta)) / (ts_safe * theta))
    i3 = pat((i4 == j4) & (i4 < 3))
    R4 = i3 + a_co * W + b_co * W2
    V4 = i3 + b_co * W + c_co * W2
    rho4 = (comp(0) * pat(rows4 == 0) + comp(1) * pat(rows4 == 1)
            + comp(2) * pat(rows4 == 2))                       # (4, 1)
    t4 = jnp.sum(V4 * jnp.transpose(rho4), axis=1, keepdims=True)
    E = R4 + t4 * pat(j4 == 3) + pat((i4 == 3) & (j4 == 3))
    T_new = _mm(E, T)
    lane4 = jax.lax.broadcasted_iota(jnp.int32, (4,), 0)
    stats = (jnp.where(lane4 == 0, delta_sq, 0.0)
             + jnp.where(lane4 == 1, wsq, 0.0)
             + jnp.where(lane4 == 2, ninl, 0.0))
    return T_new, H, stats


def _epilogue_kernel(parts_ref, t_ref, tnew_ref, h_ref, stats_ref, *,
                     rows, params):
    g = jnp.arange(rows)[:, None]
    lane = jnp.arange(NUM_SUMS)[None, :]
    parts = plt.load(parts_ref.at[g * NUM_SUMS + lane],
                     mask=g < parts_ref.shape[0] // NUM_SUMS, other=0.0)
    T_new, H, stats = epilogue_math(jnp.sum(parts, axis=0), t_ref[...],
                                    *params)
    tnew_ref[...] = T_new
    h_ref[...] = H
    stats_ref[...] = stats


@functools.partial(jax.jit, static_argnames=(
    "damping", "damping_abs", "max_trans", "max_rot", "interpret"))
def gn_epilogue(parts, T, damping: float, damping_abs: float,
                max_trans: float, max_rot: float, interpret: bool = False):
    """One-program GN-step epilogue over (G, 32) partial rows.

    Returns (T_new (4,4), H (6,6) undamped, δ², Σwr², Σvalid)."""
    g = parts.shape[0]
    rows = pl.next_power_of_2(g)
    f32 = jnp.float32
    T_new, H8, stats = pl.pallas_call(
        functools.partial(_epilogue_kernel, rows=rows, params=(
            float(damping), float(damping_abs), float(max_trans),
            float(max_rot))),
        out_shape=(jax.ShapeDtypeStruct((4, 4), f32),
                   jax.ShapeDtypeStruct((8, 8), f32),
                   jax.ShapeDtypeStruct((4,), f32)),
        in_specs=[pl.no_block_spec, pl.BlockSpec((4, 4), lambda: (0, 0))],
        out_specs=(pl.BlockSpec((4, 4), lambda: (0, 0)),
                   pl.BlockSpec((8, 8), lambda: (0, 0)),
                   pl.BlockSpec((4,), lambda: (0,))),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="gn_epilogue",
    )(parts.astype(f32).reshape(-1), T.astype(f32))
    return T_new, H8[:6, :6], stats[0], stats[1], stats[2]
