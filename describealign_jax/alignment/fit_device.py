"""On-device L1 piecewise-linear fit (JAX ADMM + cyclic reduction).

The on-device counterpart of fit_tv.py's host cascade (SURVEY §2
native table: "replace [HiGHS] with an on-device constrained L1 solve";
reference solver at describealign.py:841-844). Same two-stage
decomposition - a slope fused-lasso then an offset fused-lasso - but each
1-D problem

    min_t  sum_i c_i |t_i - b_i|  +  sum_k kappa_k |t_{k+1} - t_k|

is solved directly (no IRLS smoothing) by ADMM with two splittings
(p = t - b for the data term, z = Dt for the TV term). The t-update's
tridiagonal system (rho1*I + rho2*D^T D) t = rhs has a CONSTANT matrix, so
it is solved by cyclic reduction: log2(N) levels of fully vectorized
elimination - the data-parallel alternative to the inherently sequential
Johnson/Thomas recursions. Rate-change breakpoints come from the ADMM z
variable, which is exactly sparse by soft-thresholding.

Problems are padded to fixed power-of-two buckets (zero data cost and zero
TV coupling across the padding) so XLA compiles a handful of shapes.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .fit import (RATE_CHANGE_COST, compute_jump_costs,
                  l1_refine_segment_slopes)

ADMM_ITERS = 800
OVER_RELAX = 1.8


def _cr_solve(diag, off, rhs):
    """Solve the symmetric tridiagonal system A x = rhs by cyclic reduction.

    diag: (N,), off: (N-1,) sub/super diagonal, N a power of two. Out-of-
    range neighbors are treated as zero. All levels are static slices, so
    the whole solve is a fixed, fully vectorized XLA graph of depth log2 N.
    """
    a = jnp.concatenate([jnp.zeros(1, diag.dtype), off])    # sub,   a[0]=0
    c = jnp.concatenate([off, jnp.zeros(1, diag.dtype)])    # super, c[-1]=0
    b = diag
    d = rhs

    stack = []
    while b.shape[0] > 1:
        # eliminate even-indexed unknowns from the odd-indexed equations
        be, be_next = b[0::2], jnp.concatenate([b[2::2], jnp.ones(1, b.dtype)])
        ao, co = a[1::2], c[1::2]
        alpha = ao / be                      # couples row i to row i-1
        gamma = co / be_next                 # couples row i to row i+1
        ae, ce = a[0::2], c[0::2]
        a_next = jnp.concatenate([a[2::2], jnp.zeros(1, a.dtype)])
        ce_next = jnp.concatenate([c[2::2], jnp.zeros(1, c.dtype)])
        de, de_next = d[0::2], jnp.concatenate([d[2::2], jnp.zeros(1, d.dtype)])
        stack.append((a, b, c, d))
        b = b[1::2] - alpha * ce - gamma * a_next
        a = -alpha * ae
        c = -gamma * ce_next
        d = d[1::2] - alpha * de - gamma * de_next

    x = d / b                                # single equation at the top

    while stack:
        a0, b0, c0, d0 = stack.pop()
        # x holds the odd-indexed unknowns of this level; recover evens
        x_left = jnp.concatenate([jnp.zeros(1, x.dtype), x])
        x_right = jnp.concatenate([x, jnp.zeros(1, x.dtype)])
        n_even = b0[0::2].shape[0]
        xe = (d0[0::2] - a0[0::2] * x_left[:n_even]
              - c0[0::2] * x_right[:n_even]) / b0[0::2]
        full = jnp.zeros(b0.shape[0], x.dtype)
        full = full.at[0::2].set(xe)
        full = full.at[1::2].set(x)
        x = full
    return x


def _soft(v, thresh):
    return jnp.sign(v) * jnp.maximum(jnp.abs(v) - thresh, 0.0)


@partial(jax.jit, static_argnames=('iters',))
def _fused_lasso_admm(b_vals, c_cost, kappa, rho1, rho2, iters=ADMM_ITERS):
    """ADMM for min sum c|t-b| + sum kappa|Dt|. All inputs padded to 2^k
    (c=0 and kappa=0 over the padding). rho2 is PER-EDGE - scaling it with
    kappa keeps every soft-threshold kappa_k/rho2_k at the data scale, so
    dual variables reach the threshold in a few dozen iterations even when
    the TV weight is enormous (RATE_CHANGE_COST = 40000 vs slope signals
    of ~0.03). Returns (t, z) - z is the exactly sparse TV copy used for
    breakpoint detection."""
    n = b_vals.shape[0]
    # constant system matrix: rho1*I + D^T diag(rho2) D
    rho2_l = jnp.concatenate([jnp.zeros(1), rho2])   # edge left of node i
    rho2_r = jnp.concatenate([rho2, jnp.zeros(1)])   # edge right of node i
    diag = rho1 + rho2_l + rho2_r
    off = -rho2

    def dt(t):
        return t[1:] - t[:-1]

    def dtt_w(z):   # D^T diag(rho2) z
        w = rho2 * z
        return jnp.concatenate([-w[:1], w[:-1] - w[1:], w[-1:]])

    def step(state, _):
        t, p, z, a_dual, e_dual = state
        rhs = rho1 * (b_vals + p - a_dual) + dtt_w(z - e_dual)
        t = _cr_solve(diag, off, rhs)
        # over-relaxation on both constraints
        t_hat_p = OVER_RELAX * (t - b_vals) + (1 - OVER_RELAX) * p
        t_hat_z = OVER_RELAX * dt(t) + (1 - OVER_RELAX) * z
        p = _soft(t_hat_p + a_dual, c_cost / rho1)
        z = _soft(t_hat_z + e_dual, kappa / rho2)
        a_dual = a_dual + t_hat_p - p
        e_dual = e_dual + t_hat_z - z
        return (t, p, z, a_dual, e_dual), None

    t0 = b_vals
    init = (t0, jnp.zeros(n), dt(t0), jnp.zeros(n), jnp.zeros(n - 1))
    (t, p, z, _, _), _ = jax.lax.scan(step, init, None, length=iters)
    return t, z


def _pad_pow2(arr, n_pad, fill=0.0):
    return np.pad(np.asarray(arr, np.float64), (0, n_pad - len(arr)),
                  constant_values=fill)


def _prep_problem(b, data_cost, kappa, n_pad):
    """Shared padding + penalty-scale setup (see fused_lasso_l1_device):
    returns (b_p, c_p, k_p, rho1, rho2) numpy arrays for one problem."""
    b = np.asarray(b, np.float64)
    data_cost = np.asarray(data_cost, np.float64)
    kappa = np.asarray(kappa, np.float64)
    n = len(b)
    b_p = _pad_pow2(b, n_pad, fill=float(b[-1]))
    c_p = _pad_pow2(data_cost, n_pad, fill=0.0)
    k_p = np.zeros(n_pad - 1)
    k_p[:min(len(kappa), n_pad - 1)] = kappa[:n_pad - 1]
    k_p[n - 1:] = 0.0                       # padding floats freely

    # data scale: a robust spread of b sets every soft-threshold's size
    scale = float(np.median(np.abs(b - np.median(b))))
    scale = max(scale, 1e-6 * max(1.0, float(np.abs(b).max())), 1e-12)
    rho1 = float(max(np.median(data_cost[data_cost > 0]), 1e-3)) / scale \
        if np.any(data_cost > 0) else 1.0
    # per-edge rho2: thresholds kappa/rho2 all land at ~2*scale
    r2 = np.maximum(k_p, 1e-3) / (2.0 * scale)
    return b_p, c_p, k_p, rho1, r2


def fused_lasso_l1_device(b, data_cost, kappa, iters=ADMM_ITERS):
    """Host-facing wrapper: pads to a power-of-two bucket, runs the ADMM on
    the default JAX device, returns (t, break_mask) for the REAL region."""
    n = len(b)
    n_pad = 1 << max(4, int(np.ceil(np.log2(max(n, 2)))))
    b_p, c_p, k_p, rho1, r2 = _prep_problem(b, data_cost, kappa, n_pad)
    t, z = _fused_lasso_admm(jnp.asarray(b_p), jnp.asarray(c_p),
                             jnp.asarray(k_p), rho1, jnp.asarray(r2),
                             iters=iters)
    t = np.asarray(t, np.float64)[:n]
    z = np.asarray(z, np.float64)[:max(n - 1, 1)]
    return t, z != 0.0


@partial(jax.jit, static_argnames=('iters',))
def _fused_lasso_admm_batched(b, c, k, rho1, rho2, iters):
    return jax.vmap(
        lambda bb, cc, kk, r1, r2: _fused_lasso_admm(bb, cc, kk, r1, r2,
                                                     iters=iters)
    )(b, c, k, rho1, rho2)


def fused_lasso_l1_device_batched(problems, iters=ADMM_ITERS):
    """ONE vmapped ADMM dispatch for a batch of (b, data_cost, kappa)
    problems padded to a common power-of-two bucket - amortizes the
    iteration latency of the 800-step scan (the dominant cost on real
    hardware, PERF.md) across all problems. Returns a list of
    (t, break_mask) per problem."""
    n_pad = 1 << max(4, int(np.ceil(np.log2(
        max(max(len(b) for b, _, _ in problems), 2)))))
    B = len(problems)
    bs = np.empty((B, n_pad))
    cs = np.empty((B, n_pad))
    ks = np.empty((B, n_pad - 1))
    r1s = np.empty((B,))
    r2s = np.empty((B, n_pad - 1))
    for i, (b, c, k) in enumerate(problems):
        bs[i], cs[i], ks[i], r1s[i], r2s[i] = _prep_problem(b, c, k, n_pad)
    t, z = _fused_lasso_admm_batched(jnp.asarray(bs), jnp.asarray(cs),
                                     jnp.asarray(ks), jnp.asarray(r1s),
                                     jnp.asarray(r2s), iters)
    t = np.asarray(t, np.float64)
    z = np.asarray(z, np.float64)
    return [(t[i, :len(b)], z[i, :max(len(b) - 1, 1)] != 0.0)
            for i, (b, _, _) in enumerate(problems)]


def _weighted_median(values, weights):
    order = np.argsort(values)
    csum = np.cumsum(weights[order])
    return float(values[order][np.searchsorted(csum, csum[-1] / 2.0)])


def solve_l1_fit_device(x, y):
    """Drop-in replacement for fit._solve_linprog / fit_tv.solve_l1_fit_tv
    (same return dict), with both fused-lassos solved on device."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = len(x)
    xd = np.diff(x)
    r = np.diff(y) / xd
    jc = compute_jump_costs(x, y)

    # ---- stage 1: piecewise-constant slopes -------------------------------
    slope_cost = np.minimum(2.0, jc) * xd
    kappa1 = np.full(max(n - 2, 1), float(RATE_CHANGE_COST))
    theta, z_breaks = fused_lasso_l1_device(r, slope_cost, kappa1)

    # snap to exact runs using the ADMM's sparse TV copy; within a fused
    # segment the LP's interior optimum is the cost-weighted MEDIAN of the
    # raw slopes, so snap to that (sharper than averaging the shrunk theta)
    seg_id = np.zeros(n - 1, int)
    seg_id[1:] = np.cumsum(z_breaks[:n - 2].astype(int))
    slopes = theta.copy()
    for k in range(seg_id.max() + 1):
        sel = seg_id == k
        slopes[sel] = _weighted_median(r[sel], slope_cost[sel])
    # de-bias long segments (see fit.l1_refine_segment_slopes docstring)
    slopes = l1_refine_segment_slopes(x, y, seg_id, slopes)

    # ---- stage 2: piecewise-constant offsets with sparse jumps ------------
    node_slope = np.concatenate([slopes, slopes[-1:]])
    b = y - node_slope * x
    kappa2 = jc.copy()
    kappa2[np.flatnonzero(np.diff(slopes) != 0)] = 0.0
    beta, _ = fused_lasso_l1_device(b, np.ones(n), kappa2)

    smooth_y = node_slope * x + beta
    fit_err = y - smooth_y

    order = np.argsort(slopes)
    csum = np.cumsum(xd[order])
    median_slope = float(slopes[order][np.searchsorted(csum, csum[-1] / 2.0)])

    return dict(fit_err=fit_err, slopes=slopes, median_slope=median_slope,
                smooth_y=smooth_y)


def solve_l1_fit_device_batched(node_sets):
    """solve_l1_fit_device for a batch of (x, y) node sets with the two
    ADMM stages dispatched as ONE vmapped device program each (the
    batched-dispatch experiment from the round-3 review: amortize the
    800-iteration scan latency across all pairs' fits). Identical
    per-problem math to the sequential entry; returns a list of result
    dicts."""
    prepped = []
    for x, y in node_sets:
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        xd = np.diff(x)
        r = np.diff(y) / xd
        jc = compute_jump_costs(x, y)
        slope_cost = np.minimum(2.0, jc) * xd
        kappa1 = np.full(max(len(x) - 2, 1), float(RATE_CHANGE_COST))
        prepped.append((x, y, xd, r, jc, slope_cost, kappa1))

    # ---- stage 1 (batched): piecewise-constant slopes ----------------------
    stage1 = fused_lasso_l1_device_batched(
        [(r, sc, k1) for (_, _, _, r, _, sc, k1) in prepped])

    stage2_problems = []
    mids = []
    for (x, y, xd, r, jc, slope_cost, _), (theta, z_breaks) in zip(prepped,
                                                                   stage1):
        n = len(x)
        seg_id = np.zeros(n - 1, int)
        seg_id[1:] = np.cumsum(z_breaks[:n - 2].astype(int))
        slopes = theta.copy()
        for k in range(seg_id.max() + 1):
            sel = seg_id == k
            slopes[sel] = _weighted_median(r[sel], slope_cost[sel])
        slopes = l1_refine_segment_slopes(x, y, seg_id, slopes)
        node_slope = np.concatenate([slopes, slopes[-1:]])
        b = y - node_slope * x
        kappa2 = jc.copy()
        kappa2[np.flatnonzero(np.diff(slopes) != 0)] = 0.0
        stage2_problems.append((b, np.ones(n), kappa2))
        mids.append((x, y, xd, slopes, node_slope))

    # ---- stage 2 (batched): piecewise-constant offsets ---------------------
    stage2 = fused_lasso_l1_device_batched(stage2_problems)

    results = []
    for (x, y, xd, slopes, node_slope), (beta, _) in zip(mids, stage2):
        smooth_y = node_slope * x + beta
        fit_err = y - smooth_y
        order = np.argsort(slopes)
        csum = np.cumsum(xd[order])
        median_slope = float(
            slopes[order][np.searchsorted(csum, csum[-1] / 2.0)])
        results.append(dict(fit_err=fit_err, slopes=slopes,
                            median_slope=median_slope, smooth_y=smooth_y))
    return results
