"""Randomized stress equivalence of the three L1-fit backends.

Synthetic compressed node paths (the fit's real input: piecewise-linear
y(x) with sparse offset jumps, optional rate changes, Laplace noise and
outliers) are solved by 'native' (exact host fused-lasso cascade),
'device' (JAX ADMM + cyclic reduction), and 'highs' (the reference's
exact LP) - the recovered smooth paths must agree within ~a frame and
slopes/medians within 1e-3 across many seeds and regimes.
"""
import numpy as np
import pytest

from describealign_jax.alignment.fit import solve_l1_fit

N_SEEDS = 18        # x 3 regimes = 54 randomized instances


def _make_path(rng, regime):
    """Return (x, y_noisy, y_true) for one synthetic instance.

    Instances are kept DECISIVE: rate changes only occur across long
    segments (slope-change evidence well beyond the RATE_CHANGE_COST
    threshold) so all exact solvers share one optimum - near the
    fuse-vs-split decision boundary the LP legitimately has multiple
    optima and path equality is not a meaningful test.
    """
    if regime == "rate":
        n = int(rng.integers(280, 400))
        x = np.cumsum(rng.uniform(150, 400, n))
        breaks = [n // 3]   # unequal spans: the weighted-median slope is
        # decisively the longer segment's (at n//2 it teeters between both)
        slope_pool = [1.0 + rng.choice([-1, 1]) * rng.uniform(0.015, 0.03),
                      1.0 + rng.choice([-1, 1]) * rng.uniform(0.015, 0.03)]
    else:
        n = int(rng.integers(120, 320))
        x = np.cumsum(rng.uniform(21, 260, n))
        n_breaks = int(rng.integers(1, 5)) if regime == "skips" else 0
        breaks = sorted(rng.choice(np.arange(10, n - 10), n_breaks,
                                   replace=False)) if n_breaks else []
        slope_pool = [1.0] * (len(breaks) + 1)
    y = np.empty(n)
    y0 = rng.uniform(-4000, 4000)
    seg_start = 0
    for k, b in enumerate(list(breaks) + [n]):
        seg = slice(seg_start, b)
        slope = slope_pool[min(k, len(slope_pool) - 1)]
        y[seg] = y0 + slope * (x[seg] - x[seg_start])
        if b < n:
            y0 = y[b - 1] + rng.uniform(400, 3000) * rng.choice([-1, 1])
            seg_start = b
    noise = rng.laplace(0, 0.5, n)
    out_idx = rng.choice(n, max(1, n // 40), replace=False)
    noise[out_idx] += rng.laplace(0, 8, len(out_idx))
    return x, y + noise, y


# trimmed-98% path tolerance per regime: in the rate regime the LP's
# bounded shot-noise channel gives its smooth path a legitimately free
# +/-2-frame band (plus break-placement freedom at the slope change), so
# node-level agreement is looser there; slopes agree to ~1e-4 everywhere
# (the l1_refine_segment_slopes de-bias this suite originally caught).
PATH_TOL = {"skips": 2.0, "noise": 2.0, "rate": 8.0}


@pytest.mark.parametrize("regime", ["skips", "rate", "noise"])
def test_fit_backends_agree_randomized(regime):
    import zlib
    rng = np.random.default_rng(zlib.crc32(regime.encode()))  # stable seed
    # (builtin hash() is salted per process - it made failures flaky)
    worst = {"dev": 0.0, "lp": 0.0, "slope_dev": 0.0, "slope_lp": 0.0}
    for trial in range(N_SEEDS):
        x, y, y_true = _make_path(rng, regime)
        ref = solve_l1_fit(x, y, backend="native")
        dev = solve_l1_fit(x, y, backend="device")
        lp = solve_l1_fit(x, y, backend="highs")

        # recovered smooth paths agree within ~a frame away from the
        # (ambiguous) jump nodes themselves
        for tag, other in (("dev", dev), ("lp", lp)):
            d = np.abs(ref["smooth_y"] - other["smooth_y"])
            # drop the 2% worst nodes: exactly-at-jump placement is a
            # legitimately non-unique LP vertex choice
            d_typ = np.sort(d)[: int(len(d) * 0.98)]
            worst[tag] = max(worst[tag], float(d_typ.max()))
        worst["slope_dev"] = max(worst["slope_dev"],
                                 abs(ref["median_slope"]
                                     - dev["median_slope"]))
        worst["slope_lp"] = max(worst["slope_lp"],
                                abs(ref["median_slope"]
                                    - lp["median_slope"]))

        # every backend must track the true underlying path
        for sol in (ref, dev, lp):
            err = np.abs(sol["smooth_y"] - y_true)
            assert np.median(err) < 1.5, (regime, trial, np.median(err))

    assert worst["dev"] < PATH_TOL[regime] + 4.0, worst   # ADMM headroom
    assert worst["lp"] < PATH_TOL[regime], worst
    assert worst["slope_dev"] < 1e-3, worst
    assert worst["slope_lp"] < 1e-3, worst
