"""L1 piecewise-linear fit: on-device ADMM vs the exact LP (HiGHS)."""
import numpy as np
import pytest

from describealign_jax.alignment.fit import solve_l1_fit


def make_nodes(seed=0, n=400, n_segments=3, noise=0.6, outliers=0.02):
    """Compressed-path-like nodes: piecewise-linear y(x) + noise + outliers."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.integers(1, 40, n)).astype(np.float64)
    bounds = np.sort(rng.choice(np.arange(1, n - 1), n_segments - 1,
                                replace=False))
    slopes = 1.0 + rng.uniform(-0.04, 0.04, n_segments)
    offsets = np.cumsum(np.concatenate(([rng.uniform(100, 400)],
                                        rng.uniform(200, 900, n_segments - 1))))
    y = np.empty(n)
    seg_id = np.zeros(n, int)
    seg_id[bounds] = 1
    seg_id = np.cumsum(seg_id)
    for k in range(n_segments):
        sel = seg_id == k
        x0 = x[sel][0]
        y0 = offsets[k] + (x0 * slopes[k])
        y[sel] = y0 + (x[sel] - x0) * slopes[k]
    y += rng.normal(0, noise, n)
    out = rng.random(n) < outliers
    y[out] += rng.uniform(-40, 40, out.sum())
    return x, y, slopes


@pytest.mark.parametrize('seed', [0, 1])
def test_device_fit_matches_linprog(seed):
    """The native fused-lasso cascade vs the exact LP.

    Structural agreement is required (same number of slope segments, smooth
    path within a frame); exact slope values may differ slightly on
    adversarial data where multiple robust fits tie - pass 2 refits cluster
    lines from smooth_path, so end-to-end nodes agree (see
    test_alignment.test_fit_backends_equivalent).
    """
    x, y, true_slopes = make_nodes(seed=seed)
    ref = solve_l1_fit(x, y, backend='highs')
    got = solve_l1_fit(x, y, backend='device')
    assert abs(got['median_slope'] - ref['median_slope']) < 2e-2
    # same segment structure
    assert (len(np.unique(np.round(got['slopes'], 6)))
            == len(np.unique(np.round(ref['slopes'], 6))))
    # smooth path within a fraction of a frame nearly everywhere
    err = np.abs(got['smooth_y'] - ref['smooth_y'])
    assert np.percentile(err, 90) < 1.0
    assert np.median(err) < 0.4


def test_device_segments_are_exactly_constant():
    x, y, _ = make_nodes(seed=3)
    got = solve_l1_fit(x, y, backend='device')
    slopes = got['slopes']
    # snapped slopes must form few exactly-equal runs (clusterable at 1e-6
    # rounding, like the LP's vertex-sparse solutions)
    n_unique = len(np.unique(np.round(slopes, 6)))
    assert n_unique <= 25


def test_tv_weighted_l2_kkt():
    """Exact-solver KKT check: q_k = -sum_{i<=k} w_i(theta_i - r_i) must obey
    |q_k| <= kappa_k, equality (with matching sign) where theta jumps, and
    q_{n-1} == 0 - necessary and sufficient for this convex problem."""
    from describealign_jax.alignment.fit_tv import _tv, tv_weighted_l2_py
    rng = np.random.default_rng(0)
    for trial in range(20):
        n = int(rng.integers(2, 200))
        r = rng.normal(0, 1, n) + np.cumsum(rng.normal(0, 0.3, n))
        w = rng.uniform(0.1, 50.0, n)
        kappa = rng.uniform(0.0, 30.0, max(n - 1, 1))
        for solver in (_tv, tv_weighted_l2_py):
            theta = solver(r, w, kappa)
            q = -np.cumsum(w * (theta - r))
            assert abs(q[-1]) < 1e-6, f"trial {trial}: q_end {q[-1]}"
            for k in range(n - 1):
                assert abs(q[k]) <= kappa[k] + 1e-6, f"trial {trial} edge {k}"
                jump = theta[k + 1] - theta[k]
                if abs(jump) > 1e-9:
                    # stationarity: sum_{i<=k} w_i(theta_i-r_i) = p_k with
                    # p_k = kappa_k*sign(jump); our q_k = -p_k
                    assert abs(q[k] + np.sign(jump) * kappa[k]) < 1e-6, \
                        f"trial {trial} edge {k}: active-edge KKT"


def test_fit_tiny_node_counts_all_backends():
    """The fit is a public API: node counts below the continuity window
    (possible only outside align(), whose path floor guarantees >= 15
    compressed nodes) must not crash any backend."""
    import numpy as np
    from describealign_jax.alignment.fit import solve_l1_fit
    for n in (3, 4, 10, 40):
        rng = np.random.default_rng(n)
        x = np.cumsum(rng.uniform(50, 200, n))
        y = x + 100 + rng.laplace(0, 0.3, n)
        for be in ("native", "device", "highs"):
            r = solve_l1_fit(x, y, backend=be)
            assert np.isfinite(r["smooth_y"]).all()
            assert abs(r["median_slope"] - 1.0) < 0.05
