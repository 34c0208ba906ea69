"""Unit tests for the final-output stage (similarity, nodes, extrapolation)
and the continuity utilities - semantics per reference 702-767, 995-1027."""
import numpy as np

from describealign_jax.alignment.continuity import (compress_path,
                                                    continuity_filter,
                                                    get_continuity_err)
from describealign_jax.alignment.outputs import similarity_and_nodes


def make_path(n=2000, clusters=((0, 1000, 0.0), (1000, 2000, 50.0))):
    """(M, 5) rows (video, audio, cluster, qual, cum) on cluster lines."""
    rows = []
    for ci, (a0, a1, offset) in enumerate(clusters):
        for a in range(a0, a1):
            rows.append((a + offset, a, ci, 1.0, a))
    return np.array(rows, float)


def test_similarity_counts_unique_nondescription_frames():
    path = make_path()
    x, y, sim, _ = similarity_and_nodes(path, 2500, 2500, 2500, 2500)
    # 2000 unique frames of 2500 -> 80%
    assert abs(sim - 80.0) < 1e-9


def test_nodes_at_cluster_boundaries_and_extrapolation():
    path = make_path()
    x, y, sim, _ = similarity_and_nodes(path, 2500, 2600, 2500, 2600)
    # boundary nodes at the cluster switch (+/- .1 frame, in seconds)
    assert len(x) == 4
    np.testing.assert_allclose(x[1], (999 - .1) / 210., rtol=1e-12)
    np.testing.assert_allclose(x[2], (1000 + .1) / 210., rtol=1e-12)
    # end segment longer than 2 s: extrapolated to the audio end
    np.testing.assert_allclose(x[-1], (2500 - 1) / 210., rtol=1e-12)
    # start segment extrapolates to t=0 (offset 0 line)
    assert x[0] == 0.0 and abs(y[0]) < 1e-9


def test_continuity_err_flags_outliers():
    rng = np.random.default_rng(0)
    x = np.arange(500.0)
    y = x * 1.01 + 3 + rng.normal(0, 0.2, 500)
    y[100] += 50.0  # gross outlier
    err = get_continuity_err(x, y)
    assert err[100] > 10
    assert np.median(err) < 1.0
    xf, yf = continuity_filter(x, y)
    assert len(xf) < len(x)
    assert 100.0 not in xf


def test_compress_path_collapses_clean_runs():
    x = np.arange(1000.0)
    y = x + 5.0
    cx, cy = compress_path(x, y)
    # reference shape: first 10 raw points, 70-point runs -> means, raw tail
    assert len(cx) < 100
    np.testing.assert_allclose(cx[:10], np.arange(10.0))
    np.testing.assert_allclose(np.diff(cx[10:-75])[1:-1], 70.0, atol=1e-9)
    np.testing.assert_allclose(cy - cx, 5.0, atol=1e-9)
    assert np.all(np.diff(cx) > 0)


def test_continuity_filter_native_matches_numpy():
    """The fused native continuity filter must be BIT-equal to the numpy
    chain (same conv kernel, same expression order) across path shapes:
    clean lines, jumps, outliers, and nan-producing flat spans."""
    import os
    import numpy as np
    rng = np.random.default_rng(11)
    cases = []
    x = np.cumsum(rng.uniform(0.5, 1.5, 2000))
    y = x * 0.98 + 7 + rng.normal(0, 0.4, len(x))
    y[300:310] += 40.0
    y[1200] -= 25.0
    cases.append((x, y))
    x2 = np.arange(400.0)
    y2 = np.where(x2 < 200, x2, x2 + 30.0) + rng.normal(0, 0.1, 400)
    cases.append((x2, y2))
    x3 = np.repeat(np.arange(40.0), 2)[:60]   # duplicate x -> zero divisions
    y3 = x3 + rng.normal(0, 0.3, len(x3))
    cases.append((x3, y3))
    for x, y in cases:
        xf, yf = continuity_filter(x, y)
        os.environ['DESCRIBEALIGN_NO_NATIVE'] = '1'
        try:
            # the env gate is read at lib load; force the numpy chain by
            # calling it directly
            from describealign_jax.alignment.continuity import \
                get_continuity_err
            keep = get_continuity_err(x, y) < 3.0
        finally:
            del os.environ['DESCRIBEALIGN_NO_NATIVE']
        np.testing.assert_array_equal(xf, x[keep])
        np.testing.assert_array_equal(yf, y[keep])


def test_continuity_short_inputs_match_numpy():
    """Regression: _conv must reproduce np.convolve's argument swap for
    sub-taps-length inputs (the native kernel would compute a negative
    'valid' length and crash); a 17-point path through continuity_filter
    must return (all-inf err -> empty) like the pure-numpy chain."""
    from describealign_jax.alignment.continuity import (_conv,
                                                        _half_hann_taps)
    rng = np.random.default_rng(5)
    taps = _half_hann_taps()
    for n in (1, 5, len(taps) - 1, len(taps), len(taps) + 3):
        x = rng.normal(size=n)
        for mode in ('valid', 'same'):
            got = _conv(x, taps, mode)
            want = np.convolve(x, taps, mode=mode)
            if n < len(taps):       # the regression: numpy on both sides
                np.testing.assert_array_equal(got, want)
            else:                   # native kernel: ulp-level order diffs
                np.testing.assert_allclose(got, want, rtol=1e-12)
    x = np.arange(17.0)
    xf, yf = continuity_filter(x, x + 3.0)
    assert len(xf) == len(yf) == 0


def test_plot_alignment_without_matplotlib(tmp_path, monkeypatch, capsys):
    """matplotlib is optional: without it the .txt report is still written
    and one line says why the .png is missing."""
    import sys

    from describealign_jax.report.plots import plot_alignment
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    path = np.array([[0.0, 6.0, 0, 1.0, 1.0], [10.0, 16.0, 0, 1.0, 2.0]])
    stem = str(tmp_path / 'pair')
    plot_alignment(stem, path, np.array([6.0, 16.0]), np.array([0.0, 10.0]),
                   75.0, 1.0, False, False, 'ffmpeg -i in out')
    assert 'Start Offset: 6.00 seconds' in (tmp_path / 'pair.txt').read_text()
    assert not (tmp_path / 'pair.png').exists()
    assert 'matplotlib is not installed' in capsys.readouterr().out
