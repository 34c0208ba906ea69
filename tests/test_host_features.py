"""Host (C++/numpy) feature extractor vs the reference oracle, and the
fused native LIS vs the Python semantic reference."""
import numpy as np
import pytest

from describealign_jax.ops.host_features import (_numpy_features,
                                                 extract_features_host)
from tests import reference_impl as R


def _oracle(pcm_f16):
    return ([R.oracle_energy(pcm_f16), R.oracle_zero_crossings(pcm_f16)]
            + R.oracle_freq_bands(pcm_f16))


@pytest.mark.parametrize("channels", [1, 2])
def test_host_features_match_oracle(channels):
    rng = np.random.default_rng(11)
    pcm = (rng.standard_normal((channels, 44100 * 9)) * 9000).astype(np.int16)
    got = extract_features_host(pcm)
    want = _oracle(pcm.astype(np.float16))
    assert [len(g) for g in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=5e-5, atol=5e-6)


def test_host_features_numpy_fallback_matches_oracle():
    rng = np.random.default_rng(12)
    pcm = (rng.standard_normal((2, 44100 * 5)) * 4000).astype(np.int16)
    got = _numpy_features(pcm.astype(np.float16))
    for g, w in zip(got, _oracle(pcm.astype(np.float16))):
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-6)


def test_host_features_padded_stereo_view():
    """Bucket-padded stereo PCM trimmed by true_samples must equal the
    unpadded extraction (regression: a strided column-slice view was once
    handed to C++ as a raw buffer)."""
    rng = np.random.default_rng(13)
    true = 44100 * 7 + 123
    ceil210 = -(-true // 210) * 210
    pcm = (rng.standard_normal((2, true)) * 9000).astype(np.int16)
    pcm = np.pad(pcm, ((0, 0), (0, ceil210 - true)))  # contiguous, exact len
    padded = np.pad(pcm, ((0, 0), (0, 44100 * 3)))    # bucket padding
    got = extract_features_host(padded, true)
    want = extract_features_host(pcm, true)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_host_features_quantizes_to_f16_grid():
    # values above 2048 are not exactly representable in float16; the
    # extractor must quantize like the reference's float16 PCM storage
    pcm = np.array([[32767, -32767, 2049, 1024, 3, 0, -1, 12345]
                    * 44100], np.int16)[:, :44100 * 8]
    got = extract_features_host(pcm)
    want = _oracle(pcm.astype(np.float16))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=5e-5, atol=5e-6)


def test_host_features_fullscale_stereo_no_overflow():
    """Clipped full-scale stereo: the f16 channel mean must accumulate in
    f32 like numpy (per-step f16 rounding overflows 32768+32768 to inf)."""
    rng = np.random.default_rng(14)
    mono = (rng.standard_normal(44100 * 6) * 30000)
    pcm = np.clip(np.round(mono), -32768, 32767).astype(np.int16)
    pcm = np.repeat(pcm[None, :], 2, axis=0)          # duplicated channels
    got = extract_features_host(pcm)
    assert all(np.isfinite(g).all() for g in got)
    want = _oracle(pcm.astype(np.float16))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=5e-5, atol=5e-6)


def test_lis_from_match_equals_python_reference():
    from describealign_jax.alignment import lis
    rng = np.random.default_rng(21)
    nb, blk, k = 7, 210, 8
    quals = rng.uniform(0, 50, (nb, blk, k)).astype(np.float32)
    quals[rng.uniform(size=quals.shape) < 0.6] = 0.0    # empty slots
    offs = rng.integers(0, 768, (nb, blk, k)).astype(np.int16)
    starts = (np.arange(nb) * 150).astype(np.int32)

    got_v, got_a = lis.lis_from_match(quals, offs, starts)

    vids = starts[:, None, None].astype(np.int64) + offs
    a, v, q = lis.candidates_from_match_output(quals, vids)
    want_v, want_a = lis.weighted_lis_py(a, v, q)
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_a, want_a)


def test_native_rescale_matches_numpy():
    """features.cpp rescale_feature vs the numpy rescale loop in api.py:
    identical after the f32 round (f64 reassociation noise only)."""
    from describealign_jax.alignment.api import _rescale_native

    rng = np.random.default_rng(33)
    na, nv, npath = 5000, 4700, 3100
    feats_a = (rng.uniform(0, 2.5, (5, na + 8)).astype(np.float32))
    feats_v = (rng.uniform(0, 2.5, (5, nv + 8)).astype(np.float32))
    xi = np.sort(rng.integers(0, na, npath)).astype(np.int64)
    yi = np.sort(rng.integers(0, nv, npath)).astype(np.int64)

    got_a = np.empty((na, 3), np.float32)
    got_v = np.empty((nv, 3), np.float32)
    ok = _rescale_native(feats_a, feats_v, na, nv, xi, yi, got_a, got_v)
    if not ok:
        import pytest
        pytest.skip("native library unavailable")

    want_a = np.empty((na, 3), np.float32)
    want_v = np.empty((nv, 3), np.float32)
    for j in range(3):
        vf = feats_v[j, :nv].astype(np.float64)
        af = feats_a[j, :na].astype(np.float64)
        af_std = np.std(af)
        vy = vf[yi]
        scale = np.dot(vy, af[xi]) / np.maximum(np.dot(vy, vy), 1e-30)
        want_a[:, j] = af / af_std
        want_v[:, j] = vf * (scale / af_std)
    np.testing.assert_allclose(got_a, want_a, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-6, atol=1e-9)


def test_native_rescale_rejects_out_of_range_path():
    from describealign_jax.alignment.api import _rescale_native
    na, nv = 64, 64
    feats = np.ones((5, 64), np.float32)
    xi = np.array([0, 70], np.int64)                  # out of range
    yi = np.array([0, 1], np.int64)
    a = np.empty((na, 3), np.float32)
    v = np.empty((nv, 3), np.float32)
    assert not _rescale_native(feats, feats, na, nv, xi, yi, a, v), \
        "out-of-range path index must report failure (numpy fallback)"
