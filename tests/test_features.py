"""Feature-frontend parity tests against the numpy golden model."""
import numpy as np
import pytest

from describealign_jax.ops.features import extract_features
from tests import reference_impl as ref


def make_pcm(seconds=3.0, channels=1, seed=0):
    rng = np.random.default_rng(seed)
    s = int(44100 * seconds)
    t = np.arange(s) / 44100.
    sig = (4000 * np.sin(2 * np.pi * 440 * t)
           + 2000 * np.sin(2 * np.pi * 3217 * t)
           + 1500 * rng.standard_normal(s))
    # amplitude envelope with silent gaps (tests quiet-frame paths downstream)
    env = (np.sin(2 * np.pi * t / 2.3) > -0.4).astype(float)
    pcm = np.tile((sig * env)[None, :], (channels, 1))
    if channels > 1:
        pcm[1] *= 0.7
    int16 = np.clip(np.round(pcm), -32768, 32767).astype(np.int16)
    return int16.astype(np.float16)  # the reference's storage dtype


@pytest.mark.parametrize('channels', [1, 2])
def test_energy_parity(channels):
    pcm = make_pcm(channels=channels)
    got = np.asarray(extract_features(pcm.astype(np.float32))[0])
    want = ref.oracle_energy(pcm)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-7)


@pytest.mark.parametrize('channels', [1, 2])
def test_zero_crossings_parity(channels):
    pcm = make_pcm(channels=channels)
    got = np.asarray(extract_features(pcm.astype(np.float32))[1])
    want = ref.oracle_zero_crossings(pcm)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize('channels', [1, 2])
def test_freq_bands_parity(channels):
    pcm = make_pcm(channels=channels)
    got = extract_features(pcm.astype(np.float32))[2:]
    want = ref.oracle_freq_bands(pcm)
    assert len(got) == 3
    for g, w in zip(got, want):
        g = np.asarray(g)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=5e-5, atol=5e-6)


def test_feature_lengths():
    pcm = make_pcm(seconds=2.5).astype(np.float32)
    feats = extract_features(pcm)
    s = pcm.shape[1]
    assert feats[0].shape[0] == -(-(s - s % 105) // 105 // 1) // 2 + (
        1 if ((s // 105) % 2) else 0) or True  # energy: ceil((s//105)/2)
    assert feats[0].shape[0] == (s // 105 + 1) // 2
    for f in feats[1:]:
        assert f.shape[0] == s // 210


def test_zero_padding_extends_cleanly():
    """Padding PCM with zeros must not perturb interior feature frames.

    This is what makes length-bucketed batched extraction legal.
    """
    pcm = make_pcm(seconds=2.0).astype(np.float32)
    padded = np.pad(pcm, ((0, 0), (0, 210 * 50)))
    f0 = [np.asarray(x) for x in extract_features(pcm)]
    f1 = [np.asarray(x) for x in extract_features(padded)]
    for a, b in zip(f0, f1):
        n = len(a) - 8  # boundary smear is <= 7 frames (hann smoothing reach)
        np.testing.assert_allclose(a[:n], b[:n], rtol=1e-5, atol=1e-6)
