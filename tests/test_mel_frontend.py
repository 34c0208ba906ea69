"""Optional mel filterbank frontend (DESCRIBEALIGN_FRONTEND=mel)."""
import numpy as np
import pytest

from describealign_jax.ops import mel


def test_filterbank_shape_and_coverage():
    fb = mel.mel_filterbank()
    assert fb.shape == (3, mel.N_FFT // 2 + 1)
    # each band is a nonempty triangle; together they cover the mid range
    assert (fb.sum(axis=1) > 0).all()
    bins_hz = np.arange(mel.N_FFT // 2 + 1) * mel.SR / mel.N_FFT
    mid = (bins_hz > 300) & (bins_hz < 6000)
    assert (fb.sum(axis=0)[mid] > 0).all()


def test_host_and_device_mel_agree():
    rng = np.random.default_rng(4)
    pcm = (rng.standard_normal((2, 44100 * 5)) * 6000).astype(np.int16)
    host = mel.mel_band_features_host(pcm.astype(np.float16))
    import jax.numpy as jnp
    dev = [np.asarray(b) for b in mel.mel_band_features(
        jnp.asarray(pcm, jnp.float32).astype(jnp.float16).astype(jnp.float32))]
    for h, d in zip(host, dev):
        assert len(h) == len(d) == 5 * 210
        np.testing.assert_allclose(h, d, rtol=2e-3, atol=2e-4)


def test_mel_frontend_aligns_offset(monkeypatch):
    """The alternative frontend must still recover a planted offset through
    the full align() pipeline (parity with the reference is NOT claimed)."""
    monkeypatch.setenv("DESCRIBEALIGN_FRONTEND", "mel")
    from describealign_jax.alignment.api import align_from_pcm
    from describealign_jax.utils.synthmedia import build_pair
    video, audio, _ = build_pair(content_seconds=30.0, narration=(),
                                 lead_in=4.0, seed=19)
    vi = np.clip(video, -32768, 32767).astype(np.int16)
    ai = np.clip(audio, -32768, 32767).astype(np.int16)
    x, y, sim, path, m = align_from_pcm(vi, ai)[:5]
    offset = float(x[0] - y[0])
    assert abs(offset - 4.0) < 0.3
    assert sim > 80.0
