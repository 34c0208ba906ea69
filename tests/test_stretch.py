"""Stretch-mode kernels: resampler and phase vocoder."""
import numpy as np

from describealign_jax.stretch.resample import resample_segment
from describealign_jax.stretch.phase_vocoder import pv_stretch

SR = 44100


def tone(freq, seconds, amp=8000.0):
    t = np.arange(int(seconds * SR)) / SR
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)[None, :]


def dominant_freq(x):
    spec = np.abs(np.fft.rfft(x[0] * np.hanning(len(x[0]))))
    return np.argmax(spec) * SR / len(x[0])


def test_resample_identity():
    sig = tone(440, 2.0)
    out = resample_segment(sig, 0, sig.shape[1], sig.shape[1])
    assert out.shape == sig.shape
    # interior must match closely (f16 write-back quantization)
    err = np.abs(out[:, 100:-100] - sig[:, 100:-100])
    assert np.max(err) < 40.0  # ~0.5% of amplitude (f16 grid at 8000)


def test_resample_shifts_pitch():
    sig = tone(440, 2.0)
    n_out = int(sig.shape[1] * 1.05)  # slower -> lower pitch
    out = resample_segment(sig, 0, sig.shape[1], n_out)
    assert out.shape[1] == n_out
    f = dominant_freq(out)
    assert abs(f - 440 / 1.05) < 2.0


def test_pv_preserves_pitch():
    sig = tone(440, 3.0)
    n_out = int(sig.shape[1] * 1.08)
    out = pv_stretch(sig, n_out)
    assert out.shape == (1, n_out)
    f = dominant_freq(out[:, SR // 2: -SR // 2])
    assert abs(f - 440) < 3.0  # pitch unchanged despite 8% stretch
    # energy preserved (no dropouts): compare RMS
    rms_in = np.sqrt(np.mean(sig ** 2))
    rms_out = np.sqrt(np.mean(out[:, SR // 2: -SR // 2] ** 2))
    assert 0.7 * rms_in < rms_out < 1.3 * rms_in


def test_pv_multichannel_and_chunk_joins():
    rng = np.random.default_rng(0)
    n = int(SR * 9.5)  # spans multiple 4 s chunks
    sig = np.stack([rng.standard_normal(n), rng.standard_normal(n)]).astype(
        np.float32) * 3000
    n_out = int(n * 0.93)
    out = pv_stretch(sig, n_out)
    assert out.shape == (2, n_out)
    # no silent holes at chunk boundaries
    chunk = SR * 4
    for boundary in range(chunk, n_out - SR, chunk):
        seg = out[:, boundary - 2048:boundary + 2048]
        assert np.sqrt(np.mean(seg ** 2)) > 500


def test_pv_host_chunked_matches_whole_segment(monkeypatch):
    """The streamed host PV (bounded _HOST_BLK_FRAMES blocks with
    locked-phase carry-over, round 5) is arithmetic-identical to the
    whole-segment pipeline frame by frame; only the overlap-add's FP
    accumulation ORDER differs at block seams, so outputs agree to
    rounding scale."""
    from describealign_jax.stretch import phase_vocoder as pv
    rng = np.random.default_rng(7)
    n = int(SR * 30.0)
    sig = (np.stack([rng.standard_normal(n), rng.standard_normal(n)])
           .astype(np.float32) * 2500)
    num_out = int(n / 1.04)
    rate = n / num_out
    f = -(-num_out // pv.HOP_SYN)
    assert f > 2 * pv._HOST_BLK_FRAMES  # spans >= 3 carry blocks
    got = pv._pv_host(sig, rate, num_out)
    monkeypatch.setattr(pv, '_HOST_BLK_FRAMES', 1 << 30)
    want = pv._pv_host(sig, rate, num_out)
    assert got.shape == want.shape == (2, num_out)
    np.testing.assert_allclose(got, want, rtol=0, atol=0.5)


def test_phase_lock_carry_native_matches_numpy(monkeypatch):
    """pv_phase_lock_carry (C++) and the numpy fallback's seeded
    recurrence compute the same locked phases."""
    from describealign_jax.stretch import phase_vocoder as pv
    from describealign_jax.alignment import native as native_mod
    rng = np.random.default_rng(11)
    c, f, bins = 2, 9, 33
    phase_a = rng.uniform(-np.pi, np.pi, (c, f, bins)).astype(np.float32)
    mag = rng.uniform(0.0, 10.0, (c, f, bins)).astype(np.float32)
    ior = rng.uniform(-1.0, 1.0, (c, f, bins)).astype(np.float32)
    init = rng.uniform(-np.pi, np.pi, (c, bins)).astype(np.float32)
    got = pv._phase_lock(phase_a, mag, ior, init)
    monkeypatch.setattr(native_mod, 'native_lib', lambda: None)
    want = pv._phase_lock(phase_a, mag, ior, init)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_wsola_preserves_pitch_and_samples():
    """The reference-parity splicer: pitch unchanged, content is literal
    copies of input spans (no resampling artifacts)."""
    from describealign_jax.stretch.wsola import wsola_stretch
    rng = np.random.default_rng(3)
    t = np.arange(int(3.0 * SR)) / SR
    sig = (6000 * np.sin(2 * np.pi * 440 * t)
           + 800 * rng.standard_normal(len(t))).astype(np.float32)[None, :]
    n_out = int(sig.shape[1] * 1.06)
    out = np.zeros((1, n_out), np.float32)
    wsola_stretch(sig, out)
    f = dominant_freq(out[:, SR // 2: -SR // 2])
    assert abs(f - 440) < 3.0
    rms_in = np.sqrt(np.mean(sig ** 2))
    rms_out = np.sqrt(np.mean(out[:, SR // 4: -SR // 4] ** 2))
    assert 0.7 * rms_in < rms_out < 1.3 * rms_in
    # shrink direction too
    n_out2 = int(sig.shape[1] * 0.94)
    out2 = np.zeros((1, n_out2), np.float32)
    wsola_stretch(sig, out2)
    f2 = dominant_freq(out2[:, SR // 2: -SR // 2])
    assert abs(f2 - 440) < 3.0


def test_wsola_default_stretcher():
    """WSOLA is the default stretcher (reference-parity algorithm AND 5x
    faster than the PV on all-stretched media, PERF.md round 4)."""
    from describealign_jax.stretch import segments
    video = tone(300, 10.0)
    audio = tone(440, 10.5)
    # one segment: audio [0, 10.3s] -> video [0, 10.0s] (3% stretch)
    segments.replace_aligned_segments(
        video, audio, np.array([0.0, 10.3]), np.array([0.0, 10.0]), False)
    f = dominant_freq(video[:, SR:-SR])
    assert abs(f - 440) < 3.0  # replaced with (unshifted) description pitch


def test_pv_backend_selectable(monkeypatch):
    """DESCRIBEALIGN_STRETCH=pv routes stretched segments through the
    phase vocoder."""
    from describealign_jax.stretch import segments
    monkeypatch.setenv('DESCRIBEALIGN_STRETCH', 'pv')
    video = tone(300, 10.0)
    audio = tone(440, 10.5)
    segments.replace_aligned_segments(
        video, audio, np.array([0.0, 10.3]), np.array([0.0, 10.0]), False)
    f = dominant_freq(video[:, SR:-SR])
    assert abs(f - 440) < 3.0


def test_resample_native_matches_numpy(monkeypatch):
    """The native resample_quad kernel is bit-equal to the numpy twin
    (f64 positions, half-to-even rounding, f32 weighting order, f16-grid
    write-back) - on noise, where any position/rounding drift shows."""
    import pytest as _pytest
    from describealign_jax.alignment import native as native_mod
    from describealign_jax.stretch import resample

    if native_mod.native_lib() is None or not hasattr(
            native_mod.native_lib(), 'resample_quad'):
        _pytest.skip("native library unavailable")
    rng = np.random.default_rng(11)
    sig = (rng.standard_normal((2, int(4.0 * SR))) * 9000).astype(np.float32)
    n_out = int(sig.shape[1] * 0.96)
    got_native = resample.resample_segment(sig, 13.7, sig.shape[1] - 2.2,
                                           n_out)
    monkeypatch.setattr(resample, 'native_lib', lambda: None, raising=False)
    # the numpy twin imports native_lib inside _resample_host; patch the
    # module it imports from
    monkeypatch.setattr(native_mod, 'native_lib', lambda: None)
    got_numpy = resample.resample_segment(sig, 13.7, sig.shape[1] - 2.2,
                                          n_out)
    np.testing.assert_array_equal(got_native, got_numpy)


def test_resample_host_matches_device():
    """The default host resampler and the bucketed device kernel agree
    (identical 3-point Lagrange math; host positions are f64, device f32 -
    the ~1e-3-sample position error is only visible on non-smooth signals,
    so compare on band-limited content like real audio)."""
    import os
    sig = np.concatenate([tone(440, 3.0, amp=5000), tone(523, 3.0, amp=5000)])
    n_out = int(sig.shape[1] * 1.04)
    got_host = resample_segment(sig, 7.0, sig.shape[1] - 3.0, n_out)
    os.environ['DESCRIBEALIGN_RESAMPLE'] = 'device'
    try:
        got_dev = resample_segment(sig, 7.0, sig.shape[1] - 3.0, n_out)
    finally:
        del os.environ['DESCRIBEALIGN_RESAMPLE']
    assert got_host.shape == got_dev.shape == (2, n_out)
    # f16 grid step at amp 5000 is 4; f32 position error contributes ~1
    np.testing.assert_allclose(got_host, got_dev, atol=16.0)
    # and the host path must preserve pitch like the device one
    f = dominant_freq(got_host[:1, SR:-SR])
    assert abs(f - 440 / 1.04) < 2.0
