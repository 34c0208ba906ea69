"""Low-confidence guard: the coarse k-best margin and its WARNING plumbing.

The guard (matching._coarse_tracks -> api.warn_low_confidence) is our
equivalent of the reference's hash-bin gate starving into the path-length
raise (describealign.py:698-699): when the winning coarse track's
per-anchor-block score advantage over the best disjoint alternative is
below the campaign-calibrated floor, the map is likely a self-similarity
ridge and a WARNING line is emitted (calibration: scripts/diag_confidence.py;
adjudication: scripts/diag_narrowband.py draws 02/05).
"""
import numpy as np

import jax.numpy as jnp

from describealign_jax.alignment import matching
from describealign_jax.alignment.api import align_from_pcm, warn_low_confidence
from describealign_jax.utils import aligncache

from .synth import build_pair


def _i16(pcm):
    return np.clip(pcm, -32768, 32767).astype(np.int16)


def test_margin_u8_codec_roundtrip():
    for m in [0.0, 0.001, 0.0399, 0.04, 0.1, 0.25, 0.5]:
        code = int(matching._margin_code_u8(jnp.float32(m)))
        assert 1 <= code <= 254
        got = matching.margin_from_code(code)
        # quantization grid is 1/500 - far finer than the floor comparison
        assert abs(got - m) <= (0.5 / 500.0) + 1e-9
    for m in [0.6, 3.0]:
        # codes saturate at 255 = inf: anything that far above the floor
        # only needs to stay on the quiet side of the guard
        assert matching.margin_from_code(
            int(matching._margin_code_u8(jnp.float32(m)))) == float('inf')
    assert matching.margin_from_code(
        int(matching._margin_code_u8(jnp.float32(np.inf)))) == float('inf')
    # code 0 = absent (legacy transport); decodes to None, never emitted
    assert matching.margin_from_code(0) is None


def test_margin_i16_codec_roundtrip():
    for m in [0.0, 0.037, 0.5, 12.0, float('inf')]:
        words = matching._margin_words_i16(jnp.float32(m), rows=3)
        assert words.shape == (3, 2)
        got = matching.margin_from_i16(np.asarray(words)[0, 0])
        if np.isinf(m):
            assert np.isinf(got)
        else:
            # f16 transport: ~3 decimal digits
            assert abs(got - m) <= max(1e-3, m * 1e-3)
        # every row carries the same word (rows may be consumed from any
        # chunk boundary)
        assert len(set(np.asarray(words)[:, 0].tolist())) == 1


def test_warn_low_confidence_line_protocol(capsys):
    warn_low_confidence(matching.COARSE_MARGIN_FLOOR / 2)
    out = capsys.readouterr().out
    assert out.startswith("  WARNING: low alignment confidence")
    # the GUI transcript classifier keys on the two-space WARNING prefix
    from describealign_jax.gui import core
    assert core.classify_line(out.rstrip("\n")) == "warning"

    for quiet in (matching.COARSE_MARGIN_FLOOR * 2, float('inf'), None):
        warn_low_confidence(quiet)
        assert capsys.readouterr().out == ""


def test_aligned_pair_margin_clears_floor():
    """Clean aligned media must not trip the guard (no false positives on
    the regimes every other test exercises)."""
    video, audio, _ = build_pair(content_seconds=40.0,
                                 narration=((8.0, 3.0),),
                                 lead_in=2.0, seed=77)
    out = align_from_pcm(_i16(video), _i16(audio))
    assert len(out) == 6
    margin = out[5]
    assert margin is not None and np.isfinite(margin)
    assert margin > matching.COARSE_MARGIN_FLOOR, (
        f"clean-pair margin {margin:.4f} at/below floor "
        f"{matching.COARSE_MARGIN_FLOOR}")


def test_low_margin_coarse_retry(monkeypatch):
    """Escalation: a below-floor margin re-runs the coarse pass over all
    5 streams (api._coarse_retry); the retried map ships iff its margin -
    normalized to the 3-stream scale the floor was calibrated at - clears
    both the floor and the original. Forced deterministically by placing
    the floor relative to the pair's measured 3- and 5-stream margins."""
    import jax

    from describealign_jax.alignment.api import (_bucket_pad,
                                                 host_features_padded)

    video, audio, _ = build_pair(content_seconds=40.0,
                                 narration=((8.0, 3.0),),
                                 lead_in=2.0, seed=78)
    v, a = _i16(video), _i16(audio)
    sv, sa = v.shape[1], a.shape[1]
    npad = max(_bucket_pad(sv // 210), _bucket_pad(sa // 210))
    fv, nv = host_features_padded(v, sv, npad)
    fa, na = host_features_padded(a, sa, npad)
    dev_a = jax.device_put(fa.astype(np.float16))
    dev_v = jax.device_put(fv.astype(np.float16))
    m3 = float(np.asarray(
        matching.match_from_features(dev_a, na, dev_v, nv)[3]))
    m5n = (float(np.asarray(matching.match_from_features(
        dev_a, na, dev_v, nv, nf=matching.COARSE_RETRY_STREAMS)[3]))
        * matching.COARSE_STREAMS / matching.COARSE_RETRY_STREAMS)
    assert np.isfinite(m3) and m3 > 0 and np.isfinite(m5n) and m5n > 0

    if m5n > m3 + 0.01:
        # acceptance branch: floor strictly between the two margins (the
        # 0.01 gap keeps the streamed path's 1/500-quantized margin from
        # straddling the floor)
        floor = m3 + (min(m5n, 2.0 * m3) - m3) / 2
        monkeypatch.setattr(matching, 'COARSE_MARGIN_FLOOR', floor)
        out = align_from_pcm(v, a)
        assert abs(out[5] - m5n) < 2e-3, (
            f"retry margin {m5n:.4f} not shipped (got {out[5]:.4f})")
        # the retried map must still recover the planted 2 s lead-in
        assert abs(float(out[0][0] - out[1][0]) - 2.0) < 0.5
    else:
        # rejection branch: floor above both -> retry runs, is rejected,
        # the original result ships with its original (quantized) margin
        floor = max(m3, m5n) * 1.5
        monkeypatch.setattr(matching, 'COARSE_MARGIN_FLOOR', floor)
        out = align_from_pcm(v, a)
        assert abs(out[5] - m3) < 2e-3

    # env kill switch: no retry, the original margin ships untouched
    monkeypatch.setattr(matching, 'COARSE_MARGIN_FLOOR',
                        max(m3, m5n) * 1.5)
    monkeypatch.setenv('DESCRIBEALIGN_COARSE_RETRY', '0')
    out = align_from_pcm(v, a)
    assert abs(out[5] - m3) < 2e-3


def test_raise_path_coarse_retry(monkeypatch):
    """The reference's 'Alignment failed' path-length raise
    (describealign.py:698-699) also triggers the 5-stream escalation: a
    too-short LIS chain is the same coarse-signal starvation the
    low-margin guard catches, one stage later. Forced deterministically
    by making the first host-stages call raise; the retry's second call
    runs the real stages and must recover the planted map."""
    import pytest

    from describealign_jax.alignment import api

    video, audio, _ = build_pair(content_seconds=40.0,
                                 narration=((8.0, 3.0),),
                                 lead_in=2.0, seed=79)
    v, a = _i16(video), _i16(audio)

    real_inner = api._host_stages_from_path_inner
    calls = {"n": 0}

    def flaky_inner(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError(
                "Alignment failed, are the input files mismatched?")
        return real_inner(*args, **kw)

    monkeypatch.setattr(api, '_host_stages_from_path_inner', flaky_inner)
    out = align_from_pcm(v, a)
    assert calls["n"] == 2, "escalation did not re-run the host stages"
    # the recovered map carries the planted 2 s lead-in and a margin
    # that cleared the floor (the acceptance bar on the raise path)
    assert abs(float(out[0][0] - out[1][0]) - 2.0) < 0.5
    assert out[5] > matching.COARSE_MARGIN_FLOOR

    # kill switch: the raise propagates untouched, no second call
    calls["n"] = 0
    monkeypatch.setenv('DESCRIBEALIGN_COARSE_RETRY', '0')
    with pytest.raises(RuntimeError, match="Alignment failed"):
        align_from_pcm(v, a)
    assert calls["n"] == 1


def test_aligncache_margin_roundtrip(tmp_path):
    v, a = str(tmp_path / "v.mp4"), str(tmp_path / "a.mp3")
    for p in (v, a):
        with open(p, 'wb') as f:
            f.write(b"x" * 64)
    base = (np.array([0.0, 10.0]), np.array([2.0, 12.0]), 55.5,
            np.array([[0.0, 2.0], [10.0, 12.0]]), 1.0)
    d = str(tmp_path)
    aligncache.save(d, v, a, base + (0.0625,))
    got = aligncache.load(d, v, a)
    assert got is not None and len(got) == 6
    assert abs(got[5] - 0.0625) < 1e-12
    # legacy 5-tuple saves (pre-guard caches) load with margin None and
    # must stay warning-silent rather than firing spuriously
    aligncache.save(d, v, a, base)
    got = aligncache.load(d, v, a)
    assert got is not None and len(got) == 6
    assert got[5] is None
