"""Edge cases: short media, silence, bucket boundaries."""
import numpy as np
import pytest

from describealign_jax.alignment.api import align_from_pcm
from describealign_jax.utils.synthmedia import SR, build_pair, speech_like


def _i16(x):
    return np.clip(np.round(x), -32768, 32767).astype(np.int16)


def test_short_but_valid_media_aligns():
    """Just above the reference's minimum path floor (5*210 frames = 5 s)."""
    video, audio, _ = build_pair(content_seconds=9.0, narration=(),
                                 lead_in=1.5, seed=41)
    x, y, sim, path, m = align_from_pcm(_i16(video), _i16(audio))[:5]
    assert abs(float(x[0] - y[0]) - 1.5) < 0.3
    assert sim > 80


def test_silence_only_pair_raises():
    v = np.zeros((1, SR * 20), np.int16)
    a = np.zeros((1, SR * 25), np.int16)
    with pytest.raises(RuntimeError, match="mismatched"):
        align_from_pcm(v, a)


def test_silence_gaps_inside_content():
    """Quiet spans must be masked out, not matched; alignment still
    recovers the offset from the voiced regions."""
    content = speech_like(36.0, seed=42)
    content[int(10 * SR):int(14 * SR)] = 0.0
    content[int(24 * SR):int(27 * SR)] = 0.0
    video = _i16(content)[None]
    audio = _i16(np.concatenate([speech_like(5.0, seed=1042, amp=5000.0),
                                 content]))[None]
    x, y, sim, path, m = align_from_pcm(video, audio)[:5]
    assert abs(float(x[0] - y[0]) - 5.0) < 0.3


def test_media_length_exactly_on_bucket_boundary():
    """A 64-s-multiple frame count must not break padding/masking."""
    secs = 64.0  # feature bucket quantum
    content = speech_like(secs - 4.0, seed=43)
    video = _i16(content)[None]
    audio = _i16(np.concatenate([speech_like(4.0, seed=1043, amp=5000.0),
                                 content]))[None]
    assert audio.shape[1] == int(secs * SR)
    x, y, sim, path, m = align_from_pcm(video, audio)[:5]
    assert abs(float(x[0] - y[0]) - 4.0) < 0.3
