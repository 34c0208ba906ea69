"""Alignment cache keying: identity, version, and decode-mode safety."""
import os

import numpy as np

from describealign_jax.utils import aligncache


def _fake_outputs():
    return (np.array([0.0, 10.0]), np.array([2.0, 12.0]), 55.5,
            np.array([[0.0, 2.0], [10.0, 12.0]]), 1.0)


def _touch(path, data=b"x" * 100):
    with open(path, 'wb') as f:
        f.write(data)


def test_roundtrip_and_identity(tmp_path):
    v, a = str(tmp_path / "v.mp4"), str(tmp_path / "a.mp3")
    _touch(v); _touch(a)
    d = str(tmp_path)
    assert aligncache.load(d, v, a) is None
    aligncache.save(d, v, a, _fake_outputs())
    got = aligncache.load(d, v, a)
    assert got is not None
    np.testing.assert_allclose(got[0], [0.0, 10.0])
    assert got[2] == 55.5
    # content change invalidates
    _touch(v, b"y" * 200)
    assert aligncache.load(d, v, a) is None


def test_mode_channel_count_is_part_of_the_key(tmp_path):
    """A default-mode (1-ch) alignment must never be served to a stretch
    (2-ch) run: the feature numerics differ (ZCR doubling, channel-mean
    bands; reference describealign.py:1096)."""
    v, a = str(tmp_path / "v.wav"), str(tmp_path / "a.wav")
    _touch(v); _touch(a)
    d = str(tmp_path)
    aligncache.save(d, v, a, _fake_outputs(), num_channels=1)
    assert aligncache.load(d, v, a, num_channels=1) is not None
    assert aligncache.load(d, v, a, num_channels=2) is None
    aligncache.save(d, v, a, _fake_outputs(), num_channels=2)
    assert aligncache.load(d, v, a, num_channels=2) is not None
    assert aligncache.load(d, v, a, num_channels=1) is None
