"""Batch (vmap) and multi-chip (shard_map) execution tests on the virtual
8-device CPU mesh."""
import jax
import numpy as np
import pytest

from describealign_jax.ops.features import extract_features
from describealign_jax.parallel.batch import (batched_match, device_align_step,
                                              make_mesh, sharded_match)
from describealign_jax.parallel.seqshard import sequence_sharded_features
from describealign_jax.utils.synthmedia import build_pair

N_DEV = 8


@pytest.fixture(scope='module')
def small_batch():
    """8 same-shape pairs of stacked features (B, 5, Npad) + lengths."""
    feats_a, feats_v, lens_a, lens_v = [], [], [], []
    npad = 210 * 20
    for seed in range(N_DEV):
        video, audio, _ = build_pair(content_seconds=14.0, narration=(),
                                     lead_in=2.0, seed=seed)
        for (pcm, feats, lens) in [(audio, feats_a, lens_a),
                                   (video, feats_v, lens_v)]:
            fs = [np.asarray(f) for f in extract_features(pcm)]
            n = min(len(f) for f in fs)
            stacked = np.zeros((5, npad), np.float32)
            for j, f in enumerate(fs):
                stacked[j, :n] = f[:n]
            feats.append(stacked)
            lens.append(n)
    return (np.stack(feats_a), np.array(lens_a, np.int32),
            np.stack(feats_v), np.array(lens_v, np.int32))


def test_sequence_sharded_features_match_unsharded():
    assert jax.device_count() >= N_DEV
    video, _, _ = build_pair(content_seconds=14.0, narration=(), lead_in=2.0,
                             seed=0)
    s = video.shape[1] - video.shape[1] % (210 * N_DEV)
    pcm = video[:, :s]
    mesh = make_mesh(N_DEV, axis='seq')
    sharded = np.asarray(sequence_sharded_features(pcm, mesh))
    unsharded = [np.asarray(f) for f in extract_features(pcm)]
    n = s // 210
    for j in range(5):
        # the first/last <=8 frames carry media-edge boundary smear: the
        # band cascade squares the smoothed "bottom" signal, which reaches
        # into the zero halo, while the unsharded convolution's virtual
        # zero-padding contributes nothing there. ~1e-4 relative on edge
        # frames only - same contract as bucketed zero-padding.
        np.testing.assert_allclose(sharded[j][8:n - 8], unsharded[j][8:n - 8],
                                   rtol=2e-5, atol=2e-5, err_msg=f"feature {j}")


def test_batched_match_equals_single(small_batch):
    fa, la, fv, lv = small_batch
    quals_b, vids_b, centers_b, margins_b = jax.jit(batched_match)(
        fa, la, fv, lv)
    q0, v0, c0, m0 = device_align_step(fa[0], la[0], fv[0], lv[0])
    np.testing.assert_allclose(np.asarray(quals_b)[0], np.asarray(q0),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(vids_b)[0], np.asarray(v0))


def test_sharded_match_equals_batched(small_batch):
    fa, la, fv, lv = small_batch
    mesh = make_mesh(N_DEV, axis='data')
    quals_s, vids_s, centers_s, margins_s = sharded_match(mesh, fa, la, fv, lv)
    quals_b, vids_b, centers_b, margins_b = batched_match(fa, la, fv, lv)
    np.testing.assert_allclose(np.asarray(quals_s), np.asarray(quals_b),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(vids_s), np.asarray(vids_b))
    np.testing.assert_array_equal(np.asarray(centers_s), np.asarray(centers_b))
    np.testing.assert_allclose(np.asarray(margins_s), np.asarray(margins_b),
                               rtol=1e-5, atol=1e-6)


def test_align_batch_sharded_equals_serial():
    """The mesh-sharded batch API must produce the same alignments as the
    serial pipelined path (ragged group: 3 pairs on an 8-device mesh)."""
    from describealign_jax.alignment.api import align_batch_from_pcm

    pairs, lens = [], []
    for seed in (31, 32, 33):
        video, audio, _ = build_pair(content_seconds=16.0, narration=(),
                                     lead_in=2.0 + seed % 3, seed=seed)
        v = np.clip(video, -32768, 32767).astype(np.int16)
        a = np.clip(audio, -32768, 32767).astype(np.int16)
        pairs.append((v, a))
        lens.append((v.shape[1], a.shape[1]))

    mesh = make_mesh(N_DEV, axis='data')
    got = align_batch_from_pcm(pairs, true_samples=lens, mesh=mesh)
    want = align_batch_from_pcm(pairs, true_samples=lens)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0], w[0], atol=1e-6)   # audio times
        np.testing.assert_allclose(g[1], w[1], atol=1e-6)   # video times
        assert abs(g[2] - w[2]) < 1e-9                      # similarity
