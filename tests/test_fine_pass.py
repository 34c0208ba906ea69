"""The XLA fine pass: its qualities against a float64 evaluation of the
Pearson + Naive-Bayes formula, and chunked (b0 > 0) against single-shot
rows."""
import jax
import numpy as np
import pytest

from describealign_jax.alignment import matching, preprocess
from describealign_jax.alignment.api import _stack_padded
from describealign_jax.ops.features import extract_features
from describealign_jax.utils.synthmedia import build_pair

NPAD = 210 * 20
LEAD = 2                     # seconds of narration before the content


@pytest.fixture(scope='module')
def pair_state():
    """Preprocessed features and masks of a 14-s pair (2-s lead-in)."""
    video, audio, _ = build_pair(content_seconds=14.0, narration=(),
                                 lead_in=float(LEAD), seed=0)
    fs_a = [np.asarray(f) for f in extract_features(audio)]
    fs_v = [np.asarray(f) for f in extract_features(video)]
    na = min(len(f) for f in fs_a)
    nv = min(len(f) for f in fs_v)
    fa = _stack_padded(fs_a, na, NPAD)
    fv = _stack_padded(fs_v, nv, NPAD)
    ms_a, norms_a = (np.asarray(x) for x in preprocess.preprocess_features(fa))
    ms_v, norms_v = (np.asarray(x) for x in preprocess.preprocess_features(fv))
    a_mask = np.asarray(preprocess.valid_audio_mask(fa[0], na))
    v_mask = np.asarray(preprocess.valid_video_mask(fv[0], nv))
    return ms_a, norms_a, a_mask, ms_v, norms_v, v_mask


def qualities_f64(ms_a, norms_a, a_mask, ms_v, norms_v, v_mask, b, start):
    """(210, 768) float64 qualities of one block, 0 where a gate fails
    (reference describealign.py:662-673, as matching._fine_block states)."""
    w = preprocess.WINDOW
    a0 = b * matching.BLOCK
    t = np.arange(w)
    a_win = ms_a[:, a0 + np.arange(matching.BLOCK)[:, None] + t].astype(
        np.float64)                                        # (5, 210, 41)
    v_win = ms_v[:, start + np.arange(matching.FINE_W)[:, None] + t].astype(
        np.float64)                                        # (5, 768, 41)
    dots = np.einsum('fld,fed->fle', a_win, v_win)
    na = norms_a[:, a0:a0 + matching.BLOCK].astype(np.float64)
    nv = norms_v[:, start:start + matching.FINE_W].astype(np.float64)
    corr = dots / (na[:, :, None] * nv[:, None, :])
    prob = np.prod(np.maximum(1e-8, 1.0 - corr[:3]), axis=0) ** 2.9
    qual = np.minimum(50.0, (prob / 1e-12) ** (-1.0 / 3))
    l_idx = np.arange(matching.BLOCK)[:, None]
    e_idx = np.arange(matching.FINE_W)[None, :]
    valid = ((e_idx >= l_idx) & (e_idx <= l_idx + 2 * matching.FINE_HALF_BAND)
             & a_mask[a0:a0 + matching.BLOCK, None]
             & v_mask[None, start:start + matching.FINE_W]
             & (prob <= 1e-8)
             & (np.maximum(corr[3], corr[4]) >= matching.BAND_GATE))
    return np.where(valid, qual, 0.0)


@pytest.mark.parametrize('b', [4, 6])
def test_fine_block_matches_float64_formula(pair_state, b):
    """Every candidate the f32 fine block keeps carries the float64
    formula's quality (the products run at matching.MATMUL_PRECISION), and
    each frame's top slot is the float64 maximum up to near-ties."""
    # band centred on the true offset (audio = video + LEAD s)
    start = b * matching.BLOCK - LEAD * 210 - matching.FINE_HALF_BAND
    want = qualities_f64(*pair_state, b, start)
    top_q, top_e = jax.jit(matching._fine_block)(
        *[pair_state[i] for i in (0, 1, 3, 4, 2, 5)], b, start)
    top_q, top_e = np.asarray(top_q), np.asarray(top_e).astype(np.int64)
    live = top_q > 0
    assert live.sum() > 500
    rows = np.nonzero(live)[0]
    ref = want[rows, top_e[live]]
    # f32 correlations carry ~1e-6 absolute error; 1 - corr ~ 0.01-0.1 and
    # the ^2.9, ^(-1/3) powers turn that into up to ~1e-4 relative
    np.testing.assert_allclose(top_q[live], ref, rtol=5e-4)
    # a slot is empty only where fewer than TOP_K candidates pass the gates
    n_valid = np.sum(want > 0, axis=1)
    np.testing.assert_array_equal(np.sum(live, axis=1),
                                  np.minimum(n_valid, matching.TOP_K))
    best = want.max(axis=1)
    framed = best > 0
    assert np.all(want[framed, top_e[framed, 0]] >= best[framed] * (1 - 5e-4))


def test_fine_tracks_chunk_equals_single_shot(pair_state):
    """A chunk that starts at block b0 > 0 (the streamed path) reproduces
    the single-shot pass's rows b0.. exactly."""
    ms_a, norms_a, a_mask, ms_v, norms_v, v_mask = pair_state
    nb = matching.nb_for(NPAD)
    base = np.arange(nb, dtype=np.int32) * matching.BLOCK - LEAD * 210
    starts = np.clip(np.stack([base, base + 1500]) - matching.FINE_HALF_BAND,
                     0, NPAD - (matching.FINE_W + preprocess.WINDOW - 1))
    starts = starts.astype(np.int32)
    run = jax.jit(matching._fine_tracks, static_argnums=(8,))
    full = run(ms_a, norms_a, a_mask, ms_v, norms_v, v_mask, starts, 0, nb,
               nb)
    b0 = 3
    part = run(ms_a, norms_a, a_mask, ms_v, norms_v, v_mask,
               starts[:, b0:], b0, nb - b0, nb)
    assert np.asarray(full[0]).max() > 0
    for got, want in zip(part, full):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want)[b0:])
