"""Match generation on the device: coarse offset search + fine banded
correlation.

The reference finds audio<->video frame matches with a hash-bin inverted
index over quantized 7-tap descriptors plus Python loops
(describealign.py:610-699). That design is irregular and scalar - the
opposite of what XLA wants. This module re-derives the same quantities with
dense, static-shape kernels:

1. COARSE (10 Hz): normalized 41-frame window descriptors of the first 3
   features, strided by 21 frames, matched all-pairs as one GEMM. The score
   matrix is skewed into (time-block, offset) coordinates and a max-plus DP
   (exact via running-cummax distance transforms) finds a monotone offset
   track with |slope| and jump penalties. This replaces the hash index's
   "find candidates anywhere" role.

2. FINE (210 fps): for each 210-frame audio block, windowed Pearson
   correlations of all 5 features against a +/-279-frame video band around
   the coarse track, as batched (210,41)x(41,768) matmuls. Per-frame
   match quality replicates the reference's Naive-Bayes form
   (describealign.py:662-673):
       prob = prod_j max(1e-8, 1-corr_j)^2.9  (j = energy, zcr, band1)
       keep if prob <= 1e-8 and max(corr_band2, corr_band3) >= band_gate
       qual = min(50, (prob/1e-12)^(-1/3))
   The band2/3 gate mirrors the reference's "matches >=1 of the band-2/3
   hash dicts" condition (describealign.py:651-653); BAND_GATE=0.2 and the
   whole replacement stand validated empirically against the EXECUTED
   reference: 25 randomized scenarios (non-integer offsets/skips, +/-3%
   and mid-stream rate changes, 60-200 s leads) agree within 9 ms
   (scripts/parity_campaign.py + tests/test_reference_parity.py).
   Top-K candidates per audio frame stream out for the exact weighted-LIS.

Each stage is a jitted program per shape bucket; nothing inside it waits
on the host.
"""
import os
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from .preprocess import WINDOW, valid_audio_mask, valid_video_mask

# --- geometry constants -----------------------------------------------------
COARSE_STRIDE = 21          # frames between coarse descriptors (0.1 s)
BLOCK = 210                 # audio frames per fine block (1 s)
COARSE_PER_BLOCK = BLOCK // COARSE_STRIDE  # 10
FINE_HALF_BAND = 279        # +/- band around coarse track (1.33 s)
FINE_W = BLOCK + 2 * FINE_HALF_BAND        # 768 video window positions/block
TOP_K = 8                   # candidates kept per audio frame
# Feature streams in the coarse descriptors. The fine-pass gates are
# reference-parity (first 3 features, Naive Bayes, describealign.py:665-
# 672); the coarse stage is our own design and uses however many streams
# score best. Experiment toggle; see COARSE_STREAMS below.
_COARSE_STREAMS_ENV = os.environ.get('DESCRIBEALIGN_COARSE_STREAMS', '')
COARSE_STREAMS = int(_COARSE_STREAMS_ENV) if _COARSE_STREAMS_ENV else 3
# Escalation stream count for the low-confidence retry (api._coarse_retry):
# when the k-best margin falls below COARSE_MARGIN_FLOOR (or the map
# fails the minimum-path-length check outright), the matcher re-runs the
# coarse pass over ALL 5 streams - the two upper band features are immune
# to DC offsets and narrowband distortion that corrupt energy/ZCR (the
# reference survives such media because its candidate gate consults all 5
# hash dicts, describealign.py:650-652; a coarse-level diag on the dcrate
# profile restored in-band tracks on 4 of 6 degraded draws). The
# acceptance gate (margin must clear the calibrated floor AND the
# original) makes the escalation regression-free by construction: on the
# dcrate end-to-end campaign (seed 20260816) results are identical with
# the retry on or off - its value is confined to media where the 3-stream
# margin collapses but the full-band margin doesn't. The default stays 3
# streams: across the clean campaign profiles 3 streams score best and
# the margins that calibrated the floor were measured at 3.
COARSE_RETRY_STREAMS = 5

# --- quality / DP constants -------------------------------------------------
QUAL_PROB_CUTOFF = 1e-8     # reference 670
QUAL_SCALE = 1e-12          # reference 672
QUAL_MAX = 50.0             # reference 672
NB_EXPONENT = 2.9           # reference 669
BAND_GATE = 0.2             # gate threshold for band2/band3 agreement
DP_SLOPE_COST = 0.5         # per-lane move cost per block (10%/lane rate dev)
# Cost of a free jump (skips/offsets). The coarse track's job is RECALL -
# the fine pass's prob/band gates and the LIS/fit filter spurious segments -
# so jumps are cheap (the reference's hash index has no length penalty at
# all; its min replaceable segment is 2 s). Tuning history: 8.0 corner-cut
# 7-s segments between adjacent skips (test_parity_skip_heavy); 4.0 still
# corner-cut ~8-12 s segments on music-bed content, where repetitive tonal
# ridges raise every lane's floor score and shrink the true lane's margin
# to ~0.2-0.5/block (round-3 campaign draws 4/11/25 - pinned in
# tests/test_reference_parity.py music-bed cases); 2.0 still corner-cut a
# 10-s FIRST segment under a 0.41-ratio bed whose ridges tied the true
# lane's score (campaign seed 20260818 draw 17, pinned likewise - both
# k-best tracks chose ridges, so only cheaper jumps recover short
# segments the margin can't amortize). At 1.0 that draw recovers exactly,
# and re-runs of all three campaign seeds (25+40+30 draws, music beds
# included) show no spurious-jump regressions (the fine gates + LIS
# arbitrate ridge excursions).
DP_JUMP_COST = 1.0
# lax.scan unroll for the coarse DP's per-block relaxation steps. Each
# step is a handful of elementwise ops over the D video lanes, so at ~1800
# blocks per 22-min pair the while-loop's per-iteration overhead rivals the
# arithmetic; unrolling amortizes it without changing the math (scan unroll
# is exact - the DP equality tests cover both paths).
DP_SCAN_UNROLL = 8
# Precision of the coarse and fine correlation products. The fine pass
# scores 1 - corr for correlations near 1 (a quality of 50 needs
# 1 - corr ~ 0.01 per stream), so TF32's ~1e-3 error in a dot product
# would move a candidate's quality by ~10%; full f32 matches the CPU.
MATMUL_PRECISION = jax.lax.Precision.HIGHEST


def _windows(x, start, count, width=WINDOW):
    """(F, count, width) sliding windows of x[:, start + i + t]."""
    seg = jax.lax.dynamic_slice_in_dim(x, start, count + width - 1, axis=1)
    return jnp.stack([seg[:, t:t + count] for t in range(width)], axis=2)


# ---------------------------------------------------------------------------
# Coarse pass
# ---------------------------------------------------------------------------

# Sub-lane phase shifts for the VIDEO descriptors: the lane grid is 21
# frames but feature correlations decay within ~±5 frames, so a true match
# whose offset falls mid-lane is invisible to a single-phase score map
# (found by the long mixed parity case - every other synthetic case used
# integer-second insertions that land exactly on lane centers). Max over
# 3-frame-spaced shifted copies keeps the residual misalignment <= 1.5
# frames (corr ~0.9), so off-grid TRUE matches compete head-on with
# exactly-repeating self-similar ridges that sit on-grid - at 3.5-frame
# granularity the randomized parity campaign still found draws where an
# on-grid fake outscored the off-grid truth (scripts/parity_campaign.py).
# The ±1.33 s fine band absorbs the residual.
SUB_LANE_SHIFTS = (0, 3, 6, 9, 12, 15, 18)


def _coarse_descriptors(ms, norms, mask, phase=0):
    """Normalized, masked window descriptors at COARSE_STRIDE (+ phase).

    ms, norms: (F, N) f32 (F = 3 or 5 streams); mask: (N,) bool (anchor
    eligibility). Returns (K, 128*ceil(F*41/128)) f32 with zero rows for
    invalid anchors (zero columns pad the width to a multiple of 128). K is
    independent of `phase` so shifted copies share one shape.
    """
    f = ms.shape[0]
    n = ms.shape[1]
    k = (n - WINDOW - max(SUB_LANE_SHIFTS)) // COARSE_STRIDE + 1
    starts = np.arange(k) * COARSE_STRIDE + phase
    idx = starts[:, None] + np.arange(WINDOW)[None, :]          # (K, 41)
    win = ms[:, idx]                                            # (F, K, 41)
    nrm = norms[:, starts]                                      # (F, K)
    desc = win / nrm[:, :, None]
    desc = desc * mask[starts][None, :, None]
    desc = jnp.moveaxis(desc, 0, 1).reshape(k, f * WINDOW)      # (K, F*41)
    width = -(-(f * WINDOW) // 128) * 128
    return jnp.pad(desc, ((0, 0), (0, width - f * WINDOW)))


COARSE_CHUNK = 64  # blocks per lax.map step: one (640, Kv) GEMM per shift


def _chunk_scores(desc_a_padded, desc_v_list, c):
    """Score tile for COARSE_CHUNK blocks starting at block c*COARSE_CHUNK.

    desc_a_padded: (nb_pad * COARSE_PER_BLOCK, 128) audio descriptors;
    returns (COARSE_CHUNK, Kv) f32. Shared by the materialized and the
    memory-bounded streamed coarse paths (identical arithmetic)."""
    kv = desc_v_list[0].shape[0]
    rows = jax.lax.dynamic_slice_in_dim(
        desc_a_padded, c * COARSE_CHUNK * COARSE_PER_BLOCK,
        COARSE_CHUNK * COARSE_PER_BLOCK, axis=0)
    out = None
    for desc_v in desc_v_list:   # sub-lane shifted copies, max-folded
        s = jnp.dot(rows, desc_v.T, precision=MATMUL_PRECISION,
                    preferred_element_type=jnp.float32)  # (640, Kv)
        s = s.reshape(COARSE_CHUNK, COARSE_PER_BLOCK, kv)
        s = jnp.pad(s, ((0, 0), (0, 0), (0, COARSE_PER_BLOCK)))
        aligned = jnp.max(jnp.stack(
            [s[:, p, p:p + kv] for p in range(COARSE_PER_BLOCK)],
            axis=1), axis=1)                         # (CHUNK, Kv)
        out = aligned if out is None else jnp.maximum(out, aligned)
    return out


def _block_scores_local(desc_a, desc_v_list):
    """Video-coordinate block score map P[b, v].

    P[b, v] = best descriptor-correlation sum matching any coarse row of
    audio block b against video coarse index (v + within-block phase).
    MAX over the phases is load-bearing: the video index keeps only every
    4th frame (reference 630) and rate mismatches sweep the fractional
    lane alignment through the block, so typically ONE phase carries the
    true match - averaging dilutes it below envelope self-similarity
    ridges (verified on the 3%-rate parity case). Ambiguity against such
    ridges is handled downstream by k-best tracking (_match_core runs the
    DP twice with the first track suppressed) + the far more selective
    fine-pass gates.

    Working in video coordinates (rather than offset space) halves the lane
    width and needs no scatter: the DP below re-labels lanes by shifting the
    nominal +10 advance per block instead.
    """
    if not isinstance(desc_v_list, (list, tuple)):
        desc_v_list = [desc_v_list]
    ka = desc_a.shape[0]
    kv = desc_v_list[0].shape[0]
    nb = ka // COARSE_PER_BLOCK
    nb_pad = -(-nb // COARSE_CHUNK) * COARSE_CHUNK
    desc_a = jnp.pad(desc_a,
                     ((0, nb_pad * COARSE_PER_BLOCK - ka), (0, 0)))
    p_map = jax.lax.map(lambda c: _chunk_scores(desc_a, desc_v_list, c),
                        jnp.arange(nb_pad // COARSE_CHUNK))
    return p_map.reshape(nb_pad, kv)[:nb]


def _dp_relax(prev, d):
    """One max-plus relaxation: shift by the nominal 10-lane advance, |.|
    distance transform (exact via two running cummax passes), capped by a
    flat jump. Shared by the materialized and streamed coarse DPs."""
    lanes = jnp.arange(d, dtype=jnp.float32)
    adv = COARSE_PER_BLOCK
    prev10 = jnp.concatenate(
        [jnp.full((adv,), -1e30, jnp.float32), prev[:-adv]])
    fwd = (jax.lax.cummax(prev10 + DP_SLOPE_COST * lanes)
           - DP_SLOPE_COST * lanes)
    bwd = (jnp.flip(jax.lax.cummax(jnp.flip(prev10 - DP_SLOPE_COST * lanes)))
           + DP_SLOPE_COST * lanes)
    return jnp.maximum(jnp.maximum(fwd, bwd),
                       jnp.max(prev) - DP_JUMP_COST)


def _dp_backstep(o_next, cost_prev, d):
    """One backtrace step: the predecessor lane of `o_next` given the
    previous block's cost row (move-vs-jump arbitration)."""
    adv = COARSE_PER_BLOCK
    moved = cost_prev - DP_SLOPE_COST * jnp.abs(
        jnp.arange(d, dtype=jnp.float32) - (o_next - adv).astype(jnp.float32))
    jumped = jnp.max(cost_prev) - DP_JUMP_COST
    return jnp.where(jnp.max(moved) >= jumped,
                     jnp.argmax(moved), jnp.argmax(cost_prev))


def _coarse_dp(p_map):
    """Monotone track DP over the video-coordinate block score map (exact
    max-plus). A path at constant audio/video offset advances 10 video
    lanes per block; deviations cost DP_SLOPE_COST per lane, capped by a
    flat DP_JUMP_COST for arbitrary jumps (content skips / start offsets).
    The |.| distance transform is exact via two running cummax passes.
    Returns (per-block video coarse index (B,) i32 via backtrace,
    the track's total score = max of the final cost row).
    """
    nb, d = p_map.shape

    def fwd_step(prev, p_row):
        cur = _dp_relax(prev, d) + p_row
        return cur, cur

    init = jnp.zeros((d,), jnp.float32)
    _, cost = jax.lax.scan(fwd_step, init, p_map,
                           unroll=DP_SCAN_UNROLL)               # (B, D)

    o_last = jnp.argmax(cost[-1])

    def back_step(o_next, cost_prev):
        o_prev = _dp_backstep(o_next, cost_prev, d)
        return o_prev, o_prev

    _, path = jax.lax.scan(back_step, o_last, cost[:-1], reverse=True,
                           unroll=DP_SCAN_UNROLL)
    return (jnp.concatenate([path, o_last[None]]).astype(jnp.int32),
            cost[-1][o_last])


# Device-memory guard for the coarse pass: above coarse_stream_elems()
# score-map elements (blocks x video lanes), _coarse_tracks switches from
# the materialized (B, D) score/cost tensors to the streamed DP below,
# which holds (C, D) checkpoints + (64, D) tiles instead - the reference
# aligns arbitrarily long media in bounded memory too
# (describealign.py:610-633 builds only per-frame dicts). The materialized
# program needs up to COARSE_BYTES_PER_ELEM bytes of scratch per element
# (XLA's memory_analysis of match_coarse on an H100, from
# scripts/dryrun_longmedia.py --memory: 17.58 at the 22-min bucket, 15.99
# at 1, 2 and 3 hours), so the limit is COARSE_MEM_SHARE of the memory
# JAX may use on the device over that; the rest stays for the fine pass
# and the batch's other pairs. With JAX's default pool on an 80 GB card
# that is ~911M elements: a 2-hour pair (523M) stays materialized, a
# 3-hour pair (1.17G) streams.
COARSE_BYTES_PER_ELEM = 17.5
COARSE_MEM_SHARE = 0.25
# the CPU backend reports no memory limit; there the limit is fixed
# (~3.4 GB of host scratch)
COARSE_STREAM_ELEMS_HOST = 192 * 1024 * 1024
# None derives the limit from the device; an int overrides it
COARSE_STREAM_ELEMS = None


def coarse_stream_elems():
    """Score-map elements above which the coarse DP streams."""
    if COARSE_STREAM_ELEMS is not None:
        return COARSE_STREAM_ELEMS
    return _device_stream_elems()


@lru_cache(maxsize=None)
def _device_stream_elems():
    dev = jax.local_devices()[0]
    stats = dev.memory_stats()
    if stats is None and dev.platform == 'cpu':
        return COARSE_STREAM_ELEMS_HOST
    if not stats or 'bytes_limit' not in stats:
        raise RuntimeError(f"{dev.device_kind} reports no memory limit; "
                           f"set matching.COARSE_STREAM_ELEMS")
    return int(stats['bytes_limit'] * COARSE_MEM_SHARE
               / COARSE_BYTES_PER_ELEM)


def _coarse_dp_streamed(desc_a, desc_v_list, nb, suppress_paths=()):
    """Memory-bounded twin of _block_scores_local + _coarse_dp.

    The score map is computed in COARSE_CHUNK-block tiles INSIDE the DP
    scans (never materialized whole), the forward pass checkpoints one
    cost row per chunk, and the backtrace recomputes each chunk's cost
    rows from its checkpoint (classic checkpointed-scan rematerialization:
    2x the score compute for O(B/64 * D) instead of O(B * D) memory).
    Identical relaxation/backtrace arithmetic to the materialized pair -
    tests assert path equality.

    suppress_paths: earlier k-best tracks' (B,) lane paths; lanes within
    SUPPRESS_LANES of them score -inf (the k-best rescue semantics).
    """
    ka = desc_a.shape[0]
    kv = desc_v_list[0].shape[0]
    d = kv
    nb_pad = -(-nb // COARSE_CHUNK) * COARSE_CHUNK
    n_chunks = nb_pad // COARSE_CHUNK
    desc_a_p = jnp.pad(desc_a,
                       ((0, nb_pad * COARSE_PER_BLOCK - ka), (0, 0)))
    lanes = jnp.arange(d, dtype=jnp.int32)[None, :]
    suppress_paths = [jnp.pad(p, (0, nb_pad - p.shape[0]), mode='edge')
                      for p in suppress_paths]

    def chunk_scores(c):
        s = _chunk_scores(desc_a_p, desc_v_list, c)          # (64, Kv)
        for vp in suppress_paths:
            vpc = jax.lax.dynamic_slice_in_dim(vp, c * COARSE_CHUNK,
                                               COARSE_CHUNK)
            s = jnp.where(jnp.abs(lanes - vpc[:, None]) <= SUPPRESS_LANES,
                          -1e30, s)
        return s

    def row_valid(c):
        return (c * COARSE_CHUNK
                + jnp.arange(COARSE_CHUNK, dtype=jnp.int32)) < nb

    def fwd_row(prev, inp):
        row, valid = inp
        # rows past nb pass the cost through unchanged, so the final carry
        # IS cost[nb-1] and argmax matches the materialized path exactly
        cur = jnp.where(valid, _dp_relax(prev, d) + row, prev)
        return cur, cur

    def fwd_chunk(prev, c):
        last, _ = jax.lax.scan(fwd_row, prev, (chunk_scores(c), row_valid(c)),
                               unroll=DP_SCAN_UNROLL)
        return last, prev                      # checkpoint: PRE-chunk row

    init = jnp.zeros((d,), jnp.float32)
    last_row, ckpts = jax.lax.scan(fwd_chunk, init,
                                   jnp.arange(n_chunks))     # (C, D)

    o_last = jnp.argmax(last_row).astype(jnp.int32)

    def bwd_row(o_next, inp):
        cost_b, step_valid = inp
        # step at block b consumes cost[b] and emits path[b]; blocks
        # >= nb-1 pass o_last through (the materialized backtrace starts
        # at block nb-1 with o_last)
        o_prev = _dp_backstep(o_next, cost_b, d).astype(jnp.int32)
        o_b = jnp.where(step_valid, o_prev, o_next)
        return o_b, o_b

    def bwd_chunk(o_carry, inp):
        c, ckpt = inp
        _, rows = jax.lax.scan(fwd_row, ckpt,
                               (chunk_scores(c), row_valid(c)),
                               unroll=DP_SCAN_UNROLL)            # (64, D)
        flags = (c * COARSE_CHUNK
                 + jnp.arange(COARSE_CHUNK, dtype=jnp.int32)) < (nb - 1)
        o_first, path_chunk = jax.lax.scan(bwd_row, o_carry, (rows, flags),
                                           reverse=True,
                                           unroll=DP_SCAN_UNROLL)
        return o_first, path_chunk

    _, path_chunks = jax.lax.scan(bwd_chunk, o_last,
                                  (jnp.arange(n_chunks), ckpts),
                                  reverse=True)
    return (path_chunks.reshape(nb_pad)[:nb].astype(jnp.int32),
            last_row[o_last])


# ---------------------------------------------------------------------------
# Fine pass
# ---------------------------------------------------------------------------

def _fine_block(ms_a, norms_a, ms_v, norms_v, a_mask, v_mask,
                b, start):
    """Candidates for one 210-frame audio block whose video search band
    begins at `start` (precomputed, clipped).

    Returns (quals (BLOCK, TOP_K), offs (BLOCK, TOP_K) int16 band offsets;
    video frame = start + off). qual == 0 marks an invalid slot.
    """
    a0 = b * BLOCK

    a_win = _windows(ms_a, a0, BLOCK)                # (5, 210, 41)
    v_win = _windows(ms_v, start, FINE_W)            # (5, 768, 41)
    dots = jnp.einsum('fld,fed->fle', a_win, v_win,
                      precision=MATMUL_PRECISION,
                      preferred_element_type=jnp.float32)  # (5, 210, 768)

    na = jax.lax.dynamic_slice_in_dim(norms_a, a0, BLOCK, axis=1)
    nv = jax.lax.dynamic_slice_in_dim(norms_v, start, FINE_W, axis=1)
    corr = dots / (na[:, :, None] * nv[:, None, :])

    one_m = jnp.maximum(1e-8, 1.0 - corr[:3])        # reference 668
    prob = jnp.prod(one_m, axis=0) ** NB_EXPONENT    # reference 669
    band_ok = jnp.maximum(corr[3], corr[4]) >= BAND_GATE
    qual = jnp.minimum(QUAL_MAX, (prob / QUAL_SCALE) ** (-1.0 / 3))

    l_idx = jnp.arange(BLOCK)[:, None]
    e_idx = jnp.arange(FINE_W)[None, :]
    in_band = (e_idx >= l_idx) & (e_idx <= l_idx + 2 * FINE_HALF_BAND)
    am = jax.lax.dynamic_slice_in_dim(a_mask, a0, BLOCK)
    vm = jax.lax.dynamic_slice_in_dim(v_mask, start, FINE_W)
    valid = (in_band & am[:, None] & vm[None, :]
             & (prob <= QUAL_PROB_CUTOFF) & band_ok)
    qual = jnp.where(valid, qual, 0.0)

    top_q, top_e = jax.lax.top_k(qual, TOP_K)         # (210, K)
    return top_q, top_e.astype(jnp.int16)


# ---------------------------------------------------------------------------
# Full matcher
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=())
def extract_and_match(pcm_a_i16, len_a, pcm_v_i16, len_v):
    """Fused device pipeline: int16 PCM -> features -> preprocess -> match.

    pcm_*_i16: (C, S_pad) int16 (uploads at half the f32 size);
    len_*: true 210fps frame counts. The int16 -> float16-grid -> f32 cast
    happens on device, matching the reference's storage dtype exactly.

    Returns (quals (B, 210, K), offs (B, 210, K) int16 band offsets,
    starts (B,) int32 band starts, feats_a (5, Npad), feats_v) - the
    stacked raw features come back for the host-side refinement stages, one
    D2H transfer of a few MB.
    """
    from ..ops import features as F
    from .preprocess import preprocess_features

    def feats_of(pcm_i16):
        pcm = pcm_i16.astype(jnp.float16).astype(jnp.float32)
        fs = (F.energy_feature(pcm), F.zero_crossing_feature(pcm)) \
            + tuple(F.freq_band_features(pcm))
        n = pcm.shape[1] // 210
        return jnp.stack([f[:n] for f in fs], axis=0)

    feats_a = feats_of(pcm_a_i16)
    feats_v = feats_of(pcm_v_i16)
    # zero the padding tail so masks/norms see silence, not boundary smear
    idx_a = jnp.arange(feats_a.shape[1])[None, :]
    idx_v = jnp.arange(feats_v.shape[1])[None, :]
    feats_a = jnp.where(idx_a < len_a, feats_a, 0.0)
    feats_v = jnp.where(idx_v < len_v, feats_v, 0.0)
    ms_a, norms_a = preprocess_features(feats_a)
    ms_v, norms_v = preprocess_features(feats_v)
    quals, offs, starts, centers, margin = _match_core(
        ms_a, norms_a, feats_a[0], len_a,
        ms_v, norms_v, feats_v[0], len_v)
    return quals, offs, starts, feats_a, feats_v, margin


@partial(jax.jit, static_argnames=('nf',))
def match_from_features(feats_a, len_a, feats_v, len_v, nf=None):
    """Host-feature fast path: stacked raw features in, compressed
    candidates out.

    nf (static): coarse descriptor stream count override - the
    low-confidence retry re-invokes this entry with
    nf=COARSE_RETRY_STREAMS (compiles once per shape bucket; the retry
    path is rare so the extra program is never in the hot set).

    feats_*: (5, Npad) feature stacks (extracted on the host - ~40x
    smaller uploads than PCM; callers ship f16, halving H2D bytes - the
    cast back to f32 happens here, and the ~5e-4 relative rounding on the
    log-compressed feature values is validated against the executed
    reference by the parity campaign); len_*: true frame counts. Returns
    (quals (B, 210, K) f16, offs (B, 210, K) int16 band offsets,
    starts (B,) int32); video frame = starts[b] + off. The f16 qualities
    and int16 offsets cut the D2H transfer 2.7x; f16 keeps ~3 decimal
    digits of a quality bounded at 50, well inside the formula's own
    tolerance (the LIS only consumes relative quality sums).
    """
    from .preprocess import preprocess_features
    feats_a = feats_a.astype(jnp.float32)
    feats_v = feats_v.astype(jnp.float32)
    ms_a, norms_a = preprocess_features(feats_a)
    ms_v, norms_v = preprocess_features(feats_v)
    quals, offs, starts, _, margin = _match_core(
        ms_a, norms_a, feats_a[0], len_a,
        ms_v, norms_v, feats_v[0], len_v, nf=nf)
    # same u8 transport grid as the streamed chunks, returned as the
    # decoded f16 values: both paths feed the LIS bit-identical qualities
    return (_qual_dequantize_f16(_qual_quantize_u8(quals)), offs, starts,
            margin)


# --- quality transport grid --------------------------------------------------
# Qualities cross the link on a 6-bit-truncated f16 grid addressed by one
# byte: code = ((f16_bits + 0x20) >> 6) - 0xA0, value bits = (code+0xA0)<<6.
# Pure bit arithmetic, so the device quantizer, the C++ stream decoder, and
# the f16 values the single-shot path returns agree bit-for-bit on every
# backend (no transcendentals). The grid spans (0.033, 50] with <=1.6%
# relative step - the quality formula's gate floor is 0.0464 and the LIS
# consumes relative quality sums, so the step is far inside the decision
# noise (validated by the reference parity campaign). Code 0 = empty slot.
QUAL_CODE_BASE = 0xA0


def _qual_quantize_u8(quals_f32):
    bits = jax.lax.bitcast_convert_type(
        quals_f32.astype(jnp.float16), jnp.uint16).astype(jnp.int32)
    code = jnp.clip(((bits + 0x20) >> 6) - QUAL_CODE_BASE, 0, 255)
    # guard: only positive finite qualities may produce a code - a negative
    # or NaN f16 bit pattern is >= 0x8000 and would otherwise clip to 255
    # (decoded as maximum quality). Unreachable today (_fine_block clamps
    # qual to [0, 50] and zeroes invalid slots) but cheap insurance against
    # future quality-formula changes.
    code = jnp.where(quals_f32 > 0, code, 0)
    return code.astype(jnp.uint8)


def _qual_dequantize_f16(code_u8):
    code = code_u8.astype(jnp.int32)
    bits = jnp.where(code > 0, (code + QUAL_CODE_BASE) << 6, 0)
    return jax.lax.bitcast_convert_type(bits.astype(jnp.uint16),
                                        jnp.float16)


# --- streaming (chunked) matcher --------------------------------------------
# The fine pass is split into fixed-size block chunks so the host can pull
# chunk i's candidates (D2H) and run the LIS on them while chunks i+1..C
# are still computing on the device: the serial compute -> one big D2H ->
# LIS chain becomes ~max(compute, transfer, LIS).

FINE_CHUNK = 256  # blocks (seconds of audio) per streamed fine chunk


def _match_coarse_impl(feats_a, len_a, feats_v, len_v):
    from .preprocess import preprocess_features
    feats_a = feats_a.astype(jnp.float32)
    feats_v = feats_v.astype(jnp.float32)
    ms_a, norms_a = preprocess_features(feats_a)
    ms_v, norms_v = preprocess_features(feats_v)
    a_mask, v_mask, starts_tracks, _, margin = _coarse_tracks(
        ms_a, norms_a, feats_a[0], len_a, ms_v, norms_v, feats_v[0], len_v)
    nb = starts_tracks.shape[1]
    b_pad = -(-nb // FINE_CHUNK) * FINE_CHUNK
    starts_tracks = jnp.pad(starts_tracks, ((0, 0), (0, b_pad - nb)),
                            mode='edge')
    return ms_a, norms_a, a_mask, ms_v, norms_v, v_mask, starts_tracks, margin


@partial(jax.jit, static_argnames=())
def match_coarse(feats_a, len_a, feats_v, len_v):
    """Preprocess + coarse k-best tracks; the device-resident first half of
    the streaming matcher.

    Returns (ms_a, norms_a, a_mask, ms_v, norms_v, v_mask) device state for
    match_fine_chunk plus starts_tracks (T, B_pad) i32, padded to a
    FINE_CHUNK multiple (padding repeats the last block's starts; padded
    blocks emit zero quals).
    """
    return _match_coarse_impl(feats_a, len_a, feats_v, len_v)


@partial(jax.jit, static_argnames=())
def match_coarse_pair(feats_av, len_a, len_v):
    """match_coarse on a combined (2, 5, Npad) upload ([0] = audio/
    description features, [1] = video): the batch path ships BOTH streams
    as one device_put, one fixed per-transfer cost per pair instead of
    two."""
    return _match_coarse_impl(feats_av[0], len_a, feats_av[1], len_v)


@partial(jax.jit, static_argnames=())
def match_fine_chunk(ms_a, norms_a, a_mask, ms_v, norms_v, v_mask,
                     starts_tracks, b0, nb_valid):
    """Fine pass + rescue gating for FINE_CHUNK blocks starting at traced
    block index b0. starts_tracks: the full (T, B_pad) device array from
    match_coarse - the chunk's slice is taken ON DEVICE so no host sync
    sits between the coarse call and the chunk dispatches. Returns
    (quals (C, 210, G*K) f16, offs (C, 210, G*K) i16)."""
    starts_chunk = jax.lax.dynamic_slice_in_dim(starts_tracks, b0,
                                                FINE_CHUNK, axis=1)
    quals, offs, _ = _fine_tracks(ms_a, norms_a, a_mask,
                                  ms_v, norms_v, v_mask,
                                  starts_chunk, b0, FINE_CHUNK, nb_valid)
    # ONE flat buffer per chunk (each pull has a fixed cost), in
    # the split layout: band-1 slots at full frame rate, rescue slots for
    # EVEN frames only (odd frames are zero by construction - the rescue
    # bands sample every 2nd frame). Each slot crosses as ONE u8 quality
    # code plus a 10-bit offset (low byte + 2 packed high bits): the
    # in-band offsets span [0, 767], so i16 transport wasted 6 bits per
    # slot - the packed layout cuts the candidate payload another 23%.
    band1 = _pack_slots(quals[:, :, :TOP_K], offs[:, :, :TOP_K])
    rescue = _pack_slots(quals[:, ::2, TOP_K:], offs[:, ::2, TOP_K:])
    return jnp.concatenate([band1, rescue], axis=1)


def _pack_slots(q, o):
    """(C, rows, k) qualities/offsets -> (C, rows * words) int16 transport
    words: k u8 codes, k u8 offset low bytes, then k/4 high-bit bytes
    (2 bits per slot, slot j in byte j//4 at bit 2*(j%4)) padded to an
    even byte count. Mirrored by dp.cpp lis_stream_feed_packed and
    api._unpack_chunk."""
    c, rows, k = q.shape
    codes16 = jax.lax.bitcast_convert_type(
        _qual_quantize_u8(q).reshape(c, rows, k // 2, 2), jnp.int16)
    o = o.astype(jnp.int32)
    lo16 = jax.lax.bitcast_convert_type(
        (o & 255).astype(jnp.uint8).reshape(c, rows, k // 2, 2), jnp.int16)
    shifts = jnp.array([1, 4, 16, 64], jnp.int32)       # 1 << (2*(j%4))
    hi_b = jnp.sum(((o >> 8) & 3).reshape(c, rows, k // 4, 4) * shifts,
                   axis=3).astype(jnp.uint8)            # (C, rows, k/4)
    if hi_b.shape[2] % 2:
        hi_b = jnp.pad(hi_b, ((0, 0), (0, 0), (0, 1)))
    hi16 = jax.lax.bitcast_convert_type(
        hi_b.reshape(c, rows, hi_b.shape[2] // 2, 2), jnp.int16)
    return jnp.concatenate([codes16, lo16, hi16], axis=2).reshape(c, -1)


# --- coarse-confidence margin transport --------------------------------
# The k-best coarse margin (see _coarse_tracks) rides inside the existing
# per-pair buffers so surfacing it costs ZERO extra transfers:
# dense transports carry it as one f16 word (+1 pad word) between the
# packed rows and the trailing starts words; compact transports carry a
# u8 code in header byte 1. Calibration (scripts/diag_confidence.py,
# 128 draws over 8 profiles): wrong coarse tracks score 0.007-0.029,
# correct ones 0.056+ (clean profiles 0.115+), so 0.04 splits them with
# ~1.4x headroom both ways.
COARSE_MARGIN_FLOOR = 0.04


def _margin_code_u8(margin):
    """f32 margin -> u8 transport code: 0 = absent (never emitted by the
    device), 255 = +inf or >= 0.508, else 1 + round(margin * 500)."""
    code = jnp.clip(jnp.round(margin * 500.0), 0, 254) + 1
    return jnp.where(jnp.isfinite(margin), code, 255).astype(jnp.uint8)


def margin_from_code(code):
    """Host decoder of _margin_code_u8 (None when absent)."""
    code = int(code)
    if code == 0:
        return None
    return float('inf') if code == 255 else (code - 1) / 500.0


def _margin_words_i16(margin, rows):
    """(rows, 2) int16 column pair: [bitcast f16 margin, 0] per row."""
    m16 = jax.lax.bitcast_convert_type(margin.astype(jnp.float16),
                                       jnp.int16)
    return jnp.concatenate(
        [jnp.broadcast_to(m16, (rows, 1)), jnp.zeros((rows, 1), jnp.int16)],
        axis=1)


def margin_from_i16(word):
    """Host decoder of _margin_words_i16's f16 word."""
    return float(np.array(word, np.int16).view(np.float16))


@jax.jit
def concat_chunks_with_starts(chunks, starts_tracks, margin):
    """Batch transport: the streamed chunks concatenated along blocks with
    the coarse margin (one f16 word + one pad word) and each block's band
    starts bitcast into 2*T trailing int16 words per row - ONE
    (B_pad, W + 2 + 2*T) buffer, so the batch path makes a single D2H
    transfer per pair. Split back by api's batch consumer.
    """
    packed = jnp.concatenate(chunks, axis=0)            # (nb, W)
    st16 = jax.lax.bitcast_convert_type(
        jnp.transpose(starts_tracks).astype(jnp.int32),
        jnp.int16)                                      # (B_pad, T, 2)
    # chunks may have been trimmed to the true block count (all-zero
    # padding rows dropped before the pull); starts rows follow suit
    st16 = st16[:packed.shape[0]]
    return jnp.concatenate(
        [packed, _margin_words_i16(margin, packed.shape[0]),
         st16.reshape(st16.shape[0], -1)], axis=1)


# --- compacted batch transport ------------------------------------------
# Dense transport ships every top-K slot; measured live-slot occupancy on
# matched content is ~48-89% band-1 / ~63-94% rescue (zeros are a SUFFIX
# per frame: top_k orders by quality and the u8 grid floor sits below the
# gate floor, so dead slots quantize to code 0 and live ones never do).
# The pair-level compact layout ships per-frame counts + the live prefix
# only, with ALL six live planes packed back-to-back from the start of a
# dense-max-sized live region (section bases are device-computed from the
# live totals):
#   [0:4]      reserved header (always 0)
#   [4:4+F]    per-frame counts, c1 | c2 << 4   (F = nb*210 frames)
#   [.. +4*T*nb] band starts, (nb, T) i32 bytes
#   [live region, LIVE_MAX bytes; only the first total(t1, t2) occupied]:
#     codes1[t1] @0 | lo1[t1] @t1a | hi1[t1/4] @2*t1a |
#     codes2[t2] @2.25*t1a | lo2[t2] | hi2[t2/4]      (t?a = ceil128(t?))
# 2-bit offset highs pack 4 compacted slots per byte. The consumer pulls
# the fixed region first, recomputes (t1, t2) from the counts, then pulls
# exactly the occupied live bytes - occupancy-exact transfers with NO
# budget to overflow (an early round-4 budgeted variant double-paid a
# dense fallback on ~half the bench pairs; this layout replaced it).
_C2_DROP = np.int32(1 << 30)   # scatter index for dead slots (mode='drop')


def _ceil_mult(x, m):
    return ((x + m - 1) // m) * m


def _compact2_maxes(nb, k2):
    t1m = _ceil_mult(nb * 210 * TOP_K, 128)
    t2m = _ceil_mult(nb * 105 * k2, 128)
    live_max = 2 * t1m + t1m // 4 + 2 * t2m + t2m // 4
    return t1m, t2m, live_max


def _compact2_live(packed, k2):
    """(nb, W) int16 transport rows -> (counts u8 (nb*210,), live u8
    (LIVE_MAX,)): all live-prefix planes scattered back-to-back from byte
    0 of the live region at bases computed on-device from the live totals
    (the host twin is compact2_live_offsets)."""
    nb = packed.shape[0]
    k1 = TOP_K
    row1 = _packed_row_words_py(k1)
    row2 = _packed_row_words_py(k2)
    by = jax.lax.bitcast_convert_type(packed, jnp.uint8)  # (nb, W, 2)
    by = by.reshape(nb, -1)
    band1 = by[:, :210 * row1 * 2].reshape(nb * 210, row1 * 2)
    rescue = by[:, 210 * row1 * 2:210 * row1 * 2 + 105 * row2 * 2]
    rescue = rescue.reshape(nb * 105, row2 * 2)
    c1p, l1p, h1p = _unpack_rows_u8(band1, k1)
    c2p, l2p, h2p = _unpack_rows_u8(rescue, k2)
    t1m, t2m, live_max = _compact2_maxes(nb, k2)

    def plane_pos(codes, k):
        counts = jnp.sum((codes != 0).astype(jnp.int32), axis=1)
        base = jnp.cumsum(counts) - counts                  # exclusive
        total = base[-1] + counts[-1]
        j = jnp.arange(k, dtype=jnp.int32)[None, :]
        pos = jnp.where(j < counts[:, None], base[:, None] + j,
                        _C2_DROP).ravel()
        return counts, pos, total

    cnt1, pos1, t1 = plane_pos(c1p, k1)
    cnt2, pos2, t2 = plane_pos(c2p, k2)
    t1a = ((t1 + 127) // 128) * 128
    t2a = ((t2 + 127) // 128) * 128
    o_l1 = t1a
    o_h1 = 2 * t1a
    o_c2 = 2 * t1a + t1a // 4
    o_l2 = o_c2 + t2a
    o_h2 = o_c2 + 2 * t2a

    def hi_bytes(pos, hi2bit, tm):
        # pack 2-bit highs by SLOT index (byte p//4, bit 2*(p%4)) into a
        # max-size u32 plane; dead slots land at _C2_DROP >> 2 (dropped)
        return jnp.zeros((tm // 4,), jnp.uint32).at[pos >> 2].add(
            hi2bit.ravel().astype(jnp.uint32)
            << (2 * (pos & 3)).astype(jnp.uint32),
            mode='drop').astype(jnp.uint8)

    hw1 = hi_bytes(pos1, h1p, t1m)
    hw2 = hi_bytes(pos2, h2p, t2m)
    out = jnp.zeros((live_max,), jnp.uint8)
    out = out.at[pos1].set(c1p.ravel(), mode='drop')
    out = out.at[o_l1 + pos1].set(l1p.ravel(), mode='drop')
    out = out.at[o_c2 + pos2].set(c2p.ravel(), mode='drop')
    out = out.at[o_l2 + pos2].set(l2p.ravel(), mode='drop')
    # hi planes: scatter only the bytes inside their aligned sections
    # (a full-plane dynamic_update_slice would clobber the next section
    # with the dead-suffix zeros)
    b1 = jnp.arange(t1m // 4, dtype=jnp.int32)
    out = out.at[jnp.where(b1 < t1a // 4, o_h1 + b1, _C2_DROP)].set(
        hw1, mode='drop')
    b2 = jnp.arange(t2m // 4, dtype=jnp.int32)
    out = out.at[jnp.where(b2 < t2a // 4, o_h2 + b2, _C2_DROP)].set(
        hw2, mode='drop')

    cnt1 = cnt1.reshape(nb, 210)
    cnt2_full = jnp.zeros((nb, 210), jnp.int32).at[:, ::2].set(
        cnt2.reshape(nb, 105))
    counts = (cnt1 | (cnt2_full << 4)).astype(jnp.uint8).ravel()
    totals = jnp.stack([t1, t2]).astype(jnp.int32)
    return counts, out, totals


def _compact_planes(codes, lo, hi2, budget):
    """(rows, k) u8 planes -> (codes[budget], lo[budget], hi[budget//4],
    total) with live-prefix slots packed densely across rows."""
    rows, k = codes.shape
    counts = jnp.sum((codes != 0).astype(jnp.int32), axis=1)   # (rows,)
    base = jnp.cumsum(counts) - counts                          # exclusive
    total = base[-1] + counts[-1]
    j = jnp.arange(k, dtype=jnp.int32)[None, :]
    valid = j < counts[:, None]
    pos = base[:, None] + j                                     # (rows, k)
    pos = jnp.where(valid, pos, budget + 1).ravel()             # drop dead
    out_c = jnp.zeros((budget,), jnp.uint8).at[pos].set(
        codes.ravel(), mode='drop')
    out_l = jnp.zeros((budget,), jnp.uint8).at[pos].set(
        lo.ravel(), mode='drop')
    shift = (2 * (pos & 3)).astype(jnp.uint32)
    out_h = jnp.zeros((budget // 4,), jnp.uint32).at[pos >> 2].add(
        jnp.where(pos <= budget, hi2.ravel().astype(jnp.uint32), 0)
        << shift, mode='drop').astype(jnp.uint8)
    return out_c, out_l, out_h, total


def _unpack_rows_u8(packed_u8, k):
    """(rows, row_bytes) u8 -> (codes, lo, hi2) planes, (rows, k) each."""
    codes = packed_u8[:, :k]
    lo = packed_u8[:, k:2 * k]
    hi_b = packed_u8[:, 2 * k:2 * k + (k + 3) // 4]
    j = jnp.arange(k, dtype=jnp.int32)
    hi2 = (hi_b[:, j // 4].astype(jnp.int32) >> (2 * (j % 4))) & 3
    return codes, lo, hi2.astype(jnp.uint8)


def _compact_sections(packed, k2, b1, b2):
    """Shared compact-plane builder: (nb, W) int16 transport rows ->
    [header(4), counts(nb*210), codes1, lo1, hi1, codes2, lo2, hi2]
    section list (live-prefix planes at the given budgets, overflow flag
    in header byte 0)."""
    nb = packed.shape[0]
    k1 = TOP_K
    row1 = _packed_row_words_py(k1)
    row2 = _packed_row_words_py(k2)
    by = jax.lax.bitcast_convert_type(packed, jnp.uint8)  # (nb, W, 2)
    by = by.reshape(nb, -1)
    band1 = by[:, :210 * row1 * 2].reshape(nb * 210, row1 * 2)
    rescue = by[:, 210 * row1 * 2:210 * row1 * 2 + 105 * row2 * 2]
    rescue = rescue.reshape(nb * 105, row2 * 2)
    c1p, l1p, h1p = _unpack_rows_u8(band1, k1)
    c2p, l2p, h2p = _unpack_rows_u8(rescue, k2)
    oc1, ol1, oh1, t1 = _compact_planes(c1p, l1p, h1p, b1)
    oc2, ol2, oh2, t2 = _compact_planes(c2p, l2p, h2p, b2)

    cnt1 = jnp.sum((c1p != 0).astype(jnp.int32), axis=1).reshape(nb, 210)
    cnt2 = jnp.sum((c2p != 0).astype(jnp.int32), axis=1).reshape(nb, 105)
    cnt2_full = jnp.zeros((nb, 210), jnp.int32).at[:, ::2].set(cnt2)
    counts = (cnt1 | (cnt2_full << 4)).astype(jnp.uint8).ravel()

    flag = ((t1 > b1) | (t2 > b2)).astype(jnp.uint8)
    header = jnp.zeros((4,), jnp.uint8).at[0].set(flag)
    return [header, counts, oc1, ol1, oh1, oc2, ol2, oh2]


@jax.jit
def concat_chunks_compact(chunks, starts_tracks, margin):
    """Batch transport, compacted: one (L,) u8 buffer per pair (see the
    layout above; header byte 1 carries the coarse-margin u8 code) plus a
    (2,) i32 live-totals array. Same candidate content as
    concat_chunks_with_starts; the consumer sizes an occupancy-exact
    prefix slice [0:fixed_end+ceil(live)] from the totals (a ~32 B pull
    that costs one small transfer and no extra device program) and pulls
    counts + starts + occupied live bytes in ONE transfer."""
    packed = jnp.concatenate(chunks, axis=0)            # (nb, W) int16
    nb = packed.shape[0]
    k2 = (starts_tracks.shape[0] - 1) * (TOP_K // 2)
    counts, live, totals = _compact2_live(packed, k2)
    st_u8 = jax.lax.bitcast_convert_type(
        jnp.transpose(starts_tracks[:, :nb]).astype(jnp.int32),
        jnp.uint8).reshape(-1)                          # nb*T*4
    header = jnp.zeros((4,), jnp.uint8).at[1].set(_margin_code_u8(margin))
    return jnp.concatenate([header, counts, st_u8, live]), totals


# Per-chunk budgets for the single-pair streamed path: one 256-block
# chunk's occupancy varies more than a whole pair's (the quiet lead-in
# pulls the pair-wide average down, while a fully matched chunk sits near
# the matched-region occupancy), so the band-1 budget is provisioned
# higher; overflow still falls back to the dense chunk per chunk.
COMPACT_CHUNK_BUDGET1 = 0.75
COMPACT_CHUNK_BUDGET2 = 0.95


def _compact_chunk_budgets(nb):
    b1 = -(-int(nb * 210 * TOP_K * COMPACT_CHUNK_BUDGET1) // 128) * 128
    b2 = -(-int(nb * 105 * (TOP_K // 2) * COMPACT_CHUNK_BUDGET2)
           // 128) * 128
    return b1, b2


@partial(jax.jit, static_argnames=('k2',))
def compact_chunk(chunk, k2):
    """Streaming transport, compacted: one (L,) u8 buffer per fine chunk
    (layout of compact_chunk_layout - no starts section; the streaming
    consumer already pulls the coarse starts separately). Same candidate
    content as the dense chunk whenever the overflow flag is 0."""
    b1, b2 = _compact_chunk_budgets(chunk.shape[0])
    return jnp.concatenate(_compact_sections(chunk, k2, b1, b2))


def compact_chunk_layout(nb):
    """Byte offsets of compact_chunk's sections for an nb-block chunk."""
    b1, b2 = _compact_chunk_budgets(nb)
    off = {}
    p = 4
    off['counts'] = (p, p + nb * 210)
    p += nb * 210
    for name, b in (('codes1', b1), ('lo1', b1), ('hi1', b1 // 4),
                    ('codes2', b2), ('lo2', b2), ('hi2', b2 // 4)):
        off[name] = (p, p + b)
        p += b
    off['total'] = p
    off['b1'], off['b2'] = b1, b2
    return off


def _packed_row_words_py(k):
    return k // 2 + k // 2 + (k // 4 + 1) // 2


def compact_layout(nb, n_tracks):
    """Fixed-region byte offsets + live-region geometry of the pair-level
    compact transport: counts/starts slices, the live region's start
    ('live' == 'fixed_end'), its static max size, and the pull-size
    quantization step (bounds the number of distinct eager slice programs
    per shape bucket to <=17)."""
    k2 = (n_tracks - 1) * (TOP_K // 2)
    t1m, t2m, live_max = _compact2_maxes(nb, k2)
    off = {}
    p = 4
    off['counts'] = (p, p + nb * 210)
    p += nb * 210
    off['starts'] = (p, p + nb * n_tracks * 4)
    p += nb * n_tracks * 4
    off['live'] = off['fixed_end'] = p
    off['live_max'] = live_max
    off['total'] = p + live_max
    off['step'] = _ceil_mult(live_max // 16, 128)
    return off


def compact2_live_offsets(t1, t2):
    """Host twin of _compact2_live's device section bases: byte ranges of
    the six live planes RELATIVE to the live region start, for live
    totals (t1, t2) recomputed from the counts section."""
    t1a = _ceil_mult(t1, 128)
    t2a = _ceil_mult(t2, 128)
    base2 = 2 * t1a + t1a // 4
    return {
        'codes1': (0, t1),
        'lo1': (t1a, t1a + t1),
        'hi1': (2 * t1a, 2 * t1a + (t1 + 3) // 4),
        'codes2': (base2, base2 + t2),
        'lo2': (base2 + t2a, base2 + t2a + t2),
        'hi2': (base2 + 2 * t2a, base2 + 2 * t2a + (t2 + 3) // 4),
        'total': base2 + 2 * t2a + t2a // 4,
    }


def _match_pair_fused(feats_av, len_a, len_v):
    """Coarse + EVERY fine chunk in one traced program: the fine chunks run
    as a lax.scan over block offsets (per-step intermediates are freed, the
    packed transport rows stack into the scan output), so the whole
    matcher costs ONE dispatch instead of 1 + n_chunks. The batch path
    pulls a single buffer per pair anyway - chunk-level dispatch only buys
    latency overlap, which batch mode gets from cross-pair pipelining -
    while each dispatch costs host CPU. Returns (packed (nb, W) i16 rows, starts_tracks (T, B_pad),
    margin f32 scalar)."""
    state = _match_coarse_impl(feats_av[0], len_a, feats_av[1], len_v)
    (ms_a, norms_a, a_mask, ms_v, norms_v, v_mask, starts_tracks,
     margin) = state
    b_pad = starts_tracks.shape[1]
    n_chunks = b_pad // FINE_CHUNK
    nb = nb_for(feats_av.shape[2])

    def step(_, b0):
        starts_chunk = jax.lax.dynamic_slice_in_dim(starts_tracks, b0,
                                                    FINE_CHUNK, axis=1)
        quals, offs, _ = _fine_tracks(ms_a, norms_a, a_mask,
                                      ms_v, norms_v, v_mask,
                                      starts_chunk, b0, FINE_CHUNK,
                                      jnp.int32(nb))
        band1 = _pack_slots(quals[:, :, :TOP_K], offs[:, :, :TOP_K])
        rescue = _pack_slots(quals[:, ::2, TOP_K:], offs[:, ::2, TOP_K:])
        return None, jnp.concatenate([band1, rescue], axis=1)

    _, packed = jax.lax.scan(
        step, None, jnp.arange(n_chunks, dtype=jnp.int32) * FINE_CHUNK)
    packed = packed.reshape(n_chunks * FINE_CHUNK, -1)[:nb]
    return packed, starts_tracks, margin


@partial(jax.jit, static_argnames=())
def match_pair_combo(feats_av, len_a, len_v):
    """ONE-dispatch batch transport, dense: the fused matcher's packed rows
    with the margin words + band starts bitcast into trailing int16 words
    per row (same layout as concat_chunks_with_starts)."""
    packed, starts_tracks, margin = _match_pair_fused(feats_av, len_a, len_v)
    st16 = jax.lax.bitcast_convert_type(
        jnp.transpose(starts_tracks).astype(jnp.int32),
        jnp.int16)[:packed.shape[0]]
    return jnp.concatenate(
        [packed, _margin_words_i16(margin, packed.shape[0]),
         st16.reshape(st16.shape[0], -1)], axis=1)


@partial(jax.jit, static_argnames=())
def match_pair_compact(feats_av, len_a, len_v):
    """ONE-dispatch batch transport, compacted (layout of compact_layout;
    byte-identical buffer to concat_chunks_compact on the chunked
    dispatch path - CI-enforced), plus the (2,) i32 live totals."""
    packed, starts_tracks, margin = _match_pair_fused(feats_av, len_a, len_v)
    k2 = (starts_tracks.shape[0] - 1) * (TOP_K // 2)
    counts, live, totals = _compact2_live(packed, k2)
    st_u8 = jax.lax.bitcast_convert_type(
        jnp.transpose(starts_tracks[:, :packed.shape[0]]).astype(jnp.int32),
        jnp.uint8).reshape(-1)
    header = jnp.zeros((4,), jnp.uint8).at[1].set(_margin_code_u8(margin))
    return jnp.concatenate([header, counts, st_u8, live]), totals


def match_stream(dev_a, len_a, dev_v, len_v):
    """Dispatch the full streaming matcher. Returns (chunk_outputs,
    starts_tracks_dev (T, B_pad) device array, n_chunks, margin_dev f32
    scalar); chunk_outputs is a list of async device (quals, offs) pairs
    in audio order. Everything is dispatched without a single host sync -
    the caller pulls results."""
    state = match_coarse(dev_a, len_a, dev_v, len_v)
    return _dispatch_stream(state, dev_a.shape[1])


def match_stream_pair(dev_av, len_a, len_v):
    """match_stream off one combined (2, 5, Npad) upload (see
    match_coarse_pair)."""
    state = match_coarse_pair(dev_av, len_a, len_v)
    return _dispatch_stream(state, dev_av.shape[2])


def _dispatch_stream(state, npad):
    starts_tracks = state[6]                          # (T, B_pad) on device
    b_pad = starts_tracks.shape[1]
    if b_pad % FINE_CHUNK != 0:
        # a cached coarse trace from a different FINE_CHUNK (tests patch
        # it) would silently drop blocks; fail loudly instead
        raise RuntimeError(
            f"coarse padding {b_pad} is not a multiple of "
            f"FINE_CHUNK={FINE_CHUNK} (stale jit trace?)")
    n_chunks = b_pad // FINE_CHUNK
    nb = nb_for(npad)
    chunks = []
    for c in range(n_chunks):
        chunk = match_fine_chunk(
            state[0], state[1], state[2], state[3], state[4], state[5],
            starts_tracks, jnp.int32(c * FINE_CHUNK), jnp.int32(nb))
        # blocks >= nb are chunk padding and emit all-zero rows (see
        # match_fine_chunk's nb_valid gate); trim them on device so the
        # D2H pull ships only real blocks - up to FINE_CHUNK-1 rows
        # (~10% of the payload at 27-min scale) for free. `nb` is static
        # per shape bucket, so the slice is one cached compile.
        rows = min(FINE_CHUNK, nb - c * FINE_CHUNK)
        if rows < FINE_CHUNK:
            chunk = _trim_rows(chunk, rows)
        chunks.append(chunk)
    return chunks, starts_tracks, n_chunks, state[7]


@partial(jax.jit, static_argnames=('rows',))
def _trim_rows(chunk, rows):
    return chunk[:rows]


def _abs_vids(offs, starts):
    """(B, 210, G*K) absolute video frames from grouped band starts."""
    k_per_group = offs.shape[2] // starts.shape[1]
    slot_starts = jnp.repeat(starts, k_per_group, axis=1)   # (B, G*K)
    return slot_starts[:, None, :] + offs.astype(jnp.int32)


@partial(jax.jit, static_argnames=())
def match_pair(feats_a, norms_a, energy_a, len_a,
               feats_v, norms_v, energy_v, len_v):
    quals, offs, starts, centers, margin = _match_core(
        feats_a, norms_a, energy_a, len_a,
        feats_v, norms_v, energy_v, len_v)
    return quals, _abs_vids(offs, starts), centers, margin


# k-best coarse tracking: lanes within this radius of an earlier track are
# suppressed before re-running the DP, so the next track explores a
# genuinely different hypothesis (radius > band width so bands are mostly
# disjoint). Ambiguous media - rate-mismatched content whose coarse scores
# drop below self-similarity ridges - keeps recall through the 2nd band;
# the fine-pass prob gates + LIS arbitrate which hypothesis is real.
N_TRACKS = 2
SUPPRESS_LANES = 25


def nb_for(npad):
    """Number of fine blocks for a given padded feature length (static)."""
    ka = (npad - WINDOW - max(SUB_LANE_SHIFTS)) // COARSE_STRIDE + 1
    return ka // COARSE_PER_BLOCK


def _coarse_tracks(feats_a, norms_a, energy_a, len_a,
                   feats_v, norms_v, energy_v, len_v, nf=None):
    """Masks + coarse score map + k-best DP tracks.

    Returns (a_mask, v_mask, starts_tracks (T, B) i32 band starts,
    centers (B,) best-track offset frames, margin f32 scalar).

    margin = (track-1 score - track-2 score) / anchor blocks: the winning
    coarse hypothesis's per-anchor-block advantage over the best genuinely
    different alternative (k-best suppression guarantees disjoint lanes).
    Near-zero margins mean the signal the coarse stage needs is absent
    from the score map and the winning track is likely a self-similarity
    ridge (the confidently-wrong narrowband regime, scripts/
    diag_narrowband.py): campaign calibration (scripts/diag_confidence.py) shows wrong tracks at
    0.007-0.029 vs correct tracks at 0.056+ across every profile. The
    reference's equivalent guard is its hash-bin gate starving the path
    and raising (describealign.py:698-699); ours warns via
    COARSE_MARGIN_FLOOR (api/pipeline) instead of refusing, preserving
    the 5-of-12 narrowband draws we recover where the reference raises.
    """
    nv_pad = feats_v.shape[1]
    a_mask = valid_audio_mask(energy_a, len_a)
    v_mask = valid_video_mask(energy_v, len_v)

    nf = COARSE_STREAMS if nf is None else nf
    desc_a = _coarse_descriptors(feats_a[:nf], norms_a[:nf], a_mask)
    desc_v_list = [_coarse_descriptors(feats_v[:nf], norms_v[:nf], v_mask,
                                       phase) for phase in SUB_LANE_SHIFTS]
    ka = desc_a.shape[0]
    kv = desc_v_list[0].shape[0]
    nb = ka // COARSE_PER_BLOCK

    v_paths = []
    scores = []
    if nb * kv > coarse_stream_elems():
        # hour-plus media: the (B, D) score/cost tensors would not fit HBM;
        # stream the DP with checkpointed rematerialization instead
        for _ in range(N_TRACKS):
            v_path, score = _coarse_dp_streamed(desc_a, desc_v_list, nb,
                                                v_paths)
            v_paths.append(v_path)
            scores.append(score)
    else:
        p_map = _block_scores_local(desc_a, desc_v_list)
        lanes = jnp.arange(kv, dtype=jnp.int32)[None, :]
        suppressed = p_map
        for _ in range(N_TRACKS):
            v_path, score = _coarse_dp(suppressed)    # (B,) video coarse idx
            v_paths.append(v_path)
            scores.append(score)
            suppressed = jnp.where(
                jnp.abs(lanes - v_path[:, None]) <= SUPPRESS_LANES,
                -1e30, suppressed)

    # anchor blocks: audio blocks contributing any eligible coarse
    # descriptor (quiet blocks add identical relaxation terms to every
    # track, so they carry no evidence and are excluded from the norm)
    anchor_rows = a_mask[np.arange(ka) * COARSE_STRIDE]
    n_anchor = jnp.sum(jnp.any(
        anchor_rows[:nb * COARSE_PER_BLOCK].reshape(nb, COARSE_PER_BLOCK),
        axis=1).astype(jnp.int32))
    if len(scores) >= 2:
        margin = ((scores[0] - scores[1])
                  / jnp.maximum(1, n_anchor).astype(jnp.float32))
    else:
        margin = jnp.float32(jnp.inf)

    starts_tracks = []
    centers0 = None
    for v_path in v_paths:
        centers = (v_path * COARSE_STRIDE
                   - jnp.arange(nb, dtype=jnp.int32) * BLOCK)
        if centers0 is None:
            centers0 = centers                        # best track's offsets
        starts_tracks.append(jnp.clip(
            jnp.arange(nb, dtype=jnp.int32) * BLOCK + centers
            - FINE_HALF_BAND, 0, nv_pad - (FINE_W + WINDOW - 1)))
    return a_mask, v_mask, jnp.stack(starts_tracks, axis=0), centers0, margin


def _fine_tracks(feats_a, norms_a, a_mask, feats_v, norms_v, v_mask,
                 starts_tracks, b0, count, nb_valid):
    """Fine pass + rescue gating for `count` blocks starting at block b0.

    starts_tracks: (T, count) band starts for these blocks; b0 may be a
    traced scalar (the streaming path slices chunks out of one compiled
    program). Blocks >= nb_valid (chunk padding) emit zero quals.

    Returns (quals (count, 210, G*K) f32, offs int16,
    starts_grouped (count, G) i32) - slot j belongs to group j // (K//2)
    for rescue bands; band 1 spans groups 0-1.
    """
    b_global = b0 + jnp.arange(count, dtype=jnp.int32)

    def one_block(inp):
        b, start = inp
        return _fine_block(feats_a, norms_a, feats_v, norms_v,
                           a_mask, v_mask, b, start)

    all_quals, all_offs, all_starts = [], [], []
    for t in range(starts_tracks.shape[0]):
        starts = starts_tracks[t]
        quals, offs = jax.lax.map(
            one_block, (b_global, starts), batch_size=32)
        quals = jnp.where((b_global < nb_valid)[:, None, None], quals, 0.0)
        all_quals.append(quals)
        all_offs.append(offs)
        all_starts.append(starts)

    # band 1 (the best track) keeps all TOP_K candidates; rescue bands
    # keep their top half on every 2nd audio frame - they only need to
    # seed a consistent chain for the LIS to pick up (the fit bridges the
    # rest) - and only in blocks whose top candidates AGREE on one offset
    # (true matches line up frame after frame; gate-passing fakes on
    # self-similar media scatter). This bounds the D2H/LIS cost of
    # robustness. Slots are grouped in spans of TOP_K//2 sharing one
    # start: band 1 = groups 0-1, band g>=2 = one group.
    half = TOP_K // 2
    even_frame = (jnp.arange(BLOCK) % 2 == 0)[None, :, None]

    def _consistent_blocks(quals_g, offs_g):
        """(B,) bool: block's top-1 offsets have a mode of >= 15 frames."""
        b_n = quals_g.shape[0]
        live = quals_g[:, :, 0] > 0                   # (B, 210)
        d = offs_g[:, :, 0].astype(jnp.int32) - jnp.arange(
            BLOCK, dtype=jnp.int32)[None, :] + BLOCK  # within-band offset
        d = jnp.clip(d, 0, FINE_W + BLOCK)
        b_idx = jnp.broadcast_to(
            jnp.arange(b_n, dtype=jnp.int32)[:, None], d.shape)
        counts = jnp.zeros((b_n, FINE_W + BLOCK + 1), jnp.float32)
        counts = counts.at[b_idx.ravel(), d.ravel()].add(
            live.astype(jnp.float32).ravel())
        widened = sum(jnp.roll(counts, s, axis=1) for s in range(-2, 3))
        return jnp.max(widened, axis=1) >= 15.0

    rescue_quals = []
    for q, o in zip(all_quals[1:], all_offs[1:]):
        keep = _consistent_blocks(q, o)[:, None, None]
        rescue_quals.append(
            jnp.where(keep & even_frame, q[:, :, :half], 0.0))
    quals = jnp.concatenate([all_quals[0]] + rescue_quals, axis=2)
    offs = jnp.concatenate([all_offs[0]]
                           + [o[:, :, :half] for o in all_offs[1:]],
                           axis=2)
    starts = jnp.stack([all_starts[0], all_starts[0]]
                       + all_starts[1:], axis=1)      # (count, G)
    return quals, offs, starts


def _match_core(feats_a, norms_a, energy_a, len_a,
                feats_v, norms_v, energy_v, len_v, nf=None):
    """All-in-one device matcher.

    feats_*: (5, Npad) mean-subtracted features; norms_*: (5, Npad);
    energy_*: (Npad,) raw energy feature; len_*: true frame counts.

    Returns (quals (B, 210, G*K), offs (B, 210, G*K) int16,
    starts (B, G) int32, coarse_offset_frames (B,) of the best track);
    slot j belongs to band g = j // TOP_K, and its video frame is
    starts[b, g] + offs[b, l, j].
    """
    a_mask, v_mask, starts_tracks, centers, margin = _coarse_tracks(
        feats_a, norms_a, energy_a, len_a,
        feats_v, norms_v, energy_v, len_v, nf=nf)
    nb = starts_tracks.shape[1]
    quals, offs, starts = _fine_tracks(
        feats_a, norms_a, a_mask, feats_v, norms_v, v_mask,
        starts_tracks, 0, nb, nb)
    return quals, offs, starts, centers, margin
