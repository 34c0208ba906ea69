"""Full-align parity against the ACTUAL reference implementation.

The reference module (/root/reference/describealign.py) is imported and
executed in place - never copied - and its align() (lines 595-1027) is run
on synthetic pairs next to ours. Both sides get the same feature arrays
(computed by the reference's own extractors), so this compares the
alignment algorithms end to end: hash-bin matching + LIS + linprog +
pass-2 vs our coarse-DP + banded matching + fused-lasso + pass-2.

Acceptance (BASELINE.md): recovered mappings within 0.25 s, similarity
within a few percent, median slope within 2e-3.
"""
import sys
import types

import numpy as np
import pytest

from describealign_jax.utils.synthmedia import speech_like

REF_DIR = "/root/reference"
SR = 44100


@pytest.fixture(scope="module")
def ref():
    # stub modules the reference imports at module scope but that align()
    # never touches (and that are absent from this environment)
    for name, attrs in (("natsort", {"os_sorted": sorted}),
                        ("static_ffmpeg", {"add_paths": lambda: None}),
                        ("ffmpeg", {})):
        if name not in sys.modules:
            mod = types.ModuleType(name)
            for k, v in attrs.items():
                setattr(mod, k, v)
            sys.modules[name] = mod
    sys.path.insert(0, REF_DIR)
    try:
        import describealign as ref_mod
    finally:
        sys.path.remove(REF_DIR)
    return ref_mod


def _quantize(sig):
    x = np.clip(np.round(sig), -32768, 32767).astype(np.int16)
    return x[None, :].astype(np.float16)


def _features(ref, pcm_f16):
    return [ref.get_energy(pcm_f16), ref.get_zero_crossings(pcm_f16)] \
        + ref.get_freq_bands(pcm_f16)


def _run_both(ref, video_f16, audio_f16):
    import describealign_jax as da
    vf = _features(ref, video_f16)
    af = _features(ref, audio_f16)
    r = ref.align([np.asarray(f) for f in vf], [np.asarray(f) for f in af],
                  np.asarray(vf[0]), np.asarray(af[0]))
    o = da.align([np.asarray(f, np.float32) for f in vf],
                 [np.asarray(f, np.float32) for f in af],
                 np.asarray(vf[0], np.float32), np.asarray(af[0], np.float32))
    return r, o


def _assert_mapping_parity(r, o, probes, tol_s=0.25, sim_tol=8.0,
                           slope_tol=2e-3):
    r_x, r_y = np.asarray(r[0], float), np.asarray(r[1], float)
    o_x, o_y = np.asarray(o[0], float), np.asarray(o[1], float)
    # compare the piecewise-linear audio->video mappings at interior probes
    lo = max(r_x[0], o_x[0]) + 0.5
    hi = min(r_x[-1], o_x[-1]) - 0.5
    probes = probes[(probes >= lo) & (probes <= hi)]
    assert len(probes) >= 5
    r_map = np.interp(probes, r_x, r_y)
    o_map = np.interp(probes, o_x, o_y)
    err = np.abs(r_map - o_map)
    assert err.max() < tol_s, (err.max(), probes[np.argmax(err)])
    assert abs(float(r[2]) - float(o[2])) < sim_tol, (r[2], o[2])
    assert abs(float(r[4]) - float(o[4])) < slope_tol, (r[4], o[4])


def test_parity_offset_only(ref):
    content = speech_like(60.0, seed=31)
    video = _quantize(content)
    audio = _quantize(np.concatenate(
        [speech_like(8.0, seed=1031, amp=5000.0), content]))
    r, o = _run_both(ref, video, audio)
    _assert_mapping_parity(r, o, np.linspace(9, 66, 30))
    # both must recover the 8 s start offset
    assert abs((r[0][0] - r[1][0]) - 8.0) < 0.3
    assert abs((o[0][0] - o[1][0]) - 8.0) < 0.3


def test_parity_insertions(ref):
    content = speech_like(60.0, seed=32)
    video = _quantize(content)
    pieces = [speech_like(4.0, seed=1032, amp=5000.0),
              content[:int(20 * SR)],
              speech_like(3.0, seed=2032, amp=5000.0),
              content[int(20 * SR):int(41 * SR)],
              speech_like(5.0, seed=3032, amp=5000.0),
              content[int(41 * SR):]]
    audio = _quantize(np.concatenate(pieces))
    r, o = _run_both(ref, video, audio)
    _assert_mapping_parity(r, o, np.linspace(5, 70, 40))


def test_parity_rate_change(ref):
    from scipy.signal import resample_poly
    content = speech_like(50.0, seed=33)
    slowed = resample_poly(content, 103, 100)
    video = _quantize(content)
    audio = _quantize(np.concatenate(
        [speech_like(6.0, seed=1033, amp=5000.0), slowed]))
    r, o = _run_both(ref, video, audio)
    _assert_mapping_parity(r, o, np.linspace(8, 55, 30))
    assert abs(float(r[4]) - 100.0 / 103.0) < 2e-3
    assert abs(float(o[4]) - 100.0 / 103.0) < 2e-3


def test_parity_skip_heavy(ref):
    """Many small narration insertions (the 'skips from ~10 min in'
    structure of the Ask Dad episode, README.md:75)."""
    content = speech_like(80.0, seed=34)
    pieces = [speech_like(5.0, seed=1034, amp=5000.0)]
    cursor = 0.0
    for k, cut in enumerate((12.0, 25.0, 37.0, 52.0, 64.0, 71.0)):
        pieces.append(content[int(cursor * SR):int(cut * SR)])
        pieces.append(speech_like(2.0 + (k % 3), seed=4034 + k, amp=5000.0))
        cursor = cut
    pieces.append(content[int(cursor * SR):])
    video = _quantize(content)
    audio = _quantize(np.concatenate(pieces))
    r, o = _run_both(ref, video, audio)
    _assert_mapping_parity(r, o, np.linspace(6, 95, 45))


def test_parity_long_mixed(ref):
    """A longer (4.5-min) case mixing a start offset, spread-out skips, and
    a mid-stream rate change - scale-dependent divergences (band-tracking,
    compression, cluster merging) only show up beyond toy lengths."""
    from scipy.signal import resample_poly
    content = speech_like(240.0, seed=36)
    # video plays the second half 2% fast
    half = int(120 * SR)
    video = _quantize(np.concatenate(
        [content[:half], resample_poly(content[half:], 100, 102)]))
    pieces = [speech_like(12.0, seed=1036, amp=5000.0)]
    cursor = 0.0
    for k, cut in enumerate((40.0, 95.0, 150.0, 205.0)):
        pieces.append(content[int(cursor * SR):int(cut * SR)])
        pieces.append(speech_like(3.0 + k, seed=6036 + k, amp=5000.0))
        cursor = cut
    pieces.append(content[int(cursor * SR):])
    audio = _quantize(np.concatenate(pieces))
    r, o = _run_both(ref, video, audio)
    _assert_mapping_parity(r, o, np.linspace(14, 265, 60), tol_s=0.3)


def test_parity_noninteger_offsets_regression(ref):
    """Non-integer lead-in and skip positions put the true offsets MID-LANE
    in the coarse grid; with too-coarse sub-lane shift granularity an
    on-grid self-similar fake ridge outscored the off-grid truth and a
    16-s region aligned to the wrong content (randomized campaign draw 03,
    scripts/parity_campaign.py). Pinned here as a regression."""
    content = speech_like(100.312, seed=503)
    pieces = [speech_like(17.4376, seed=503 + 9001, amp=5000.0)]
    cursor = 0.0
    for k, (cut, dur) in enumerate(((35.14, 5.24), (55.67, 3.85),
                                    (79.24, 3.82))):
        pieces.append(content[int(cursor * SR):int(cut * SR)])
        pieces.append(speech_like(dur, seed=503 + 9100 + k, amp=5000.0))
        cursor = cut
    pieces.append(content[int(cursor * SR):])
    video = _quantize(content)
    audio = _quantize(np.concatenate(pieces))
    r, o = _run_both(ref, video, audio)
    _assert_mapping_parity(r, o, np.linspace(19, 128, 40))


def test_parity_low_similarity(ref):
    """Half the description content doesn't exist in the video: both
    implementations should report reduced similarity and still align the
    overlapping half consistently."""
    shared = speech_like(40.0, seed=35)
    video = _quantize(np.concatenate(
        [shared[:int(20 * SR)], speech_like(20.0, seed=5035),
         shared[int(20 * SR):]]))
    audio = _quantize(np.concatenate(
        [speech_like(6.0, seed=1035, amp=5000.0), shared]))
    r, o = _run_both(ref, video, audio)
    # similarity drops on both sides and agrees loosely
    assert float(r[2]) < 95.0 and float(o[2]) < 95.0
    assert abs(float(r[2]) - float(o[2])) < 12.0
    # mappings agree on the shared first half
    probes = np.linspace(7, 24, 12)
    r_map = np.interp(probes, np.asarray(r[0], float), np.asarray(r[1], float))
    o_map = np.interp(probes, np.asarray(o[0], float), np.asarray(o[1], float))
    assert np.abs(r_map - o_map).max() < 0.35


def test_parity_music_bed_short_segments(ref):
    """Round-3 campaign regression (draws 11/25): a repetitive tonal music
    bed under the dialog raises every coarse lane's floor score, shrinking
    the true lane's per-block margin; ~10-s content segments between the
    lead-in and the first skips were then corner-cut by the coarse DP's
    jump economics (5-7 s misalignments at DP_JUMP_COST=4; fixed at 2).
    Reproduces draw 25's structure: bed ratio 0.67, 9-s lead, skips at
    10.3/22.6/43.0 s."""
    from describealign_jax.utils.synthmedia import music_bed
    content = speech_like(62.0, seed=77) + 0.67 * music_bed(62.0, seed=577)
    video = _quantize(content)
    pieces = [speech_like(9.0, seed=1077, amp=5000.0),
              content[:int(10.3 * SR)],
              speech_like(7.1, seed=2077, amp=5000.0),
              content[int(10.3 * SR):int(22.6 * SR)],
              speech_like(6.6, seed=3077, amp=5000.0),
              content[int(22.6 * SR):int(43.0 * SR)],
              speech_like(7.1, seed=4077, amp=5000.0),
              content[int(43.0 * SR):]]
    audio = _quantize(np.concatenate(pieces))
    r, o = _run_both(ref, video, audio)
    _assert_mapping_parity(r, o, np.linspace(10, 80, 45))


def test_parity_music_bed_short_first_segment(ref):
    """Campaign seed-20260818 draw-17 regression: a 10-s FIRST segment
    (short lead, one early skip) under a 0.41-ratio music bed whose
    ridges TIE the true lane's coarse score. Both k-best tracks chose
    ridge lanes for the opening blocks and the whole first segment was
    dropped (5.6-s map error) until DP_JUMP_COST dropped to 1.0 - only
    cheaper jumps recover short segments whose per-block margin over the
    bed floor cannot amortize the jump. Reproduces the draw's structure:
    5.06-s lead, skip at 10.02 s for 5.57 s, bed ratio 0.41."""
    from describealign_jax.utils.synthmedia import music_bed
    content = speech_like(86.15, seed=917) + 0.41 * music_bed(86.15,
                                                              seed=1417)
    video = _quantize(content)
    pieces = [speech_like(5.06, seed=2417, amp=5000.0),
              content[:int(10.02 * SR)],
              speech_like(5.57, seed=3417, amp=5000.0),
              content[int(10.02 * SR):]]
    audio = _quantize(np.concatenate(pieces))
    r, o = _run_both(ref, video, audio)
    _assert_mapping_parity(r, o, np.linspace(6, 96, 45))


def test_parity_quiet_silence_boundary_skip(ref):
    """Quiet-profile campaign (seed 20260821) draw-03 structure: a skip cut
    placed right at the END of a 16-s near-silent span. The energy>.5
    anchor gating (reference describealign.py:629-633, 657-658; our
    preprocess quiet masks) leaves zero anchors inside the silence, so the
    skip's placement must be recovered from the bridging economics alone.
    On the campaign draw the REFERENCE misplaced the jump by 5.9 s (it put
    the discontinuity at the silence onset); ours recovered it exactly, so
    this pins ours against GROUND TRUTH everywhere and against the
    reference only outside the silence-ambiguous window."""
    content = speech_like(160.0, seed=911)
    # carve near-silent spans out of the shared content (fade like the
    # campaign's generator); the last one ends exactly at the first cut
    for at, dur in ((42.0, 9.0), (104.0, 16.0), (131.0, 8.0)):
        i0, i1 = int(at * SR), int((at + dur) * SR)
        fade = min(2205, (i1 - i0) // 4)
        ramp = np.linspace(1.0, 0.0, fade)
        content[i0:i0 + fade] *= ramp
        content[i0 + fade:i1 - fade] *= 0.0
        content[i1 - fade:i1] *= ramp[::-1]
    lead, cuts, durs = 18.5, (120.3, 142.9), (5.9, 3.3)
    video = _quantize(content)
    pieces = [speech_like(lead, seed=1911, amp=5000.0)]
    cursor = 0.0
    for k, (cut, dur) in enumerate(zip(cuts, durs)):
        pieces.append(content[int(cursor * SR):int(cut * SR)])
        pieces.append(speech_like(dur, seed=2911 + k, amp=5000.0))
        cursor = cut
    pieces.append(content[int(cursor * SR):])
    audio = _quantize(np.concatenate(pieces))
    r, o = _run_both(ref, video, audio)
    # ours vs ground truth: audio time -> video time piecewise map
    segs, a0, c0 = [], lead, 0.0
    for cut, dur in zip(cuts, durs):
        segs.append((a0, a0 + (cut - c0), c0))
        a0 += (cut - c0) + dur
        c0 = cut
    segs.append((a0, a0 + (160.0 - c0), c0))
    o_x, o_y = np.asarray(o[0], float), np.asarray(o[1], float)
    for (s0, s1, v0) in segs:
        probes = np.linspace(s0 + 1.0, s1 - 1.0, 12)
        got = np.interp(probes, o_x, o_y)
        want = v0 + (probes - s0)
        assert np.abs(got - want).max() < 0.25, (s0, s1)
    # parity vs the reference away from the silence-ambiguous window
    # (video 104-120.3 -> audio ~122.5-138.8; pad generously)
    probes = np.concatenate([np.linspace(20, 118, 40),
                             np.linspace(146, 186, 20)])
    _assert_mapping_parity(r, o, probes)


def test_parity_pal_rate(ref):
    """PAL-scale rate change: 25/24 (+4.17%), the canonical film-to-PAL
    speedup, ABOVE the default campaign's ±3% rate range (the 'rate'
    campaign profile covers ±3.5-6%: 12/12 draws clean on seed 20260820).
    Narration inserts plus a 0.6-ratio music bed ride on top, so the
    coarse DP must track a steady 4%/lane drift through bed ridges.
    Reference behavior: align() (describealign.py:595-1027) recovers the
    slope via its hash-bin matches + linprog fit; median slope = 24/25."""
    from scipy.signal import resample_poly
    from describealign_jax.utils.synthmedia import music_bed
    content = speech_like(60.0, seed=47) + 0.6 * music_bed(60.0, seed=547)
    slowed = resample_poly(content, 25, 24)
    video = _quantize(content)
    pieces = [speech_like(5.0, seed=1047, amp=5000.0),
              slowed[:int(30 * SR)],
              speech_like(4.0, seed=2047, amp=5000.0),
              slowed[int(30 * SR):]]
    audio = _quantize(np.concatenate(pieces))
    r, o = _run_both(ref, video, audio)
    _assert_mapping_parity(r, o, np.linspace(7, 68, 40))
    assert abs(float(r[4]) - 24.0 / 25.0) < 2e-3
    assert abs(float(o[4]) - 24.0 / 25.0) < 2e-3
