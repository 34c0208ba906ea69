"""End-to-end alignment tests on synthetic pairs with known ground truth."""
import numpy as np
import pytest

from describealign_jax.ops.features import extract_features
from describealign_jax.alignment import matching
from describealign_jax.alignment.api import align
from tests.synth import build_pair, mapping_from_segments


def features_of(pcm):
    return [np.asarray(f) for f in extract_features(pcm)]


def run_align(video_pcm, audio_pcm, **kwargs):
    vf = features_of(video_pcm)
    af = features_of(audio_pcm)
    return align(vf, af, vf[0], af[0], **kwargs)


def check_mapping(audio_times, video_times, segments, tol=0.25):
    """Fit must map interior content points to ground truth within tol s."""
    truth = mapping_from_segments(segments)
    for (a0, a1, v0, v1) in segments:
        probes = np.linspace(a0 + 1.0, a1 - 1.0, 7)
        got = np.interp(probes, audio_times, video_times)
        want = truth(probes)
        np.testing.assert_allclose(got, want, atol=tol)


def test_align_offset_only():
    """Description = content with a 6 s narration lead-in."""
    video, audio, segments = build_pair(content_seconds=40.0, narration=(),
                                        lead_in=6.0, seed=3)
    x, y, similarity, path, median_slope = run_align(video, audio)
    check_mapping(x, y, segments)
    assert similarity > 60
    assert abs(median_slope - 1.0) < 0.01


def test_align_with_insertions():
    """Two narration insertions create three content segments."""
    video, audio, segments = build_pair(
        content_seconds=45.0, narration=((15.0, 3.0), (30.0, 4.0)),
        lead_in=0.0, seed=7)
    x, y, similarity, path, median_slope = run_align(video, audio)
    check_mapping(x, y, segments)
    assert similarity > 55
    assert abs(median_slope - 1.0) < 0.01


def test_align_from_pcm_device_features(monkeypatch):
    """DESCRIBEALIGN_FEATURES=device: the fused PCM->features->match
    program (the fast-link configuration) must produce a valid alignment
    end to end."""
    monkeypatch.setenv('DESCRIBEALIGN_FEATURES', 'device')
    from describealign_jax.alignment.api import align_from_pcm

    video, audio, segments = build_pair(content_seconds=40.0, narration=(),
                                        lead_in=6.0, seed=3)

    def to_i16(p):
        return np.clip(p, -32768, 32767).astype(np.int16)

    x, y, similarity, path, median_slope = align_from_pcm(
        to_i16(video), to_i16(audio))[:5]
    check_mapping(x, y, segments)
    assert similarity > 60


def test_align_without_native_library(monkeypatch):
    """The whole pipeline must run on pure-Python fallbacks when no C++
    compiler/library is available (numpy features, stdlib-bisect LIS, python
    pass-2 DP, python fused-lasso): same pair as test_align_offset_only so
    the compiled device shapes are cache-hot."""
    from describealign_jax.alignment import native
    monkeypatch.setattr(native, '_LIB', None)
    monkeypatch.setattr(native, '_TRIED', True)
    from describealign_jax.alignment.api import align_from_pcm

    video, audio, segments = build_pair(content_seconds=40.0, narration=(),
                                        lead_in=6.0, seed=3)

    def to_i16(p):
        return np.clip(p, -32768, 32767).astype(np.int16)

    x, y, similarity, path, median_slope = align_from_pcm(
        to_i16(video), to_i16(audio))[:5]
    check_mapping(x, y, segments)
    assert similarity > 60


def test_streamed_lis_matches_single_shot():
    """The chunked matcher + streaming LIS must yield the exact path the
    single-shot match_from_features + lis_from_match pipeline yields."""
    import jax
    from describealign_jax.alignment import lis, matching
    from describealign_jax.alignment.api import (_bucket_pad, _streamed_lis,
                                                 host_features_padded)
    if not lis.LisStream.available():
        pytest.skip("native library unavailable")
    video, audio, _ = build_pair(
        content_seconds=45.0, narration=((15.0, 3.0), (30.0, 4.0)),
        lead_in=0.0, seed=7)

    def to_i16(x):
        return np.clip(x, -32768, 32767).astype(np.int16)

    video, audio = to_i16(video), to_i16(audio)
    sv, sa = video.shape[1], audio.shape[1]
    npad = max(_bucket_pad(sv // 210), _bucket_pad(sa // 210))
    fv, nv = host_features_padded(video, sv, npad)
    fa, na = host_features_padded(audio, sa, npad)
    dev_v, dev_a = jax.device_put(fv), jax.device_put(fa)
    quals, offs, starts, _ = matching.match_from_features(dev_a, na, dev_v, nv)
    want_y, want_x = lis.lis_from_match(np.asarray(quals), np.asarray(offs),
                                        np.asarray(starts))
    got_y, got_x, _ = _streamed_lis(dev_a, na, dev_v, nv)
    np.testing.assert_array_equal(got_y, want_y)
    np.testing.assert_array_equal(got_x, want_x)


def test_streamed_multichunk_matches_single_shot(monkeypatch):
    """Chunk-BOUNDARY coverage: with a shrunk chunk size, ~107 s of media
    streams as 4 chunks, exercising the per-chunk a_base offsets, on-device
    starts slicing, and ordered feeds that full-scale media hits.
    Uses its own shape bucket so the patched chunking never collides with
    other tests' cached coarse traces."""
    import jax
    from describealign_jax.alignment import lis, matching
    from describealign_jax.alignment.api import (_bucket_pad, _streamed_lis,
                                                 host_features_padded)
    if not lis.LisStream.available():
        pytest.skip("native library unavailable")
    monkeypatch.setattr(matching, 'FINE_CHUNK', 32)
    try:
        video, audio, _ = build_pair(content_seconds=100.0,
                                     narration=((40.0, 4.0),), lead_in=5.0,
                                     seed=17)

        def to_i16(x):
            return np.clip(x, -32768, 32767).astype(np.int16)

        video, audio = to_i16(video), to_i16(audio)
        sv, sa = video.shape[1], audio.shape[1]
        npad = max(_bucket_pad(sv // 210), _bucket_pad(sa // 210))
        fv, nv = host_features_padded(video, sv, npad)
        fa, na = host_features_padded(audio, sa, npad)
        dev_v = jax.device_put(fv.astype(np.float16))
        dev_a = jax.device_put(fa.astype(np.float16))
        _, _, n_chunks, _ = matching.match_stream(dev_a, na, dev_v, nv)
        assert n_chunks >= 3, f"expected multi-chunk stream, got {n_chunks}"
        got_y, got_x, _ = _streamed_lis(dev_a, na, dev_v, nv)
        quals, offs, starts, _ = matching.match_from_features(dev_a, na,
                                                              dev_v, nv)
        want_y, want_x = lis.lis_from_match(
            np.asarray(quals), np.asarray(offs), np.asarray(starts))
        np.testing.assert_array_equal(got_y, want_y)
        np.testing.assert_array_equal(got_x, want_x)
    finally:
        # the patched chunk size is baked into the jitted coarse/chunk
        # traces; drop them so later tests that land on this shape bucket
        # (e.g. bucket-boundary media) retrace with the real constant
        matching.match_coarse.clear_cache()
        matching.match_fine_chunk.clear_cache()


def test_streamed_coarse_dp_matches_materialized(monkeypatch):
    """The memory-bounded streamed coarse DP (checkpointed score-map
    rematerialization, used automatically for hour-plus media where the
    (B, D) score/cost tensors would not fit HBM) must produce exactly the
    same k-best track starts and centers as the materialized path.
    ~150 s of content spans 3 COARSE_CHUNK tiles, exercising checkpoint
    handoff and jump backtrace across chunk boundaries."""
    from describealign_jax.alignment import matching
    from describealign_jax.alignment.api import (_bucket_pad,
                                                 host_features_padded)
    from describealign_jax.alignment.preprocess import preprocess_features

    video, audio, _ = build_pair(
        content_seconds=150.0, narration=((50.0, 4.0), (100.0, 5.0)),
        lead_in=8.0, seed=29)

    def to_i16(x):
        return np.clip(x, -32768, 32767).astype(np.int16)

    video, audio = to_i16(video), to_i16(audio)
    sv, sa = video.shape[1], audio.shape[1]
    npad = max(_bucket_pad(sv // 210), _bucket_pad(sa // 210))
    fv, nv = host_features_padded(video, sv, npad)
    fa, na = host_features_padded(audio, sa, npad)
    ms_a, norms_a = preprocess_features(fa)
    ms_v, norms_v = preprocess_features(fv)

    want = matching._coarse_tracks(ms_a, norms_a, fa[0], na,
                                   ms_v, norms_v, fv[0], nv)
    monkeypatch.setattr(matching, 'COARSE_STREAM_ELEMS', 0)
    got = matching._coarse_tracks(ms_a, norms_a, fa[0], na,
                                  ms_v, norms_v, fv[0], nv)
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(want[2]))
    np.testing.assert_array_equal(np.asarray(got[3]), np.asarray(want[3]))


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform, self.device_kind, self._stats = platform, 'fake', stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize('platform,stats,want', [
    ('cpu', None, matching.COARSE_STREAM_ELEMS_HOST),
    # an 80 GB card with JAX's default 75% pool, and a 24 GB one
    ('gpu', {'bytes_limit': 60 * 2**30}, int(60 * 2**30 * 0.25 / 17.5)),
    ('gpu', {'bytes_limit': 18 * 2**30}, int(18 * 2**30 * 0.25 / 17.5)),
    ('gpu', None, RuntimeError),
    ('gpu', {}, RuntimeError),
])
def test_coarse_stream_limit_follows_device_memory(monkeypatch, platform,
                                                   stats, want):
    """The streamed-DP threshold is a share of the memory JAX may use on
    the device, so a smaller card streams sooner; a fixed count on the
    CPU; an accelerator that reports no limit fails loudly."""
    monkeypatch.setattr(matching.jax, 'local_devices',
                        lambda: [_FakeDevice(platform, stats)])
    matching._device_stream_elems.cache_clear()
    try:
        if want is RuntimeError:
            with pytest.raises(RuntimeError, match='no memory limit'):
                matching.coarse_stream_elems()
        else:
            assert matching.coarse_stream_elems() == want
            monkeypatch.setattr(matching, 'COARSE_STREAM_ELEMS', 5)
            assert matching.coarse_stream_elems() == 5
    finally:
        matching._device_stream_elems.cache_clear()


def test_align_mismatched_raises():
    """Unrelated content must fail alignment, like the reference does."""
    # reuse the dims of test_align_offset_only so compiled shapes are cached
    video, _, _ = build_pair(content_seconds=40.0, narration=(), lead_in=6.0,
                             seed=11)
    _, audio, _ = build_pair(content_seconds=40.0, narration=(), lead_in=6.0,
                             seed=99)
    with pytest.raises(RuntimeError, match="mismatched"):
        run_align(video, audio)


def test_fit_backends_equivalent():
    """End-to-end: the native fused-lasso fit and the exact LP must produce
    the same final alignment nodes (within a feature frame)."""
    video, audio, segments = build_pair(content_seconds=40.0, narration=(),
                                        lead_in=6.0, seed=3)
    vf = features_of(video)
    af = features_of(audio)
    x_lp, y_lp, sim_lp, _, m_lp = align(vf, af, vf[0], af[0],
                                        fit_backend='highs')
    x_tv, y_tv, sim_tv, _, m_tv = align(vf, af, vf[0], af[0],
                                        fit_backend='device')
    probes = np.linspace(x_lp[0] + 0.5, x_lp[-1] - 0.5, 40)
    np.testing.assert_allclose(np.interp(probes, x_tv, y_tv),
                               np.interp(probes, x_lp, y_lp), atol=0.05)
    assert abs(sim_tv - sim_lp) < 1.0
    assert abs(m_tv - m_lp) < 5e-3


def test_align_batch_matches_single():
    """Batched device path + threaded host stages == per-pair results."""
    from describealign_jax.alignment.api import (align_batch_from_pcm,
                                                 align_from_pcm)

    def to_i16(x):
        return np.clip(x, -32768, 32767).astype(np.int16)

    pairs = []
    for seed in (3, 11):
        video, audio, _ = build_pair(content_seconds=40.0, narration=(),
                                     lead_in=6.0, seed=seed)
        pairs.append((to_i16(video), to_i16(audio)))
    batch = align_batch_from_pcm(pairs)
    for (v, a), got in zip(pairs, batch):
        want = align_from_pcm(v, a)
        np.testing.assert_allclose(got[0], want[0], atol=1e-6)  # audio times
        np.testing.assert_allclose(got[1], want[1], atol=1e-6)  # video times
        assert abs(got[2] - want[2]) < 1e-9                     # similarity
        assert abs(got[4] - want[4]) < 1e-12                    # median slope


def test_align_batch_compact_transport_matches(monkeypatch):
    """The compact batch transport (DESCRIBEALIGN_COMPACT=1: per-frame
    counts + contiguous live-prefix planes, occupancy-exact pulls) must
    reproduce the dense transport's results exactly, and the host's
    live-offset twin (compact2_live_offsets) must agree with the device
    layout: codes planes carry no zero codes inside the live prefix and
    the live region is all-zero beyond the computed total."""
    import jax
    from describealign_jax.alignment import matching
    from describealign_jax.alignment.api import (_bucket_pad,
                                                 align_batch_from_pcm,
                                                 host_features_padded)

    def to_i16(x):
        return np.clip(x, -32768, 32767).astype(np.int16)

    pairs = []
    for seed in (3, 11):
        video, audio, _ = build_pair(content_seconds=40.0, narration=(),
                                     lead_in=6.0, seed=seed)
        pairs.append((to_i16(video), to_i16(audio)))
    monkeypatch.setenv('DESCRIBEALIGN_COMPACT', '0')
    want = align_batch_from_pcm(pairs)

    monkeypatch.setenv('DESCRIBEALIGN_COMPACT', '1')
    got = align_batch_from_pcm(pairs)   # default pull mode ('sliced')
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2] == w[2] and g[4] == w[4]

    # every pull mode moves the same candidate bytes: 'sliced' (default,
    # main-thread lag-2 occupancy prefix slice), 'whole' (entire padded
    # buffer), 'exact' (two-phase fixed-then-live) must be result-equal
    for mode in ('whole', 'exact'):
        monkeypatch.setenv('DESCRIBEALIGN_BATCH_PULL', mode)
        got_m = align_batch_from_pcm(pairs)
        for g, w in zip(got_m, got):
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])
            assert g[2] == w[2] and g[4] == w[4]
    monkeypatch.delenv('DESCRIBEALIGN_BATCH_PULL')

    # layout invariants on the raw buffer of the first pair
    video, audio = pairs[0]
    sv, sa = video.shape[1], audio.shape[1]
    npad = max(_bucket_pad(sv // 210), _bucket_pad(sa // 210))
    fv, nv = host_features_padded(video, sv, npad)
    fa, na = host_features_padded(audio, sa, npad)
    fav = np.empty((2, 5, npad), np.float16)
    fav[0] = fa
    fav[1] = fv
    chunks, starts_dev, _, margin_dev = matching.match_stream_pair(
        jax.device_put(fav), na, nv)
    buf_dev, totals_dev = matching.concat_chunks_compact(chunks, starts_dev,
                                                         margin_dev)
    buf = np.asarray(buf_dev)
    nb = matching.nb_for(npad)
    lay = matching.compact_layout(nb, starts_dev.shape[0])
    assert buf.shape[0] == lay['total']
    counts = buf[slice(*lay['counts'])]
    t1 = int(np.sum(counts & 15, dtype=np.int64))
    t2 = int(np.sum(counts >> 4, dtype=np.int64))
    assert 0 < t1 <= nb * 210 * matching.TOP_K
    # the device-side live totals (the 'sliced' pull sizes its one
    # transfer from these) must equal the counts-derived totals
    np.testing.assert_array_equal(np.asarray(totals_dev), [t1, t2])
    sec = matching.compact2_live_offsets(t1, t2)
    live = buf[lay['live']:]
    a, b = sec['codes1']
    assert np.all(live[a:b] != 0)           # live slots never code 0
    a, b = sec['codes2']
    assert np.all(live[a:b] != 0)
    assert not np.any(live[sec['total']:])  # nothing past the live total


def test_fused_batch_transport_matches_chunked():
    """The ONE-dispatch fused matcher programs (match_pair_combo /
    match_pair_compact) must produce byte-identical transport buffers to
    the chunked dispatch path they replace, and align_batch_from_pcm must
    return identical results either way (DESCRIBEALIGN_FUSED_BATCH)."""
    import jax
    from describealign_jax.alignment import matching
    from describealign_jax.alignment.api import (_bucket_pad,
                                                 align_batch_from_pcm,
                                                 host_features_padded)

    def to_i16(x):
        return np.clip(x, -32768, 32767).astype(np.int16)

    video, audio, _ = build_pair(content_seconds=45.0,
                                 narration=((15.0, 3.0), (30.0, 4.0)),
                                 lead_in=0.0, seed=7)
    video, audio = to_i16(video), to_i16(audio)
    sv, sa = video.shape[1], audio.shape[1]
    npad = max(_bucket_pad(sv // 210), _bucket_pad(sa // 210))
    fv, nv = host_features_padded(video, sv, npad)
    fa, na = host_features_padded(audio, sa, npad)
    fav = np.empty((2, 5, npad), np.float16)
    fav[0] = fa
    fav[1] = fv
    dev_av = jax.device_put(fav)

    chunks, starts_dev, _, margin_dev = matching.match_stream_pair(
        dev_av, na, nv)
    want_dense = np.asarray(
        matching.concat_chunks_with_starts(chunks, starts_dev, margin_dev))
    got_dense = np.asarray(matching.match_pair_combo(dev_av, na, nv))
    np.testing.assert_array_equal(got_dense, want_dense)

    want_comp_dev, want_totals = matching.concat_chunks_compact(
        chunks, starts_dev, margin_dev)
    got_comp_dev, got_totals = matching.match_pair_compact(dev_av, na, nv)
    np.testing.assert_array_equal(np.asarray(got_comp_dev),
                                  np.asarray(want_comp_dev))
    np.testing.assert_array_equal(np.asarray(got_totals),
                                  np.asarray(want_totals))

    # end-to-end: fused (opt-in) vs chunked (default) — pin both sides
    # explicitly so the test stays meaningful whatever the default is
    import os
    pairs = [(video, audio)]
    os.environ['DESCRIBEALIGN_FUSED_BATCH'] = '1'
    try:
        want = align_batch_from_pcm(pairs)
        os.environ['DESCRIBEALIGN_FUSED_BATCH'] = '0'
        got = align_batch_from_pcm(pairs)
    finally:
        del os.environ['DESCRIBEALIGN_FUSED_BATCH']
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2] == w[2] and g[4] == w[4]


def test_streamed_compact_transport_matches(monkeypatch):
    """The per-chunk compact transport on the single-pair streamed path
    (DESCRIBEALIGN_COMPACT=1 + matching.compact_chunk) must yield the
    exact path of the dense streamed path across chunk boundaries, and
    artificially tiny budgets must route every chunk through the per-chunk
    dense fallback with identical results."""
    import jax
    from describealign_jax.alignment import lis, matching
    from describealign_jax.alignment.api import (_bucket_pad, _streamed_lis,
                                                 host_features_padded)
    if not lis.LisStream.available():
        pytest.skip("native library unavailable")
    monkeypatch.setattr(matching, 'FINE_CHUNK', 32)
    try:
        video, audio, _ = build_pair(content_seconds=100.0,
                                     narration=((40.0, 4.0),), lead_in=5.0,
                                     seed=17)

        def to_i16(x):
            return np.clip(x, -32768, 32767).astype(np.int16)

        video, audio = to_i16(video), to_i16(audio)
        sv, sa = video.shape[1], audio.shape[1]
        npad = max(_bucket_pad(sv // 210), _bucket_pad(sa // 210))
        fv, nv = host_features_padded(video, sv, npad)
        fa, na = host_features_padded(audio, sa, npad)
        dev_v = jax.device_put(fv.astype(np.float16))
        dev_a = jax.device_put(fa.astype(np.float16))
        _, _, n_chunks, _ = matching.match_stream(dev_a, na, dev_v, nv)
        assert n_chunks >= 3, f"expected multi-chunk stream, got {n_chunks}"
        monkeypatch.setenv('DESCRIBEALIGN_COMPACT', '0')
        want_y, want_x, _ = _streamed_lis(dev_a, na, dev_v, nv)

        monkeypatch.setenv('DESCRIBEALIGN_COMPACT', '1')
        got_y, got_x, _ = _streamed_lis(dev_a, na, dev_v, nv)
        np.testing.assert_array_equal(got_y, want_y)
        np.testing.assert_array_equal(got_x, want_x)

        # force per-chunk overflow: every chunk must flag and fall back to
        # its dense buffer, bit-identically
        monkeypatch.setattr(matching, 'COMPACT_CHUNK_BUDGET1', 0.01)
        monkeypatch.setattr(matching, 'COMPACT_CHUNK_BUDGET2', 0.01)
        matching.compact_chunk.clear_cache()
        try:
            got2_y, got2_x, _ = _streamed_lis(dev_a, na, dev_v, nv)
        finally:
            matching.compact_chunk.clear_cache()
        np.testing.assert_array_equal(got2_y, want_y)
        np.testing.assert_array_equal(got2_x, want_x)
    finally:
        matching.match_coarse.clear_cache()
        matching.match_fine_chunk.clear_cache()


def test_align_rate_change():
    """A 3% speed difference (PAL-style) must be recovered in the fit and
    the median slope (exercises the coarse DP's drift tracking and the
    fused-lasso slope stage on non-unit slopes)."""
    from scipy.signal import resample_poly
    from describealign_jax.utils.synthmedia import speech_like

    content = speech_like(40.0, seed=21)
    slowed = resample_poly(content, 103, 100)  # 3% longer

    def quantize(sig):
        x = np.clip(np.round(sig), -32768, 32767).astype(np.int16)
        return x[None, :].astype(np.float16).astype(np.float32)

    video = quantize(content)
    audio = quantize(np.concatenate([
        np.asarray(speech_like(6.0, seed=1021, amp=5000.0)), slowed]))
    x, y, similarity, path, median_slope = run_align(video, audio)
    # audio time a maps to video time (a - 6) * 100/103
    probes = np.linspace(8.0, 6.0 + 40.0 * 1.03 - 2.0, 9)
    got = np.interp(probes, x, y)
    want = (probes - 6.0) * (100.0 / 103.0)
    np.testing.assert_allclose(got, want, atol=0.3)
    assert abs(median_slope - 100.0 / 103.0) < 2e-3


def test_match_quality_values_match_reference_formula():
    """The matcher's candidate qualities must equal the reference's
    Naive-Bayes form (describealign.py:662-673) computed directly with the
    numpy oracle's mean-sub/norm pipeline."""
    import jax.numpy as jnp
    from describealign_jax.alignment import lis, matching, preprocess
    from describealign_jax.alignment.api import _stack_padded
    from tests import reference_impl as ref

    video, audio, _ = build_pair(content_seconds=14.0, narration=(),
                                 lead_in=2.0, seed=0)
    fs_a = features_of(audio)
    fs_v = features_of(video)
    na = min(len(f) for f in fs_a)
    nv = min(len(f) for f in fs_v)
    npad = 210 * 20
    fa = _stack_padded(fs_a, na, npad)
    fv = _stack_padded(fs_v, nv, npad)
    ms_a, norms_a = preprocess.preprocess_features(fa)
    ms_v, norms_v = preprocess.preprocess_features(fv)
    quals, vids, _, _ = matching.match_pair(ms_a, norms_a, fa[0], na,
                                            ms_v, norms_v, fv[0], nv)
    cand_a, cand_v, cand_q = lis.candidates_from_match_output(quals, vids)
    assert len(cand_a) > 500

    a_ms = [ref.oracle_mean_sub(np.asarray(f[:na], np.float64)) for f in fs_a]
    v_ms = [ref.oracle_mean_sub(np.asarray(f[:nv], np.float64)) for f in fs_v]
    a_nm = [ref.oracle_uniform_norm(x) for x in a_ms]
    v_nm = [ref.oracle_uniform_norm(x) for x in v_ms]

    rng = np.random.default_rng(0)
    picks = rng.choice(len(cand_a), 200, replace=False)
    for t in picks:
        i, v, q = int(cand_a[t]), int(cand_v[t]), float(cand_q[t])
        prob = 1.0
        for j in range(3):
            corr = np.dot(a_ms[j][i:i + 41], v_ms[j][v:v + 41])
            corr /= a_nm[j][i] * v_nm[j][v]
            prob *= max(1e-8, 1 - corr)
        prob = prob ** 2.9
        assert prob <= 1e-8 * 1.05, f"candidate ({i},{v}) fails the gate"
        want = min(50.0, (prob / 1e-12) ** (-1.0 / 3))
        assert abs(q - want) / want < 2e-3, (i, v, q, want)
