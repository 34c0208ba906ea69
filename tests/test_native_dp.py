"""Native (C++) vs Python DP equivalence on randomized inputs."""
import numpy as np
import pytest

from describealign_jax.alignment import lis, refine
from describealign_jax.alignment.native import native_lib
from describealign_jax.alignment.refine_native import (refine_dp_native,
                                                       refine_dp_native_available)

pytestmark = pytest.mark.skipif(native_lib() is None,
                                reason="native library unavailable")


def random_candidates(rng, n_frames=400, density=3, band=40):
    rows = []
    center = rng.integers(0, band)
    for i in range(n_frames):
        center = min(max(center + rng.integers(-2, 3), 0), band)
        for _ in range(rng.poisson(density)):
            v = i + int(rng.integers(-band, band + 1))
            if v < 0:
                continue
            rows.append((i, v, float(rng.uniform(0.05, 50.0))))
    rows.sort()
    a = np.array([r[0] for r in rows], np.int64)
    v = np.array([r[1] for r in rows], np.int64)
    q = np.array([r[2] for r in rows], np.float64)
    return a, v, q


@pytest.mark.parametrize('seed', [0, 1, 2, 3, 4])
def test_weighted_lis_native_matches_python(seed):
    rng = np.random.default_rng(seed)
    a, v, q = random_candidates(rng)
    v_py, a_py = lis.weighted_lis_py(a, v, q)
    v_cc, a_cc = lis.weighted_lis_native(a, v, q)
    np.testing.assert_array_equal(v_py, v_cc)
    np.testing.assert_array_equal(a_py, a_cc)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_lis_from_match_multigroup_matches_python(seed):
    """Fused bitmap-frontier LIS == python oracle on matcher-shaped input
    with rescue bands at far-away starts (stresses the frontier's
    predecessor/successor scans across distant keys)."""
    rng = np.random.default_rng(seed)
    nb, blk, k, g = 24, 210, 12, 3
    quals = (rng.random((nb, blk, k)) * 50).astype(np.float32)
    quals[rng.random((nb, blk, k)) < 0.5] = 0.0
    offs = rng.integers(0, 768, (nb, blk, k), dtype=np.int16)
    base = (np.arange(nb, dtype=np.int32) * 210)[:, None]
    starts = np.concatenate(
        [base, base, np.clip(base + 40000, 0, None)], axis=1).astype(np.int32)
    got_v, got_a = lis.lis_from_match(quals, offs, starts)

    slot_starts = np.repeat(starts.astype(np.int64), k // g, axis=1)
    vids = slot_starts[:, None, :] + offs
    a, v, q = lis.candidates_from_match_output(quals, vids)
    _, first = np.unique(np.stack([a, v, q.view(np.int64)]), axis=1,
                         return_index=True)
    keep = np.sort(first)
    want_v, want_a = lis.weighted_lis_py(a[keep], v[keep], q[keep])
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_a, want_a)


def test_qual_u8_grid_roundtrip_and_native_decode_agree():
    """The u8 quality transport grid must (a) round-trip every code to the
    documented f16 bit pattern, (b) decode identically in C++ (same LIS
    paths whether fed decoded f16 values or raw codes), and (c) stay
    within its 1.6% relative-step contract across the quality range."""
    import jax.numpy as jnp
    from describealign_jax.alignment import matching

    codes = np.arange(256, dtype=np.uint8)
    vals = np.asarray(matching._qual_dequantize_f16(jnp.asarray(codes)))
    bits = np.where(codes > 0,
                    (codes.astype(np.uint32) + matching.QUAL_CODE_BASE) << 6,
                    0).astype(np.uint16)
    np.testing.assert_array_equal(vals.view(np.uint16), bits)
    # quantize(dequantize(code)) is the identity on the grid
    again = np.asarray(matching._qual_quantize_u8(
        jnp.asarray(vals.astype(np.float32))))
    np.testing.assert_array_equal(again, codes)
    # relative step <= 2^-5 across the in-range gamut
    qs = np.linspace(0.05, 50.0, 4001, dtype=np.float32)
    rt = np.asarray(matching._qual_dequantize_f16(
        matching._qual_quantize_u8(jnp.asarray(qs)))).astype(np.float32)
    assert np.max(np.abs(rt - qs) / qs) <= 2.0 ** -5

    # C++ feed_u8 == feed on the decoded values
    rng = np.random.default_rng(3)
    nb, blk, k = 6, 210, 12
    quals = (rng.random((nb, blk, k)) * 50).astype(np.float32)
    quals[rng.random((nb, blk, k)) < 0.5] = 0.0
    offs = rng.integers(0, 768, (nb, blk, k), dtype=np.int16)
    starts = np.repeat((np.arange(nb, dtype=np.int32) * 210)[:, None],
                       3, axis=1)
    codes3d = np.asarray(matching._qual_quantize_u8(jnp.asarray(quals)))
    vals3d = np.asarray(matching._qual_dequantize_f16(jnp.asarray(codes3d)))
    key_bound = int(starts.max()) + 32768
    with lis.LisStream(key_bound) as s1:
        s1.feed(vals3d, offs, starts, a_base=0)
        v1, a1 = s1.finish()
    with lis.LisStream(key_bound) as s2:
        s2.feed_u8(codes3d, offs, starts, a_base=0)
        v2, a2 = s2.finish()
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(a1, a2)


def test_feed_split_equals_full_rate_feed():
    """The split transport (band-1 full rate + rescue even-frames-only)
    must reconstruct the exact candidate stream of the full-rate layout
    with odd-frame rescue slots zeroed."""
    rng = np.random.default_rng(8)
    nb, blk, k1, k2 = 5, 210, 8, 4
    q1 = (rng.random((nb, blk, k1)) * 50).astype(np.float32)
    q1[rng.random((nb, blk, k1)) < 0.5] = 0.0
    o1 = rng.integers(0, 768, (nb, blk, k1), dtype=np.int16)
    q2 = (rng.random((nb, blk, k2)) * 50).astype(np.float32)
    q2[rng.random((nb, blk, k2)) < 0.5] = 0.0
    q2[:, 1::2, :] = 0.0                       # odd frames empty
    o2 = rng.integers(0, 768, (nb, blk, k2), dtype=np.int16)
    starts = np.repeat((np.arange(nb, dtype=np.int32) * 210)[:, None],
                       3, axis=1)
    starts[:, 2] += 30000                      # rescue band far away

    import jax.numpy as jnp
    from describealign_jax.alignment import matching
    c1 = np.asarray(matching._qual_quantize_u8(jnp.asarray(q1)))
    c2 = np.asarray(matching._qual_quantize_u8(jnp.asarray(q2)))
    full_codes = np.concatenate([c1, c2], axis=2)
    full_offs = np.concatenate([o1, o2], axis=2)
    key_bound = int(starts.max()) + 32768
    with lis.LisStream(key_bound) as s1:
        s1.feed_u8(full_codes, full_offs, starts, a_base=420)
        v1, a1 = s1.finish()
    with lis.LisStream(key_bound) as s2:
        s2.feed_split(c1, o1, c2[:, ::2, :], o2[:, ::2, :], starts,
                      a_base=420)
        v2, a2 = s2.finish()
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(a1, a2)

    # feed_packed on the wire-format int16 buffer (the exact layout
    # matching._pack_slots emits: per row, k u8 codes + k offset low
    # bytes + packed 2-bit highs; band-1 frames then even-frame rescue
    # rows) == feed_split on the unpacked arrays. Also cross-checked
    # against the device packer + api._unpack_chunk below.
    import jax.numpy as jnp2
    from describealign_jax.alignment import api

    def pack_np(codes, offs_):
        nb_, rows_, k_ = codes.shape
        by = np.zeros((nb_, rows_, 2 * k_ + 2 * ((k_ // 4 + 1) // 2)),
                      np.uint8)
        by[:, :, :k_] = codes
        by[:, :, k_:2 * k_] = (offs_ & 255).astype(np.uint8)
        for j in range(k_):
            by[:, :, 2 * k_ + j // 4] |= (
                ((offs_[:, :, j].astype(np.int32) >> 8) & 3)
                << (2 * (j % 4))).astype(np.uint8)
        return by.view(np.int16).reshape(nb_, -1)

    packed = np.concatenate(
        [pack_np(c1, o1), pack_np(c2[:, ::2, :], o2[:, ::2, :])], axis=1)
    with lis.LisStream(key_bound) as s3:
        s3.feed_packed(packed, starts, a_base=420, blk=blk, k1=k1, k2=k2)
        v3, a3 = s3.finish()
    np.testing.assert_array_equal(v1, v3)
    np.testing.assert_array_equal(a1, a3)

    # a leading-columns VIEW of a wider buffer (the batch path's combined
    # transport rows carry trailing bitcast band starts) feeds in place
    # through the strided native entry - identical chain, no copy
    wide = np.concatenate(
        [packed, np.full((packed.shape[0], 6), -7, np.int16)], axis=1)
    view = wide[:, :-6]
    assert view.base is wide and not view.flags['C_CONTIGUOUS']
    with lis.LisStream(key_bound) as s4:
        s4.feed_packed(view, starts, a_base=420, blk=blk, k1=k1, k2=k2)
        v4, a4 = s4.finish()
    np.testing.assert_array_equal(v1, v4)
    np.testing.assert_array_equal(a1, a4)

    # feed_compact (the batch compact transport) == the dense feeds: sort
    # each frame's slots live-first (the device's top_k order guarantee),
    # compact to counts + live-prefix planes with globally packed 2-bit
    # offset highs, and check the chain is unchanged (per-frame candidate
    # multisets are order-independent)
    def sort_desc(codes, offs_):
        order = np.argsort(-codes.astype(np.int32), axis=-1, kind='stable')
        return (np.take_along_axis(codes, order, -1),
                np.take_along_axis(offs_, order, -1))

    c1s, o1s = sort_desc(c1, o1)
    c2s, o2s = sort_desc(c2[:, ::2, :], o2[:, ::2, :])

    def compact(codes, offs_):
        live = codes.reshape(-1, codes.shape[-1]) != 0
        cnt = live.sum(1)
        cflat = codes.reshape(-1, codes.shape[-1])[live]
        oflat = offs_.reshape(-1, offs_.shape[-1])[live].astype(np.int32)
        hi = np.zeros((len(cflat) + 3) // 4, np.uint8)
        p = np.arange(len(cflat))
        np.add.at(hi, p >> 2, ((oflat >> 8) & 3).astype(np.uint8)
                  << (2 * (p & 3)).astype(np.uint8))
        return cnt, cflat.astype(np.uint8), (oflat & 255).astype(np.uint8), hi

    cnt1, cc1, cl1, ch1 = compact(c1s, o1s)
    cnt2, cc2, cl2, ch2 = compact(c2s, o2s)
    counts = cnt1.reshape(nb, blk).astype(np.uint8)
    c2full = np.zeros((nb, blk), np.uint8)
    c2full[:, ::2] = cnt2.reshape(nb, blk // 2)
    counts = counts | (c2full << 4)
    starts_c = starts.copy()
    starts_c[:, 1] = starts_c[:, 0]       # band-1 half-groups share a start
    with lis.LisStream(key_bound) as s5:
        s5.feed_u8(np.concatenate([c1, c2], axis=2),
                   np.concatenate([o1, o2], axis=2), starts_c, a_base=420)
        v5, a5 = s5.finish()
    with lis.LisStream(key_bound) as s6:
        s6.feed_compact(counts.ravel(), cc1, cl1, ch1, cc2, cl2, ch2,
                        starts_c, blk=blk, a_base=420)
        v6, a6 = s6.finish()
    np.testing.assert_array_equal(v5, v6)
    np.testing.assert_array_equal(a5, a6)

    # the device packer produces this exact buffer, and _unpack_chunk
    # inverts it
    dev_packed = np.asarray(matching._pack_slots(jnp2.asarray(q1),
                                                 jnp2.asarray(o1)))
    np.testing.assert_array_equal(dev_packed, pack_np(c1, o1))
    full = np.concatenate([dev_packed,
                           np.asarray(matching._pack_slots(
                               jnp2.asarray(q2[:, ::2, :]),
                               jnp2.asarray(o2[:, ::2, :])))], axis=1)
    uq1, uo1, uq2, uo2 = api._unpack_chunk(full, k1, k2)
    np.testing.assert_array_equal(uq1, c1)
    np.testing.assert_array_equal(uo1, o1)
    np.testing.assert_array_equal(uq2, c2[:, ::2, :])
    np.testing.assert_array_equal(uo2, o2[:, ::2, :])


def random_points(rng, n_audio=1200, n_video=1300, n_clusters=4):
    """Cluster-shaped candidate points like pass 2 produces.

    Total qual must clear the DP's 1000-point jump threshold (reference
    973) for any path to be emitted at all - just like real media.
    """
    # like build_points: every audio frame inside a cluster's extended range
    # gets a point on that cluster's line (no gaps); quals are high inside
    # the truly-matching span and low elsewhere
    lines = []
    for c in range(n_clusters):
        span = (c * n_audio // n_clusters, (c + 1) * n_audio // n_clusters)
        lines.append((rng.uniform(0.95, 1.05), rng.uniform(0, 60), span))
    points = [[] for _ in range(n_audio)]
    for i in range(n_audio):
        for c, (slope, off, span) in enumerate(lines):
            j = slope * i + off
            if 0 <= j < n_video - 1:
                inside = span[0] <= i < span[1]
                q = rng.uniform(2.0, 8.0) if inside else rng.uniform(-1.0, 0.5)
                points[i].append((float(j), c, float(q)))
        points[i].sort()
    return points


@pytest.mark.parametrize('seed', [10, 11, 12])
def test_refine_dp_native_matches_python(seed):
    assert refine_dp_native_available()
    rng = np.random.default_rng(seed)
    points = random_points(rng)
    path_py = refine.refine_dp_py(points, 4, 1300)
    path_cc = refine_dp_native(points, 4, 1300)
    assert len(path_py) > 100
    assert path_py.shape == path_cc.shape
    # cum column may differ on the final (jump-penalized) entry; compare the
    # semantic columns
    np.testing.assert_allclose(path_py[:, :4], path_cc[:, :4], rtol=1e-12)


def test_native_cluster_scorer_matches_numpy(monkeypatch):
    """The C++ pass-2 cluster scorer (f64 fused-log10 pipeline) must match
    the numpy scoring on production-layout (f32, C-contiguous) inputs.

    Tolerances: the scorer fuses the three log10 terms into one and the
    offset-correction uses the rank-1 normal equations instead of numpy's
    SVD lstsq - both agree to ~1e-8 absolute, far below the pass-2 DP's
    50..1000-point decision scale."""
    from describealign_jax.alignment.native import native_lib
    if native_lib() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(7)
    na, nv = 4000, 4300
    audio_scaled = (rng.normal(0, 1, (na, 3)).cumsum(axis=0)
                    * 0.01).astype(np.float32)
    video_scaled = (rng.normal(0, 1, (nv, 3)).cumsum(axis=0)
                    * 0.01).astype(np.float32)
    # long clusters exercise the offset-correction branch too
    clusters = [(np.arange(50, 3500), 20.0, 1.001),
                (np.arange(100, 2000), -5.0, 0.999),
                (np.arange(1500, 3900), 40.0, 1.0),
                (np.arange(200, 280), 10.0, 1.002)]   # short: no correction
    a = refine.build_points_flat(clusters, audio_scaled, video_scaled)
    monkeypatch.setenv('DESCRIBEALIGN_NO_NATIVE_SCORER', '1')
    b = refine.build_points_flat(clusters, audio_scaled, video_scaled)
    np.testing.assert_array_equal(a[3], b[3])
    np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_allclose(a[2], b[2], rtol=1e-6, atol=1e-6)


def test_build_points_flat_matches_lists():
    """Vectorized flat point building == the semantic list version."""
    rng = np.random.default_rng(5)
    na, nv = 800, 850
    audio_scaled = rng.normal(0, 1, (na, 3)).cumsum(axis=0) * 0.01
    video_scaled = rng.normal(0, 1, (nv, 3)).cumsum(axis=0) * 0.01
    clusters = [(np.arange(50, 700), 20.0, 1.001),
                (np.arange(100, 400), -5.0, 0.999),
                (np.arange(300, 790), 40.0, 1.0)]
    pts = refine.build_points(clusters, audio_scaled, video_scaled)
    pj, pc, pq, offsets = refine.build_points_flat(clusters, audio_scaled,
                                                   video_scaled)
    from describealign_jax.alignment.refine_native import flat_from_points_lists
    pj2, pc2, pq2, off2 = flat_from_points_lists(pts)
    np.testing.assert_array_equal(offsets, off2)
    np.testing.assert_allclose(pj, pj2, rtol=1e-12)
    np.testing.assert_array_equal(pc, pc2)
    np.testing.assert_allclose(pq, pq2, rtol=1e-12)


def test_round6_matches_python_round():
    """The native format+parse round(v, 6) twin == the Python builtin on
    random and decimal-boundary values (incl. half-to-even ties)."""
    from describealign_jax.alignment.refine import _round6
    rng = np.random.default_rng(3)
    vals = np.concatenate([
        rng.uniform(-2.0, 2.0, 5000),
        rng.uniform(-1e9, 1e9, 500),
        np.array([0.9999995, 1.0000005, 0.1234565, -0.1234575,
                  2.5e-7, -2.5e-7, 0.0, -0.0, 1e13, np.inf, -np.inf]),
    ])
    assert _round6(vals) == [round(float(v), 6) for v in vals]


def test_round6_locale_independent():
    """Regression: the native rounder formats via snprintf, which under a
    comma-decimal LC_NUMERIC would emit '0,998700' and parse back 0.0;
    round_decimals6_f64 must pin the C locale. Skips when no such locale
    is installed (CI images often ship only C/C.utf8)."""
    import locale as pyloc
    from describealign_jax.alignment.refine import _round6
    old = pyloc.setlocale(pyloc.LC_NUMERIC)
    for name in ("de_DE.UTF-8", "de_DE.utf8", "fr_FR.UTF-8", "fr_FR.utf8"):
        try:
            pyloc.setlocale(pyloc.LC_NUMERIC, name)
            break
        except pyloc.Error:
            continue
    else:
        pytest.skip("no comma-decimal locale installed")
    try:
        assert _round6(np.array([0.9987, 1.2345675])) == [0.9987, 1.234568]
    finally:
        pyloc.setlocale(pyloc.LC_NUMERIC, old)


def test_python_dps_run_without_sortedcontainers():
    """The Python reference DPs use only the standard library: with
    sortedcontainers unimportable, the Python LIS equals the native one
    (duplicate video keys included) and the Python pass-2 DP equals its
    native twin."""
    import os
    import subprocess
    import sys
    code = """
import sys
sys.modules["sortedcontainers"] = None
import numpy as np
from describealign_jax.alignment import lis, refine
from describealign_jax.alignment.refine_native import refine_dp_native
rng = np.random.default_rng(7)
a = np.sort(rng.integers(0, 300, 3000))
v = a + rng.integers(-30, 31, 3000)
keep = v >= 0
a, v = a[keep], v[keep]
q = rng.uniform(0.05, 50.0, len(a))
order = np.lexsort((q, v, a))
a, v, q = a[order], v[order], q[order]
py = lis.weighted_lis_py(a, v, q)
cc = lis.weighted_lis_native(a, v, q)
assert all(np.array_equal(x, y) for x, y in zip(py, cc))
points = [sorted((float(i + off + rng.integers(-1, 2)), c,
                  float(rng.uniform(0.5, 8.0))) for c, off in ((0, 20), (1, 60)))
          for i in range(800)]
dp_py = refine.refine_dp_py(points, 2, 1000)
dp_cc = refine_dp_native(points, 2, 1000)
assert dp_py.shape == dp_cc.shape and len(dp_py) > 100
assert np.allclose(dp_py[:, :4], dp_cc[:, :4], rtol=1e-12)
print("ok")
"""
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, 'JAX_PLATFORMS': 'cpu'})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == 'ok'
