#!/usr/bin/env python
"""Device-time profile of the matcher on one GPU at the 22-min bucket.

One process, one card, on bench.build_scale_pair (22-min video, ~27-min
description):

1. warm align_from_pcm wall time, median of 5;
2. a jax.profiler trace of one warm align_from_pcm, reduced to device time
   per jitted program, the device's busy share of the call's wall time,
   and the fine pass's device time per FINE_CHUNK-block chunk and its share
   of that wall time;
3. what lax.top_k became in the compiled fine-chunk program;
4. an A/B of matching.DP_SCAN_UNROLL (8, 1, 1, 8) on match_coarse;
5. an A/B of matching.MATMUL_PRECISION (HIGHEST, DEFAULT, DEFAULT,
   HIGHEST; DEFAULT lets the card use TF32) on the streamed matcher, with
   the candidate sets and fit nodes of DEFAULT against HIGHEST.

    python scripts/profile_matcher_gpu.py [--trace-dir DIR]
"""
import argparse
import collections
import glob
import os
import statistics
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
import chip_smoke  # noqa: E402


def quiet_call(fn, *args, **kw):
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def timed(fn, n):
    out = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t)
    return out


def device_events(xplane_path):
    """(kernel name, hlo module, start ns, duration ns) of every event on
    the GPU planes of a trace."""
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(xplane_path)
    events, stat_keys = [], set()
    for plane in pd.planes:
        if not plane.name.startswith('/device:GPU'):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                stat_keys.update(stats)
                module = str(stats.get('hlo_module', stats.get(
                    'kernel_details', '?')))
                events.append((ev.name, module, ev.start_ns,
                               ev.duration_ns))
    return events, stat_keys


def busy_ns(events):
    spans = sorted((s, s + d) for _, _, s, d in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--trace-dir', default=None)
    args = ap.parse_args()
    import jax

    from describealign_jax.alignment import api, matching
    devices = chip_smoke.require_gpu()
    print(f"card: {bench.gpu_identity()}; jax {jax.__version__}")

    video, audio, sv, sa = chip_smoke.scale_pair()

    def align():
        return quiet_call(api.align_from_pcm, video, audio,
                          video_samples=sv, audio_samples=sa)

    t = time.perf_counter()
    align()
    print(f"\n[1] first align_from_pcm (incl. compile) "
          f"{time.perf_counter() - t:.3f} s")
    e2e = timed(align, 5)
    e2e_med = statistics.median(e2e)
    print(f"[1] warm align_from_pcm {e2e} s, median {e2e_med:.4f} s")

    trace_dir = args.trace_dir or tempfile.mkdtemp()
    with jax.profiler.trace(trace_dir):
        t = time.perf_counter()
        align()
        traced_wall = time.perf_counter() - t
    path = sorted(glob.glob(os.path.join(trace_dir, '**', '*.xplane.pb'),
                            recursive=True))[-1]
    events, stat_keys = device_events(path)
    print(f"\n[2] trace {path}: {len(events)} device events; stat keys "
          f"{sorted(stat_keys)}")
    by_module = collections.Counter()
    by_kernel = collections.Counter()
    for name, module, _, dur in events:
        by_module[module] += dur
        by_kernel[name] += dur
    print(f"[2] traced call wall {traced_wall:.4f} s; device busy "
          f"{busy_ns(events) / 1e9:.4f} s = "
          f"{busy_ns(events) / 1e9 / traced_wall:.3f} of the wall")
    for module, dur in by_module.most_common(12):
        print(f"[2]   module {module}: {dur / 1e6:.3f} ms")
    for name, dur in by_kernel.most_common(15):
        print(f"[2]   kernel {name[:90]}: {dur / 1e6:.3f} ms")
    fine_ns = sum(d for _, m, _, d in events if 'match_fine_chunk' in m)
    npad = max(api._bucket_pad(sv // 210), api._bucket_pad(sa // 210))
    n_chunks = -(-matching.nb_for(npad) // matching.FINE_CHUNK)
    print(f"[2] fine pass: {fine_ns / 1e6:.3f} ms device over {n_chunks} "
          f"chunks = {fine_ns / 1e6 / n_chunks:.3f} ms/chunk; "
          f"{fine_ns / 1e9 / e2e_med:.4f} of the median warm e2e wall")

    fv, nv = api.host_features_padded(video, sv, npad)
    fa, na = api.host_features_padded(audio, sa, npad)
    dev_a = jax.device_put(fa.astype(np.float16))
    dev_v = jax.device_put(fv.astype(np.float16))

    def matcher():
        chunks, st, _, m = matching.match_stream(dev_a, na, dev_v, nv)
        jax.block_until_ready((chunks, st, m))

    matcher()
    t_m = timed(matcher, 5)
    state = matching.match_coarse(dev_a, na, dev_v, nv)
    fine = lambda: jax.block_until_ready([  # noqa: E731
        matching.match_fine_chunk(*state[:7],
                                  np.int32(c * matching.FINE_CHUNK),
                                  np.int32(matching.nb_for(npad)))
        for c in range(n_chunks)])
    fine()
    t_f = timed(fine, 5)
    print(f"[2] host clock: streamed matcher median "
          f"{statistics.median(t_m) * 1e3:.3f} ms; {n_chunks} fine chunks "
          f"median {statistics.median(t_f) * 1e3:.3f} ms = "
          f"{statistics.median(t_f) * 1e3 / n_chunks:.3f} ms/chunk")

    hlo = matching.match_fine_chunk.lower(
        *state[:7], np.int32(0), np.int32(1)).compile().as_text()
    lines = [ln.strip() for ln in hlo.splitlines()
             if any(k in ln.lower() for k in ('topk', 'top_k', ' sort('))]
    print(f"\n[3] top_k in compiled match_fine_chunk: {len(lines)} lines")
    for ln in lines[:6]:
        print(f"[3]   {ln[:200]}")

    def coarse():
        jax.block_until_ready(matching.match_coarse(dev_a, na, dev_v, nv))

    print()
    for unroll in (8, 1, 1, 8):
        matching.DP_SCAN_UNROLL = unroll
        jax.clear_caches()
        t = time.perf_counter()
        coarse()
        first = time.perf_counter() - t
        ts = timed(coarse, 5)
        print(f"[4] DP_SCAN_UNROLL={unroll}: match_coarse first "
              f"{first:.3f} s, warm median "
              f"{statistics.median(ts) * 1e3:.3f} ms {ts}")
    matching.DP_SCAN_UNROLL = 8

    print()
    highest = jax.lax.Precision.HIGHEST
    ref = None
    for prec in (highest, jax.lax.Precision.DEFAULT,
                 jax.lax.Precision.DEFAULT, highest):
        matching.MATMUL_PRECISION = prec
        jax.clear_caches()
        matcher()
        ts = timed(matcher, 5)
        e2e_p = timed(align, 3)
        got = chip_smoke.match_on(devices[0], fa, na, fv, nv)
        cands = chip_smoke.candidate_dict(*got[2:])
        nodes = chip_smoke.nodes_of(*got[1:], fa, fv, na, nv)
        line = (f"[5] {prec}: matcher median "
                f"{statistics.median(ts) * 1e3:.3f} ms, e2e median "
                f"{statistics.median(e2e_p):.4f} s")
        if ref is None:
            ref = (got, cands, nodes)
        else:
            diff = len(set(cands) ^ set(ref[1]))
            shared = set(cands) & set(ref[1])
            rel = np.array([abs(cands[k] - ref[1][k]) / ref[1][k]
                            for k in shared])
            same_len = len(nodes[0]) == len(ref[2][0])
            err = (max(np.max(np.abs(nodes[0] - ref[2][0])),
                       np.max(np.abs(nodes[1] - ref[2][1])))
                   if same_len else float('inf'))
            line += (f"; vs HIGHEST: coarse lanes differ "
                     f"{int(np.sum(got[0] != ref[0][0]))}, candidates "
                     f"{len(cands)} vs {len(ref[1])}, sym diff {diff}, "
                     f"qual rel p99 {np.percentile(rel, 99):.3e} max "
                     f"{rel.max():.3e}, nodes {len(nodes[0])} vs "
                     f"{len(ref[2][0])} max |diff| {err:.3e} s")
        print(line, flush=True)
    matching.MATMUL_PRECISION = highest


if __name__ == '__main__':
    main()
