#!/usr/bin/env python
"""Hour-scale media dryrun: the streamed coarse DP must keep HBM bounded.

The reference aligns arbitrarily long media in ~630 MB of host RAM
(describealign.py:610-633 builds only per-frame hash dicts). Our coarse
pass materialized (blocks x lanes) score+cost tensors - ~14 GB at 3 hours.
matching._coarse_dp_streamed (auto-selected above
matching.coarse_stream_elems(), a share of the device's memory) streams
the score map in COARSE_CHUNK tiles with checkpointed cost rows instead.

This script builds a 3-hour synthetic pair at the FEATURE level (no PCM:
generating 3 h of 44.1 kHz audio on the bench host would dominate the run
and prove nothing about the device) with a planted lead-in and narration
insertions, then runs the full production streaming path (coarse + chunked
fine + streaming LIS + host stages) and checks the recovered offset.

With --memory it instead compiles match_coarse (nothing runs) at each
given length with the materialized and the streamed DP forced, and prints
XLA's scratch bytes per score-map element and the path the device's
limit picks: the readings behind matching.COARSE_BYTES_PER_ELEM.

Usage: python scripts/dryrun_longmedia.py [hours]
       python scripts/dryrun_longmedia.py --memory hours [hours ...]
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FPS = 210


def synth_feature_stream(n_frames, seed):
    """Plausible (5, n) f32 feature streams: smoothed positive noise with
    energy ~2-6 (above the 0.5 quiet gate) and enough frame-to-frame
    structure for windowed correlations to be selective."""
    rng = np.random.default_rng(seed)
    out = np.empty((5, n_frames), np.float32)
    for j in range(5):
        x = rng.standard_normal(n_frames).astype(np.float32)
        # ~8-frame smoothing: correlation length shorter than the 41-frame
        # match window, so descriptors are informative
        k = np.hanning(17)[1:-1].astype(np.float32)
        k /= k.sum()
        sm = np.convolve(x, k, mode='same')
        out[j] = 4.0 + 2.0 * sm / max(np.std(sm), 1e-6)
    return out


def _lanes(npad):
    from describealign_jax.alignment import matching
    return ((npad - 41 - max(matching.SUB_LANE_SHIFTS))
            // matching.COARSE_STRIDE + 1)


def memory_report(hours_list):
    import jax
    from describealign_jax.alignment import api, matching
    dev = jax.devices()[0]
    limit = matching.coarse_stream_elems()
    print(f"{dev.device_kind}: bytes_limit "
          f"{(dev.memory_stats() or {}).get('bytes_limit')}, coarse DP "
          f"streams above {limit} elements", flush=True)
    n = jax.ShapeDtypeStruct((), np.int32)
    for hours in hours_list:
        npad = api._bucket_pad(int(hours * 3600 * FPS))
        feats = jax.ShapeDtypeStruct((5, npad), np.float16)
        elems = matching.nb_for(npad) * _lanes(npad)
        for name, forced in (('materialized', 1 << 62), ('streamed', 0)):
            matching.COARSE_STREAM_ELEMS = forced
            jax.clear_caches()
            mem = matching.match_coarse.lower(
                feats, n, feats, n).compile().memory_analysis()
            temp = mem.temp_size_in_bytes
            print(f"{hours:g} h (npad {npad}, {elems} elements) {name}: "
                  f"temp {temp} B = {temp / elems:.3f} B/element",
                  flush=True)
        matching.COARSE_STREAM_ELEMS = None
        print(f"  this device's path: "
              f"{'streamed' if elems > limit else 'materialized'}",
              flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('hours', nargs='*', type=float)
    ap.add_argument('--memory', action='store_true')
    args = ap.parse_args()
    if args.memory:
        memory_report(args.hours or [0.45, 1.0, 2.0, 3.0])
        return
    hours = args.hours[0] if args.hours else 3.0
    import jax
    from describealign_jax.alignment import api, matching

    n_content = int(hours * 3600 * FPS)
    lead = int(202.0 * FPS)
    content = synth_feature_stream(n_content, seed=5)
    video = content
    audio_list = [synth_feature_stream(lead, seed=99)]
    # 12 narration insertions of 15 s
    cuts = np.linspace(0, n_content, 14).astype(int)[1:-1]
    prev = 0
    for i, c in enumerate(cuts):
        audio_list.append(content[:, prev:c])
        audio_list.append(synth_feature_stream(15 * FPS, seed=1000 + i))
        prev = c
    audio_list.append(content[:, prev:])
    audio = np.concatenate(audio_list, axis=1)
    na, nv = audio.shape[1], video.shape[1]
    npad = max(api._bucket_pad(na), api._bucket_pad(nv))

    def pad(f):
        out = np.zeros((5, npad), np.float32)
        out[:, :f.shape[1]] = f
        return out

    fa, fv = pad(audio), pad(video)
    kv = _lanes(npad)
    nb = matching.nb_for(npad)
    streamed = nb * kv > matching.coarse_stream_elems()
    print(f"{hours:.1f} h pair: na={na} nv={nv} npad={npad} "
          f"nb*kv={nb * kv / 1e6:.0f}M -> coarse path: "
          f"{'STREAMED' if streamed else 'materialized'}", flush=True)

    dev = jax.devices()[0]
    t0 = time.time()
    dev_a = jax.device_put(fa.astype(np.float16))
    dev_v = jax.device_put(fv.astype(np.float16))
    y, x, margin = api._streamed_lis(dev_a, na, dev_v, nv)
    res = api._host_stages_from_path(y, x, fa, fv, na, nv, 'native',
                                     quiet=True, margin=margin)
    wall = time.time() - t0
    audio_times, video_times, sim, path, slope = res[:5]
    offset = float(audio_times[0] - video_times[0])
    stats = {}
    try:
        stats = dev.memory_stats() or {}
    except Exception:
        pass
    peak = stats.get('peak_bytes_in_use')
    print(f"wall {wall:.1f}s (incl. compile on first run) | "
          f"similarity {sim:.1f}% | recovered offset {offset:.2f}s "
          f"(planted 202.00) | slope {slope:.6f} | "
          f"peak HBM {peak / 1e9 if peak else float('nan'):.2f} GB",
          flush=True)
    assert abs(offset - 202.0) < 1.0, "offset not recovered"
    print("DRYRUN OK")


if __name__ == "__main__":
    main()
