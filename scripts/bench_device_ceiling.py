#!/usr/bin/env python
"""Device-side throughput ceiling of the batch matcher.

Dispatches the default batch device programs (match_stream_pair +
concat_chunks_compact) for all 8 bench pairs back-to-back and pulls only
each pair's 4-byte compact header (forcing execution without the big
D2H), so the wall measures what the device sustains when the host and
transfers are not the bottleneck: per-device capability vs the host
floor.

Usage: python scripts/bench_device_ceiling.py [reps=3]
"""
import json
import os
import sys
import time

import numpy as np


def main():
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import io
    from contextlib import redirect_stdout

    import jax

    from bench import build_batch_pairs
    from describealign_jax.alignment import api, matching

    quiet = io.StringIO()
    pairs, lens, planted, kinds = build_batch_pairs()
    batch_minutes = sum(s_a / 44100.0 / 60.0 for (_, s_a) in lens)

    # stage features once (host cost excluded from the timed section)
    staged = []
    for (v, a), (sv, sa) in zip(pairs, lens):
        npad = max(api._bucket_pad(sv // 210), api._bucket_pad(sa // 210))
        fv, nv = api.host_features_padded(v, sv, npad)
        fa, na = api.host_features_padded(a, sa, npad)
        fav = np.empty((2, 5, npad), np.float16)
        fav[0] = fa
        fav[1] = fv
        staged.append((fav, na, nv))

    def one_run():
        outs = []
        for fav, na, nv in staged:
            dev_av = jax.device_put(fav)
            chunks, starts_dev, _, margin_dev = matching.match_stream_pair(
                dev_av, na, nv)
            outs.append(matching.concat_chunks_compact(chunks, starts_dev,
                                                       margin_dev)[0])
        # pull only the 4-byte headers: forces every program to finish
        # without paying the multi-MB transfers
        return [np.asarray(o[:4]) for o in outs]

    with redirect_stdout(quiet):
        one_run()                                  # warm/compile
    best = float('inf')
    for _ in range(reps):
        t = time.time()
        with redirect_stdout(quiet):
            one_run()
        best = min(best, time.time() - t)
    print(json.dumps({
        "metric": "batch8_device_ceiling",
        "best_wall_s": round(best, 3),
        "device_s_per_pair": round(best / len(staged), 3),
        "audio_min_per_s_per_chip_ceiling": round(batch_minutes / best, 2),
        "note": "includes H2D uploads; excludes big D2H + host stages",
    }), flush=True)


if __name__ == "__main__":
    main()
