#!/usr/bin/env python
"""Dev profiling: event-level breakdown of the DEFAULT (streamed) path.

Times each phase of align_from_pcm's production configuration on the real
GPU: host feature extraction, uploads, coarse dispatch, per-chunk compute
-ready + pull + LIS feed, then every host tail stage. Run solo
(concurrent runs distort timings).
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts.profile_e2e import load_pair  # noqa: E402


def main():
    import jax
    from concurrent.futures import ThreadPoolExecutor
    from describealign_jax.alignment import (api, continuity, fit, lis,
                                             matching, outputs, refine)
    from describealign_jax.alignment.refine_native import refine_dp_flat

    video, audio, sv, sa = load_pair()
    na, nv = sa // 210, sv // 210
    npad = max(api._bucket_pad(sv // 210), api._bucket_pad(sa // 210))

    def cpu_s():
        return time.process_time()

    def once(tag):
        t = {}
        c0_all = cpu_s()
        t0 = time.time()
        fv, nv_ = api.host_features_padded(video, sv, npad)
        t['feat_v'] = time.time() - t0
        t0 = time.time()
        dev_v = jax.device_put(fv.astype(np.float16))
        fa, na_ = api.host_features_padded(audio, sa, npad)
        dev_a = jax.device_put(fa.astype(np.float16))
        t['feat_a+h2d'] = time.time() - t0

        t0 = time.time()
        chunks, starts_dev, n_chunks, _ = matching.match_stream(
            dev_a, na_, dev_v, nv_)
        t['dispatch'] = time.time() - t0

        pull_times = []
        feed_times = []

        def pull(ch):
            tp = time.time()
            arr = np.asarray(ch)
            pull_times.append(time.time() - tp)
            return arr

        t0 = time.time()
        with ThreadPoolExecutor(api._pull_threads()) as pool:
            futs = [pool.submit(pull, ch) for ch in chunks]
            starts_tracks = np.asarray(starts_dev)

            def timed_iter():
                for f in futs:
                    arr = f.result()
                    tf = time.time()
                    yield arr
                    feed_times.append(time.time() - tf)

            y, x = api._consume_stream(timed_iter(), starts_tracks)
        t['stream_total'] = time.time() - t0
        t['  pull_sum'] = sum(pull_times)
        t['  feed_sum'] = sum(feed_times)

        t0 = time.time()
        x2, y2 = continuity.continuity_filter(
            np.asarray(x, np.float64), np.asarray(y, np.float64))
        t['continuity'] = time.time() - t0

        t0 = time.time()
        audio_scaled_list, video_scaled_list = [], []
        yi = y2.astype(np.int64)
        xi = x2.astype(np.int64)
        for j in range(5):
            vf = fv[j, :nv_].astype(np.float64)
            af = fa[j, :na_].astype(np.float64)
            af_std = np.std(af)
            vy = vf[yi]
            scale = np.dot(vy, af[xi]) / np.maximum(np.dot(vy, vy), 1e-30)
            audio_scaled_list.append((af / af_std).astype(np.float32))
            video_scaled_list.append(
                (vf * (scale / af_std)).astype(np.float32))
        audio_scaled = np.stack(audio_scaled_list[:3], axis=1)
        video_scaled = np.stack(video_scaled_list[:3], axis=1)
        t['rescale'] = time.time() - t0

        t0 = time.time()
        cx, cy = continuity.compress_path(x2, y2)
        t['compress'] = time.time() - t0
        t0 = time.time()
        fit_result = fit.solve_l1_fit(cx, cy, backend='native')
        smooth_path = list(zip(cx, fit_result['smooth_y']))
        t['fit'] = time.time() - t0

        t0 = time.time()
        clusters = refine.build_line_clusters(smooth_path,
                                              fit_result['slopes'])
        t['p2_clusters'] = time.time() - t0
        t0 = time.time()
        pj, pc, pq, offsets = refine.build_points_flat(
            clusters, audio_scaled, video_scaled)
        t['p2_score'] = time.time() - t0
        t0 = time.time()
        path = refine_dp_flat(pj, pc, pq, offsets, len(clusters),
                              len(video_scaled))
        t['p2_dp'] = time.time() - t0
        t0 = time.time()
        outputs.similarity_and_nodes(path, len(audio_scaled),
                                     len(video_scaled), na_, nv_)
        t['outputs'] = time.time() - t0

        wall = sum(v for k, v in t.items() if not k.startswith('  '))
        cpu = cpu_s() - c0_all
        print(f"[{tag}] wall-sum {wall:.2f}s | host-CPU {cpu:.2f}s | "
              f"chunks {len(pull_times)}")
        print("  " + " | ".join(f"{k.strip()} {v:.3f}" for k, v in t.items()),
              flush=True)

    once("warmup")
    for i in range(3):
        once(f"iter{i}")


if __name__ == "__main__":
    main()
