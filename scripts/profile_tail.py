#!/usr/bin/env python
"""Dev profiling: per-stage timing of the host refinement tail.

Runs the production matcher once (on the GPU) to get a genuine LIS path for
the bench pair, then times each _host_stages_from_path stage in a loop on
the host. Run solo. Usage: python scripts/profile_tail.py [reps]
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    from describealign_jax.alignment import api, continuity, fit, refine
    from describealign_jax.alignment.refine_native import refine_dp_flat

    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    from scripts.profile_e2e import load_pair
    video, audio, sv, sa = load_pair()
    npad = max(api._bucket_pad(sv // 210), api._bucket_pad(sa // 210))
    fv, nv = api.host_features_padded(video, sv, npad)
    dev_v = jax.device_put(fv.astype(np.float16))
    fa, na = api.host_features_padded(audio, sa, npad)
    dev_a = jax.device_put(fa.astype(np.float16))
    y0, x0 = api._streamed_lis(dev_a, na, dev_v, nv)
    print(f"path len {len(x0)}")

    best = {}
    for _ in range(reps):
        t0 = time.time()
        x, y = continuity.continuity_filter(
            np.asarray(x0, np.float64), np.asarray(y0, np.float64))
        t1 = time.time()
        yi = np.ascontiguousarray(y, np.int64)
        xi = np.ascontiguousarray(x, np.int64)
        audio_scaled = np.empty((na, 3), np.float32)
        video_scaled = np.empty((nv, 3), np.float32)
        assert api._rescale_native(fa, fv, na, nv, xi, yi,
                                   audio_scaled, video_scaled)
        t2 = time.time()
        cx, cy = continuity.compress_path(x, y)
        t3 = time.time()
        fit_result = fit.solve_l1_fit(cx, cy, backend='native')
        t4 = time.time()
        smooth_path = list(zip(cx, fit_result['smooth_y']))
        clusters = refine.build_line_clusters(smooth_path, fit_result['slopes'])
        t5 = time.time()
        pj, pc, pq, offsets = refine.build_points_flat(clusters, audio_scaled,
                                                       video_scaled)
        t6 = time.time()
        path = refine_dp_flat(pj, pc, pq, offsets, len(clusters),
                              len(video_scaled))
        t7 = time.time()
        from describealign_jax.alignment import outputs
        outputs.similarity_and_nodes(path, len(audio_scaled),
                                     len(video_scaled), na, nv)
        t8 = time.time()
        for k, v in (('continuity', t1 - t0), ('rescale', t2 - t1),
                     ('compress', t3 - t2), ('fit', t4 - t3),
                     ('clusters', t5 - t4), ('p2_score', t6 - t5),
                     ('p2_dp', t7 - t6), ('outputs', t8 - t7),
                     ('TOTAL', t8 - t0)):
            best[k] = min(best.get(k, 1e9), v)
    for k, v in best.items():
        print(f"{k:11s} {v:7.4f} s")


if __name__ == "__main__":
    main()
