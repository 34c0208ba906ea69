#!/usr/bin/env python
"""Dev profiling: per-stage breakdown of the host-feature fast path +
host refinement stages, on the bench pair."""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    from describealign_jax.alignment import continuity, fit, lis, matching, \
        outputs, refine
    from describealign_jax.alignment.api import (_bucket_pad, _fail_if_short,
                                                 host_features_padded)
    from describealign_jax.alignment.refine_native import refine_dp_flat

    from scripts.profile_e2e import load_pair
    video, audio, sv, sa = load_pair()
    na, nv = sa // 210, sv // 210
    npad = max(_bucket_pad(sv // 210), _bucket_pad(sa // 210))

    def once(tag):
        t = {}
        t0 = time.time()
        fv, nv_ = host_features_padded(video, sv, npad)
        t['feat_v'] = time.time() - t0

        t0 = time.time()
        dev_v = jax.device_put(fv)
        fa, na_ = host_features_padded(audio, sa, npad)
        t['feat_a'] = time.time() - t0

        t0 = time.time()
        dev_a = jax.device_put(fa)
        out = matching.match_from_features(dev_a, na_, dev_v, nv_)
        np.asarray(out[0][0, 0, 0])          # wait for compute (1-elem pull)
        t['h2d+compute'] = time.time() - t0

        t0 = time.time()
        quals = np.asarray(out[0])
        offs = np.asarray(out[1])
        starts = np.asarray(out[2])
        t['d2h'] = time.time() - t0
        mb = (quals.nbytes + offs.nbytes + starts.nbytes) / 1e6

        t0 = time.time()
        y, x = lis.lis_from_match(quals, offs, starts)
        t['lis'] = time.time() - t0
        ncand = int((quals > 0).sum())

        t0 = time.time()
        x, y = continuity.continuity_filter(
            np.asarray(x, np.float64), np.asarray(y, np.float64))
        t['continuity'] = time.time() - t0

        t0 = time.time()
        audio_scaled_list, video_scaled_list = [], []
        yi = y.astype(np.int64)
        xi = x.astype(np.int64)
        for j in range(5):
            vf = fv[j, :nv_].astype(np.float64)
            af = fa[j, :na_].astype(np.float64)
            af_std = np.std(af)
            vy = vf[yi]
            scale = np.dot(vy, af[xi]) / np.maximum(np.dot(vy, vy), 1e-30)
            audio_scaled_list.append(af / af_std)
            video_scaled_list.append(vf * (scale / af_std))
        audio_scaled = np.stack(audio_scaled_list[:3], axis=1)
        video_scaled = np.stack(video_scaled_list[:3], axis=1)
        t['rescale'] = time.time() - t0

        t0 = time.time()
        cx, cy = continuity.compress_path(x, y)
        fit_result = fit.solve_l1_fit(cx, cy, backend='native')
        smooth_path = list(zip(cx, fit_result['smooth_y']))
        t['fit'] = time.time() - t0

        t0 = time.time()
        clusters = refine.build_line_clusters(smooth_path,
                                              fit_result['slopes'])
        t['clusters'] = time.time() - t0
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

        total = sum(t.values())
        print(f"[{tag}] total {total:.2f}s | d2h {mb:.1f}MB | "
              f"cands {ncand/1e6:.2f}M")
        print("  " + " | ".join(f"{k} {v:.3f}" for k, v in t.items()),
              flush=True)

    once("warmup")
    for i in range(3):
        once(f"iter{i}")


if __name__ == "__main__":
    main()
