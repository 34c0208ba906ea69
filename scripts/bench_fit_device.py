#!/usr/bin/env python
"""Dev benchmark: the three L1-fit backends on real bench-scale nodes.

fit_device (JAX ADMM + cyclic reduction) is stress-tested on the CPU
backend; this times it on the device and measures all three
backends on the compressed node set the 22-min bench pair actually
produces, plus a denser synthetic set, and checks result agreement.
Run solo on the GPU host.
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts.profile_e2e import load_pair  # noqa: E402


def bench_nodes(cx, cy, tag, reps=5):
    from describealign_jax.alignment import fit

    results = {}
    for backend in ('native', 'device', 'highs'):
        # warm (compile for device)
        r = fit.solve_l1_fit(cx, cy, backend=backend)
        times = []
        for _ in range(reps):
            t = time.time()
            r = fit.solve_l1_fit(cx, cy, backend=backend)
            times.append(time.time() - t)
        results[backend] = (min(times), r)
        print(f"  [{tag}] {backend:7s} min {min(times)*1000:7.1f} ms "
              f"median_slope {r['median_slope']:.6f}", flush=True)
    # agreement vs the exact LP
    ref = results['highs'][1]
    for backend in ('native', 'device'):
        r = results[backend][1]
        dy = np.abs(r['smooth_y'] - ref['smooth_y'])
        print(f"  [{tag}] {backend} vs highs: max |smooth_y| diff "
              f"{dy.max():.4f} frames, slope diff "
              f"{abs(r['median_slope'] - ref['median_slope']):.2e}",
              flush=True)


def main():
    import jax
    from describealign_jax.alignment import api, continuity
    print("backend:", jax.default_backend(), flush=True)

    video, audio, sv, sa = load_pair()
    npad = max(api._bucket_pad(sv // 210), api._bucket_pad(sa // 210))
    fv, nv_ = api.host_features_padded(video, sv, npad)
    fa, na_ = api.host_features_padded(audio, sa, npad)
    import jax.numpy  # noqa: F401
    dev_v = jax.device_put(fv.astype(np.float16))
    dev_a = jax.device_put(fa.astype(np.float16))
    y, x = api._streamed_lis(dev_a, na_, dev_v, nv_)
    x2, y2 = continuity.continuity_filter(
        np.asarray(x, np.float64), np.asarray(y, np.float64))
    cx, cy = continuity.compress_path(x2, y2)
    print(f"bench pair nodes: {len(cx)}", flush=True)
    bench_nodes(cx, cy, "bench-pair")

    # denser synthetic node set (skip-heavy low-similarity shape)
    rng = np.random.default_rng(0)
    n = 6000
    xs = np.cumsum(rng.uniform(5, 80, n))
    ys = xs * 1.01 + 40.0
    for j in range(6):                     # offset jumps
        ys[int(n * (j + 1) / 7):] -= rng.uniform(200, 900)
    ys += rng.standard_normal(n) * 1.2
    print(f"synthetic nodes: {n}", flush=True)
    bench_nodes(xs, ys, "synthetic")


if __name__ == "__main__":
    main()
