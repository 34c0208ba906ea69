#!/usr/bin/env python
"""The round-3 review's batched-ADMM experiment: does ONE vmapped device
dispatch for all pairs' L1 fits beat the native host cascade in the batch
regime?

fit_device loses ~76x to the native cascade per-pair on real hardware
because its cost is 800 sequential scan iterations of log2(N) cyclic-
reduction levels - tiny vectors, pure iteration latency (PERF.md). vmap
makes every iteration process B problems at once, so the latency amortizes
B-fold. This measures: native x B (host, sequential), device x B
(sequential dispatches), device batched (solve_l1_fit_device_batched), and
checks result agreement. Run solo on the GPU.

Usage: python scripts/bench_fit_batched.py [B] [reps]
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_node_set(seed, n=5800):
    """Bench-pair-shaped node sets: ~5.8k compressed nodes, slope ~1,
    a few hundred-frame offset jumps, unit noise."""
    rng = np.random.default_rng(seed)
    xs = np.cumsum(rng.uniform(5, 80, n))
    ys = xs * rng.uniform(0.97, 1.03) + rng.uniform(-500, 500)
    for j in range(rng.integers(2, 7)):
        ys[int(n * rng.uniform(0.1, 0.9)):] -= rng.uniform(200, 900)
    ys += rng.standard_normal(n) * 1.2
    return xs, ys


def main():
    import jax
    from describealign_jax.alignment import fit
    from describealign_jax.alignment.fit_device import (
        solve_l1_fit_device, solve_l1_fit_device_batched)

    B = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    print("backend:", jax.default_backend(), flush=True)
    node_sets = [make_node_set(100 + i) for i in range(B)]

    # warm compiles
    solve_l1_fit_device(*node_sets[0])
    solve_l1_fit_device_batched(node_sets)

    def timed(tag, fn):
        best = float('inf')
        for _ in range(reps):
            t = time.time()
            out = fn()
            best = min(best, time.time() - t)
        print(f"{tag:18s} {best * 1000:8.1f} ms total  "
              f"{best * 1000 / B:7.1f} ms/pair", flush=True)
        return out

    r_nat = timed("native x B", lambda: [
        fit.solve_l1_fit(x, y, backend='native') for x, y in node_sets])
    r_seq = timed("device x B", lambda: [
        solve_l1_fit_device(x, y) for x, y in node_sets])
    r_bat = timed("device batched", lambda: solve_l1_fit_device_batched(
        node_sets))

    for i in range(B):
        dsb = np.abs(r_bat[i]['smooth_y'] - r_seq[i]['smooth_y']).max()
        dnb = np.abs(r_bat[i]['smooth_y'] - r_nat[i]['smooth_y']).max()
        print(f"pair {i}: batched-vs-seq-device max|dy| {dsb:9.2e}  "
              f"batched-vs-native {dnb:9.2e}  slopes "
              f"{r_bat[i]['median_slope']:.6f}/{r_nat[i]['median_slope']:.6f}",
              flush=True)


if __name__ == "__main__":
    main()
