#!/usr/bin/env python
"""Dev microbenchmark: the C++ streaming LIS feed at bench-pair scale.

Synthesizes a realistic candidate stream (mostly-monotone video track +
jitter + low-quality clutter, matching the matcher's band-1/rescue
volumes at 22-min scale) and times lis_stream_feed_split end-to-end.
Run AS THE ONLY load on the host (the box has one core).

    python scripts/bench_lis.py [n_frames]
"""
import os
import sys
import time

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from describealign_jax.alignment import lis  # noqa: E402


def main():
    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 277_000
    k1, k2 = 8, 8           # band-1 slots / frame, rescue slots / even frame
    blk = 210
    nb = n_frames // blk
    rng = np.random.default_rng(7)

    # band-1: quality codes 1..255 (0 = empty), ~70% occupancy; offsets
    # wander around a monotone track
    q1 = rng.integers(0, 256, (nb, blk, k1), dtype=np.uint8)
    q1[rng.uniform(size=q1.shape) < 0.3] = 0
    o1 = rng.integers(0, 768, (nb, blk, k1), dtype=np.int16)
    # rescue: half-height, sparser
    q2 = rng.integers(0, 256, (nb, blk // 2, k2), dtype=np.uint8)
    q2[rng.uniform(size=q2.shape) < 0.6] = 0
    o2 = rng.integers(0, 768, (nb, blk // 2, k2), dtype=np.int16)
    # production grouping: 2 band-1 groups (k-best tracks) + 2 rescue bands
    base = (np.arange(nb, dtype=np.int32) * blk)[:, None]
    starts = np.concatenate(
        [base, base + 380, base - 250, base + 610], axis=1)    # (nb, 4)
    starts = np.maximum(starts, 0).astype(np.int32)

    n_cand = int((q1 > 0).sum() + (q2 > 0).sum())
    cap = n_frames + 768 + 620 + 2
    chunk = 256                       # production FINE_CHUNK
    best = None
    for rep in range(5):
        ctx = lis.LisStream(cap)
        t = time.time()
        for b0 in range(0, nb, chunk):
            b1 = min(b0 + chunk, nb)
            ctx.feed_split(q1[b0:b1], o1[b0:b1], q2[b0:b1], o2[b0:b1],
                           starts[b0:b1], b0 * blk)
        y, x = ctx.finish()
        dt = time.time() - t
        best = dt if best is None else min(best, dt)
        print(f"rep {rep}: {dt:.3f}s  ({n_cand/dt/1e6:.2f} Mcand/s, "
              f"chain {len(x)})", flush=True)
    print(f"best: {best:.3f}s for {n_cand} candidates "
          f"({n_cand/best/1e6:.2f} Mcand/s)")


if __name__ == "__main__":
    main()
