"""Sweep batch scheduling knobs (device_depth x host_workers) on the GPU
to find how much unhidden device wait a deeper pipeline recovers. Run SOLO (no concurrent jobs). Usage:

    python scripts/sweep_batch_sched.py [reps]

Prints one line per config: depth, workers, best wall, audio-min/s.
"""
import sys
import time

import numpy as np


def main():
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    sys.path.insert(0, ".")
    from bench import build_batch_pairs
    from describealign_jax.alignment.api import align_batch_from_pcm

    pairs, lens, planted, kinds = build_batch_pairs()
    batch_minutes = sum(s_a / 44100.0 / 60.0 for (_, s_a) in lens)

    # warm every bucket once (compile + cache)
    align_batch_from_pcm(pairs, true_samples=lens)

    configs = [(2, 2), (3, 2), (4, 2), (2, 3), (3, 3), (4, 3), (6, 3)]
    results = []
    for depth, workers in configs:
        best = float("inf")
        for _ in range(reps):
            t = time.time()
            out = align_batch_from_pcm(pairs, true_samples=lens,
                                       device_depth=depth,
                                       host_workers=workers)
            best = min(best, time.time() - t)
            assert len(out) == len(pairs)
        rate = batch_minutes / best
        results.append((depth, workers, best, rate))
        print(f"depth={depth} workers={workers}  wall={best:6.2f} s  "
              f"rate={rate:5.2f} audio-min/s", flush=True)
    best = max(results, key=lambda r: r[3])
    print(f"BEST: depth={best[0]} workers={best[1]} "
          f"rate={best[3]:.2f} audio-min/s")


if __name__ == "__main__":
    main()
