#!/usr/bin/env python
"""Depth/pull-thread sweep for the default batch config (chunked dispatch
+ compact transport) on the device: re-tunes device_depth. One JSON line
per config.

Usage: python scripts/sweep_batch_depth.py [reps=3] [depths=3,4,6,8]
"""
import json
import os
import sys
import time


def main():
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    depths = ([int(d) for d in sys.argv[2].split(',')]
              if len(sys.argv) > 2 else [3, 4, 6, 8])
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import io
    from contextlib import redirect_stdout

    from bench import build_batch_pairs
    from describealign_jax.alignment.api import align_batch_from_pcm

    quiet = io.StringIO()
    pairs, lens, planted, kinds = build_batch_pairs()
    batch_minutes = sum(s_a / 44100.0 / 60.0 for (_, s_a) in lens)

    # warm with the default depth
    with redirect_stdout(quiet):
        align_batch_from_pcm(pairs, true_samples=lens)
    for depth in depths:
        walls = []
        cpu0 = time.process_time()
        for _ in range(reps):
            t = time.time()
            with redirect_stdout(quiet):
                align_batch_from_pcm(pairs, true_samples=lens,
                                     device_depth=depth)
            walls.append(time.time() - t)
        cpu = time.process_time() - cpu0
        best = min(walls)
        print(json.dumps({
            "depth": depth,
            "walls": [round(w, 3) for w in walls],
            "best_wall_s": round(best, 3),
            "audio_min_per_s_per_chip": round(batch_minutes / best, 2),
            "cpu_s_per_pair_avg": round(cpu / reps / len(pairs), 3),
        }), flush=True)


if __name__ == "__main__":
    main()
