#!/usr/bin/env python
"""A/B the batch-path transport/dispatch levers on the device.

Sweeps {fused one-dispatch matcher} x {compact transport} (and optionally
device_depth) over the bench batch (8 distinct feature-length pairs,
bench.py::build_batch_pairs) and prints one JSON line per config with the
best-of-N wall and derived audio-min/s/chip.

Usage: python scripts/bench_batch_ab.py [reps=2] [depths=4]
"""
import json
import os
import sys
import time


def main():
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    depths = ([int(d) for d in sys.argv[2].split(',')]
              if len(sys.argv) > 2 else [4])
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from bench import build_batch_pairs
    from describealign_jax.alignment.api import align_batch_from_pcm

    import io
    from contextlib import redirect_stdout
    quiet = io.StringIO()

    pairs, lens, planted, kinds = build_batch_pairs()
    batch_minutes = sum(s_a / 44100.0 / 60.0 for (_, s_a) in lens)

    configs = [(f, c) for f in ('1', '0') for c in ('0', '1')]
    baseline_results = None
    for fused, compact in configs:
        os.environ['DESCRIBEALIGN_FUSED_BATCH'] = fused
        os.environ['DESCRIBEALIGN_COMPACT'] = compact
        for depth in depths:
            # warm (compile) outside the timed reps
            with redirect_stdout(quiet):
                results = align_batch_from_pcm(pairs, true_samples=lens,
                                               device_depth=depth)
            if baseline_results is None:
                baseline_results = results
            else:
                # every config must be path-equivalent: identical maps
                import numpy as np
                for r0, r1 in zip(baseline_results, results):
                    assert np.allclose(np.asarray(r0[0]), np.asarray(r1[0]))
                    assert np.allclose(np.asarray(r0[1]), np.asarray(r1[1]))
            best = float('inf')
            walls = []
            for _ in range(reps):
                t = time.time()
                with redirect_stdout(quiet):
                    align_batch_from_pcm(pairs, true_samples=lens,
                                         device_depth=depth)
                walls.append(time.time() - t)
                best = min(best, walls[-1])
            cpu0 = time.process_time()
            t = time.time()
            with redirect_stdout(quiet):
                align_batch_from_pcm(pairs, true_samples=lens,
                                     device_depth=depth)
            wall_cpu = time.time() - t
            cpu = time.process_time() - cpu0
            print(json.dumps({
                "fused": fused, "compact": compact, "depth": depth,
                "walls": [round(w, 3) for w in walls],
                "best_wall_s": round(best, 3),
                "audio_min_per_s_per_chip": round(batch_minutes / best, 2),
                "cpu_s_probe": round(cpu, 3),
                "wall_s_probe": round(wall_cpu, 3),
                "cpu_s_per_pair": round(cpu / len(pairs), 3),
            }), flush=True)


if __name__ == "__main__":
    main()
