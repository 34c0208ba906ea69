#!/usr/bin/env python
"""Interleaved A/B of the batch pull strategy on the device.

sliced = main-thread lag-2 occupancy-exact prefix slice (default)
whole  = one whole-buffer pull per pair (round-5 default before sliced)
exact  = two-phase occupancy-exact pull from the pull pool

Interleaves A B A B ... so drift over the run hits both arms equally;
prints per-rep walls and min/median per arm.

Usage: python scripts/ab_batch_pull.py [reps=4]
"""
import io
import os
import sys
import time
from contextlib import redirect_stdout

import numpy as np


def main():
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from bench import build_batch_pairs
    from describealign_jax.alignment.api import align_batch_from_pcm

    quiet = io.StringIO()
    pairs, lens, planted, kinds = build_batch_pairs()
    batch_minutes = sum(s_a / 44100.0 / 60.0 for (_, s_a) in lens)

    arms = {'sliced': {'DESCRIBEALIGN_BATCH_PULL': 'sliced'},
            'whole': {'DESCRIBEALIGN_BATCH_PULL': 'whole'},
            'exact': {'DESCRIBEALIGN_BATCH_PULL': 'exact'}}
    walls = {k: [] for k in arms}
    base = None
    # warm both arms (compile + cache) before timing
    for name, env in arms.items():
        os.environ.pop('DESCRIBEALIGN_BATCH_PULL', None)
        os.environ.update(env)
        with redirect_stdout(quiet):
            r = align_batch_from_pcm(pairs, true_samples=lens)
        if base is None:
            base = r
        else:
            for (x0, y0, *_), (x1, y1, *_) in zip(base, r):
                assert np.allclose(x0, x1) and np.allclose(y0, y1), \
                    "arms disagree - not path-equivalent"
    for rep in range(reps):
        for name, env in arms.items():
            os.environ.pop('DESCRIBEALIGN_BATCH_PULL', None)
            os.environ.update(env)
            t = time.time()
            with redirect_stdout(quiet):
                align_batch_from_pcm(pairs, true_samples=lens)
            w = time.time() - t
            walls[name].append(w)
            print(f"rep {rep} {name:8s} {w:6.2f}s "
                  f"({batch_minutes / w:5.2f} amin/s)", flush=True)
    for name in arms:
        ws = sorted(walls[name])
        print(f"{name:8s} min={ws[0]:6.2f}s ({batch_minutes / ws[0]:5.2f} "
              f"amin/s) median={ws[len(ws) // 2]:6.2f}s")


if __name__ == "__main__":
    main()
