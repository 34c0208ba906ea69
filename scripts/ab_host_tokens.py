#!/usr/bin/env python
"""Dev A/B: host-compute token count x pool workers on the device.

Alternates configs within one process (interleaving spreads drift over
all configs) and reports best-of per
config through the PRODUCTION entry (align_batch_from_pcm).

Usage: python scripts/ab_host_tokens.py [rounds]
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from bench import build_batch_pairs
    from describealign_jax.alignment import api

    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    pairs, lens, planted, kinds = build_batch_pairs()
    batch_minutes = sum(s_a / 44100.0 / 60.0 for (_, s_a) in lens)

    # (tokens, host_workers): 99 tokens == token effectively off
    cfgs = [(99, 2), (1, 2), (1, 3), (1, 4)]
    best = {c: float('inf') for c in cfgs}
    ref = api.align_batch_from_pcm(pairs, true_samples=lens)  # warm

    for r in range(rounds):
        for cfg in cfgs:
            tokens, workers = cfg
            api._host_token_sem = None
            os.environ['DESCRIBEALIGN_HOST_TOKENS'] = str(tokens)
            t = time.time()
            res = api.align_batch_from_pcm(pairs, true_samples=lens,
                                           host_workers=workers)
            wall = time.time() - t
            best[cfg] = min(best[cfg], wall)
            print(f"r{r} tokens={tokens:2d} workers={workers} "
                  f"wall={wall:6.2f} s  rate={batch_minutes / wall:5.2f}",
                  flush=True)
            for a, b in zip(res, ref):
                assert np.allclose(a[0], b[0]) and np.allclose(a[1], b[1])

    print("\nbest per config:")
    for cfg, w in best.items():
        print(f"tokens={cfg[0]:2d} workers={cfg[1]}  wall={w:6.2f} s  "
              f"rate={batch_minutes / w:5.2f} audio-min/s")


if __name__ == "__main__":
    main()
