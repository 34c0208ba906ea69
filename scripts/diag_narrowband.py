#!/usr/bin/env python
"""Diagnose the narrowband-campaign wrong-map draws (seed 20260824,
draws 02/05: we return a confidently wrong map where the reference stays
accurate).

For a given draw, recomputes the features, runs our coarse stage alone,
and reports where each k-best track sits relative to the ground-truth
video offset per audio block - distinguishing "the coarse DP never finds
the true band" (coarse scoring problem) from "the coarse band is right
but the fine/LIS path dies" (gating problem).

Usage: python scripts/diag_narrowband.py [seed=20260824] [profile=narrowband] 2
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from scripts.parity_campaign import (draw_scenario, load_reference,
                                     truth_map, _content_seed_base)


def main():
    rest = sys.argv[1:]
    camp_seed, profile = 20260824, "narrowband"
    if rest and rest[0].startswith('seed='):
        camp_seed = int(rest[0][5:]); rest = rest[1:]
    if rest and rest[0].startswith('profile='):
        profile = rest[0][8:]; rest = rest[1:]
    want = {int(v) for v in rest} or {2}

    ref = load_reference()
    import jax
    from describealign_jax.alignment import matching

    rng = np.random.default_rng(camp_seed)
    base = _content_seed_base(camp_seed)
    for i in range(max(want) + 1):
        video, audio, meta = draw_scenario(rng, base + i, profile)
        if i not in want:
            continue
        vf = [np.asarray(f, np.float32) for f in
              (ref.get_energy(video), ref.get_zero_crossings(video))] \
            + [np.asarray(f, np.float32) for f in ref.get_freq_bands(video)]
        af = [np.asarray(f, np.float32) for f in
              (ref.get_energy(audio), ref.get_zero_crossings(audio))] \
            + [np.asarray(f, np.float32) for f in ref.get_freq_bands(audio)]
        nmin_a = min(len(f) for f in af)
        nmin_v = min(len(f) for f in vf)
        npad = matching.bucket_pad(max(nmin_a, nmin_v)) \
            if hasattr(matching, 'bucket_pad') else None
        from describealign_jax.alignment.api import _bucket_pad, _stack_padded
        npad = max(_bucket_pad(nmin_a), _bucket_pad(nmin_v))
        fa = _stack_padded(af, nmin_a, npad)
        fv = _stack_padded(vf, nmin_v, npad)
        out = matching.match_coarse(fa, nmin_a, fv, nmin_v)
        starts_tracks = np.asarray(out[6])               # (T, B_pad)
        nb = nmin_a // matching.BLOCK if hasattr(matching, 'BLOCK') else \
            nmin_a // 210
        tm = truth_map(meta)
        blocks = np.arange(nb)
        a_times = blocks + 0.5                            # block centers, s
        want_v = tm(a_times) * 210.0                      # truth video frame
        print(f"--- draw {i:02d} {meta['bed']} lead={meta['lead']:.1f} "
              f"rate={meta['rate']:.4f} nb={nb}")
        for t in range(starts_tracks.shape[0]):
            st = starts_tracks[t, :nb].astype(float)
            # starts are the BAND start (video frame) for each audio block;
            # the fine band is [st, st + band_width); compare band center
            # against truth
            sel = np.isfinite(want_v)
            err = st[sel] - want_v[sel]
            frac_near = float(np.mean(np.abs(err) < 280))  # within band
            print(f"  track {t}: |err|<280 frames for {frac_near:6.1%} of "
                  f"blocks; median err {np.median(err):8.1f} frames "
                  f"p10 {np.percentile(err, 10):8.1f} "
                  f"p90 {np.percentile(err, 90):8.1f}")
        # where does the truth band rank in the coarse SCORE map?
        # (recompute the block score map on its own for the true lanes)
        print(f"  (truth offset at block 0: video frame "
              f"{want_v[np.isfinite(want_v)][0]:.0f})")


if __name__ == "__main__":
    main()
