#!/usr/bin/env python
"""Experiment: calibrate a coarse-confidence floor for the low-confidence
warning guard.

For every draw of the requested campaign profiles, compute with the numpy
coarse twins (scripts/diag_coarse_feats.py):

  - score1: the coarse DP's winning-track total score (max of the final
    cost row)
  - score2: the runner-up track's total score after suppressing +/-25
    lanes around track 1 (the production k-best rescue semantics)
  - margin/blk = (score1 - score2) / n_anchor_blocks: the per-anchor-block
    score advantage of the winning hypothesis over the best alternative
  - truth in-band coverage of track 1 (ground truth from the scenario
    meta), so each draw is labeled GOOD (coarse found the truth) or BAD
    (the track is a false ridge)

The guard fires when the margin is below a floor; this script reports the
margin distributions of GOOD vs BAD tracks so the floor separates them.

Usage: python scripts/diag_confidence.py [profile:seed:n ...]
  default set covers the adjudicated narrowband seed + the clean seeds.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from scripts.parity_campaign import (draw_scenario, load_reference,
                                     truth_map, _content_seed_base)
from scripts.diag_coarse_feats import (preprocess, score_map,
                                       coarse_dp, BLOCK, COARSE_STRIDE,
                                       WINDOW, DP_SLOPE_COST, DP_JUMP_COST,
                                       COARSE_PER_BLOCK)

SUPPRESS_LANES = 25


def coarse_dp_with_score(p_map):
    """diag_coarse_feats.coarse_dp + the final cost row max (track score)."""
    nb, d = p_map.shape
    lanes = np.arange(d, dtype=np.float32)
    cost = np.empty_like(p_map)
    prev = np.zeros(d, np.float32)
    for b in range(nb):
        prev10 = np.concatenate([np.full(COARSE_PER_BLOCK, -1e30,
                                         np.float32),
                                 prev[:-COARSE_PER_BLOCK]])
        fwd = np.maximum.accumulate(prev10 + DP_SLOPE_COST * lanes) \
            - DP_SLOPE_COST * lanes
        bwd = np.maximum.accumulate((prev10 - DP_SLOPE_COST * lanes)[::-1]
                                    )[::-1] + DP_SLOPE_COST * lanes
        relax = np.maximum(np.maximum(fwd, bwd), prev.max() - DP_JUMP_COST)
        cost[b] = relax + p_map[b]
        prev = cost[b]
    path = np.empty(nb, np.int32)
    path[-1] = int(np.argmax(cost[-1]))
    for b in range(nb - 2, -1, -1):
        o_next = path[b + 1]
        moved = cost[b] - DP_SLOPE_COST * np.abs(
            lanes - (o_next - COARSE_PER_BLOCK))
        jumped = cost[b].max() - DP_JUMP_COST
        path[b] = (int(np.argmax(moved)) if moved.max() >= jumped
                   else int(np.argmax(cost[b])))
    return path, float(cost[-1].max())


def one_draw(ref, video, audio, meta):
    vf = [np.asarray(f, np.float32) for f in
          (ref.get_energy(video), ref.get_zero_crossings(video))] \
        + [np.asarray(f, np.float32) for f in ref.get_freq_bands(video)]
    af = [np.asarray(f, np.float32) for f in
          (ref.get_energy(audio), ref.get_zero_crossings(audio))] \
        + [np.asarray(f, np.float32) for f in ref.get_freq_bands(audio)]
    nmin_a = min(len(f) for f in af)
    nmin_v = min(len(f) for f in vf)
    fa = np.stack([f[:nmin_a] for f in af])
    fv = np.stack([f[:nmin_v] for f in vf])
    ms_a, norms_a = preprocess(fa)
    ms_v, norms_v = preprocess(fv)
    mask_a = (fa[0] > .5)
    mask_a[max(0, nmin_a - WINDOW):] = False
    base_v = (fv[0] > .5)
    base_v[max(0, nmin_v - WINDOW):] = False
    rank = np.cumsum(base_v) - 1
    mask_v = base_v & (rank % 4 == 0)

    from describealign_jax.alignment.matching import COARSE_STREAMS
    p_map = score_map(ms_a, norms_a, mask_a, ms_v, norms_v, mask_v,
                      COARSE_STREAMS)
    nb, kv = p_map.shape
    lanes = np.arange(kv)
    path1, score1 = coarse_dp_with_score(p_map)
    suppressed = p_map.copy()
    suppressed[np.abs(lanes[None, :] - path1[:, None])
               <= SUPPRESS_LANES] = -1e30
    _, score2 = coarse_dp_with_score(suppressed)

    # anchor blocks: audio blocks contributing any nonzero coarse score
    starts = np.arange((ms_a.shape[1] - WINDOW - 18) // COARSE_STRIDE + 1) \
        * COARSE_STRIDE
    anchors = mask_a[starts][:nb * COARSE_PER_BLOCK]
    n_anchor_blocks = int(np.any(anchors.reshape(nb, COARSE_PER_BLOCK),
                                 axis=1).sum())
    margin = (score1 - score2) / max(1, n_anchor_blocks)

    tm = truth_map(meta)
    centers = path1 * COARSE_STRIDE - np.arange(nb) * BLOCK
    a_times = np.arange(nb) + 0.5
    want_v = tm(a_times) * 210.0
    sel = np.isfinite(want_v)
    err = (np.arange(nb) * BLOCK + centers)[sel] - want_v[sel]
    inband = float(np.mean(np.abs(err) < 280))
    return margin, inband, n_anchor_blocks, nb


def main():
    specs = sys.argv[1:] or [
        "narrowband:20260824:12",
        "default:20260816:25",
        "default:20260818:25",
        "long:20260820:15",
        "quiet:20260821:12",
        "rate:20260822:12",
        "clipped:20260824:12",
        "gauntlet:20260823:15",
    ]
    ref = load_reference()
    rows = []
    for spec in specs:
        profile, seed_s, n_s = spec.split(":")
        camp_seed, n = int(seed_s), int(n_s)
        rng = np.random.default_rng(camp_seed)
        base = _content_seed_base(camp_seed)
        for i in range(n):
            video, audio, meta = draw_scenario(rng, base + i, profile)
            margin, inband, n_anchor, nb = one_draw(ref, video, audio, meta)
            label = "GOOD" if inband >= 0.5 else "BAD "
            rows.append((profile, i, margin, inband, label))
            print(f"{profile:>10} {i:02d} {label} margin/blk={margin:7.3f} "
                  f"inband={inband:6.1%} anchors={n_anchor}/{nb} "
                  f"bed={meta['bed']}", flush=True)
    good = sorted(r[2] for r in rows if r[4] == "GOOD")
    bad = sorted(r[2] for r in rows if r[4] == "BAD ")
    print(f"\nGOOD margins (n={len(good)}): "
          f"min={good[0]:.3f} p5={good[max(0, len(good)//20)]:.3f} "
          f"median={good[len(good)//2]:.3f}" if good else "no GOOD rows")
    print(f"BAD  margins (n={len(bad)}): "
          + " ".join(f"{m:.3f}" for m in bad) if bad else "no BAD rows")


if __name__ == "__main__":
    main()
