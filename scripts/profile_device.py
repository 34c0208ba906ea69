#!/usr/bin/env python
"""Dev profiling: device-side stage breakdown (features/coarse/fine/DP)."""
import os
import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts.profile_e2e import load_pair  # noqa: E402


def _pull_any(o):
    while isinstance(o, (tuple, list)):
        o = o[0]
    return np.asarray(o).ravel()[:1]


def timed(name, fn, *args, n=3, pull=_pull_any):
    ts = []
    out = None
    for i in range(n + 1):
        t = time.time()
        out = fn(*args)
        pull(out)
        dt = time.time() - t
        if i:
            ts.append(dt)
        else:
            print(f"{name}: warm/compile {dt:.2f}s", flush=True)
    print(f"{name}: min {min(ts):.3f}s  all={[round(t,3) for t in ts]}",
          flush=True)
    return out


def main():
    import jax
    import jax.numpy as jnp
    from describealign_jax.alignment import matching
    from describealign_jax.alignment.preprocess import (
        preprocess_features, valid_audio_mask, valid_video_mask)

    video, audio, sv, sa = load_pair()
    na, nv = sa // 210, sv // 210

    # dispatch latency: trivial program round trip
    trivial = jax.jit(lambda x: x + 1)
    timed("dispatch_latency(8B)", trivial, jnp.zeros((1,), jnp.float32))

    dev_a = jax.device_put(audio)
    dev_v = jax.device_put(video)

    @jax.jit
    def feats_only(pcm_a, pcm_v, la, lv):
        def feats_of(pcm_i16):
            from describealign_jax.ops import features as F
            pcm = pcm_i16.astype(jnp.float16).astype(jnp.float32)
            fs = (F.energy_feature(pcm), F.zero_crossing_feature(pcm)) \
                + tuple(F.freq_band_features(pcm))
            n = pcm.shape[1] // 210
            return jnp.stack([f[:n] for f in fs], axis=0)
        fa, fv = feats_of(pcm_a), feats_of(pcm_v)
        ia = jnp.arange(fa.shape[1])[None, :]
        iv = jnp.arange(fv.shape[1])[None, :]
        return (jnp.where(ia < la, fa, 0.), jnp.where(iv < lv, fv, 0.))

    fa, fv = timed("features(both)", feats_only, dev_a, dev_v, na, nv)

    @jax.jit
    def pre(fa, fv):
        return preprocess_features(fa) + preprocess_features(fv)

    ms_a, norms_a, ms_v, norms_v = timed("preprocess", pre, fa, fv)

    @jax.jit
    def coarse_scores(ms_a, norms_a, ea, ms_v, norms_v, ev, la, lv):
        am = valid_audio_mask(ea, la)
        vm = valid_video_mask(ev, lv)
        da = matching._coarse_descriptors(ms_a[:3], norms_a[:3], am)
        dv = matching._coarse_descriptors(ms_v[:3], norms_v[:3], vm)
        return matching._block_scores_local(da, dv)

    p_map = timed("coarse_scores", coarse_scores, ms_a, norms_a, fa[0],
                  ms_v, norms_v, fv[0], na, nv)
    print("p_map shape:", p_map.shape, flush=True)

    dp = jax.jit(matching._coarse_dp)
    v_path = timed("coarse_dp", dp, p_map)

    @jax.jit
    def fine(ms_a, norms_a, ea, ms_v, norms_v, ev, la, lv, v_path):
        nb = v_path.shape[0]
        centers = (v_path * matching.COARSE_STRIDE
                   - jnp.arange(nb, dtype=jnp.int32) * matching.BLOCK)
        am = valid_audio_mask(ea, la)
        vm = valid_video_mask(ev, lv)
        nv_pad = ms_v.shape[1]

        def one_block(inp):
            b, center = inp
            return matching._fine_block(ms_a, norms_a, ms_v, norms_v,
                                        am, vm, nv_pad, b, center)
        return jax.lax.map(
            one_block, (jnp.arange(nb, dtype=jnp.int32), centers),
            batch_size=32)

    out = timed("fine", fine, ms_a, norms_a, fa[0], ms_v, norms_v, fv[0],
                na, nv, v_path)
    print("quals:", out[0].shape)


if __name__ == "__main__":
    main()
