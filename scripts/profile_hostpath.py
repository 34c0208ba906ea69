#!/usr/bin/env python
"""Dev profiling: the host-feature fast path (features on host, match on the GPU)."""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts.profile_e2e import load_pair  # noqa: E402


def main():
    import jax
    import jax.numpy as jnp
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
    import reference_impl as R
    from describealign_jax.alignment import matching
    from describealign_jax.alignment.api import _bucket_pad

    video, audio, sv, sa = load_pair()
    na, nv = sa // 210, sv // 210

    # host feature extraction (oracle numpy, f16 grid)
    def host_feats(pcm_i16, n):
        t = time.time()
        pcm = pcm_i16.astype(np.float16)
        fs = [R.oracle_energy(pcm), R.oracle_zero_crossings(pcm)] \
            + R.oracle_freq_bands(pcm)
        npad = _bucket_pad(n)
        out = np.zeros((5, npad), np.float32)
        for j, f in enumerate(fs):
            k = min(len(f), n)
            out[j, :k] = f[:k]
        print(f"  host feats ({n} frames): {time.time()-t:.2f}s", flush=True)
        return out

    @jax.jit
    def match_from_feats(feats_a, len_a, feats_v, len_v):
        from describealign_jax.alignment.preprocess import preprocess_features
        ms_a, norms_a = preprocess_features(feats_a)
        ms_v, norms_v = preprocess_features(feats_v)
        return matching._match_core(ms_a, norms_a, feats_a[0], len_a,
                                    ms_v, norms_v, feats_v[0], len_v)

    fa = host_feats(audio, na)
    fv = host_feats(video, nv)
    print(f"upload bytes: {(fa.nbytes + fv.nbytes)/1e6:.1f}MB", flush=True)

    # warm
    out = match_from_feats(fa, na, fv, nv)
    np.asarray(out[0])

    for it in range(3):
        t0 = time.time()
        da = jax.device_put(fa)
        dv = jax.device_put(fv)
        np.asarray(da[0, :1]); np.asarray(dv[0, :1])
        t1 = time.time()
        out = match_from_feats(da, na, dv, nv)
        np.asarray(out[0][0, 0, 0])
        t2 = time.time()
        quals = np.asarray(out[0])
        vids = np.asarray(out[1])
        t3 = time.time()
        print(f"iter{it}: upload {t1-t0:.2f}s | compute {t2-t1:.2f}s | "
              f"D2H {t3-t2:.2f}s ({(quals.nbytes+vids.nbytes)/1e6:.0f}MB) | "
              f"total {t3-t0:.2f}s", flush=True)


if __name__ == "__main__":
    main()
