#!/usr/bin/env python
"""Dev profiling: stage-by-stage breakdown of align_from_pcm on the GPU."""
import io
import os
import sys
import time
from contextlib import redirect_stdout

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_pair():
    """The bench's 22-min pair, bucket-padded int16: (video, audio,
    true video samples, true audio samples)."""
    import chip_smoke
    return chip_smoke.scale_pair()


def main():
    """Times the DEVICE-feature configuration (upload PCM, extract on
    the device). See profile_round2.py for the default host-feature/
    streamed breakdown."""
    import jax
    from describealign_jax.alignment import matching
    from describealign_jax.alignment.api import _host_stages

    video, audio, sv, sa = load_pair()
    na, nv = sa // 210, sv // 210
    print(f"pcm bytes: v={video.nbytes/1e6:.0f}MB a={audio.nbytes/1e6:.0f}MB",
          flush=True)

    quiet = io.StringIO()
    # warm up compile
    t = time.time()
    out = matching.extract_and_match(jax.device_put(audio), na,
                                     jax.device_put(video), nv)
    np.asarray(out[0])
    print(f"warmup (compile+run): {time.time()-t:.2f}s", flush=True)

    for it in range(3):
        t0 = time.time()
        dev_a = jax.device_put(audio)
        dev_v = jax.device_put(video)
        np.asarray(dev_a[0, :1]); np.asarray(dev_v[0, :1])
        t1 = time.time()
        out = matching.extract_and_match(dev_a, na, dev_v, nv)
        # pull a single scalar first to time compute separate from D2H
        np.asarray(out[0][0, 0, 0])
        t2 = time.time()
        quals = np.asarray(out[0])
        offs = np.asarray(out[1])
        starts = np.asarray(out[2])
        feats_a = np.asarray(out[3])
        feats_v = np.asarray(out[4])
        t3 = time.time()
        with redirect_stdout(quiet):
            res = _host_stages(quals, offs, starts, feats_a, feats_v,
                               na, nv, 'native')
        t4 = time.time()
        d2h_mb = (quals.nbytes + offs.nbytes + feats_a.nbytes
                  + feats_v.nbytes) / 1e6
        print(f"iter{it}: upload {t1-t0:.2f}s | compute {t2-t1:.2f}s | "
              f"D2H {t3-t2:.2f}s ({d2h_mb:.0f}MB) | host {t4-t3:.2f}s | "
              f"total {t4-t0:.2f}s", flush=True)
    print("offset:", float(res[0][0] - res[1][0]), "sim:", res[2])


if __name__ == "__main__":
    main()
