#!/usr/bin/env python
"""Per-pair live-slot occupancy of the batch bench under the compact
transport, and the realized D2H savings of its occupancy-exact pulls
(fixed region + step-quantized live region) vs the dense combo buffer.
Runs fine on the CPU backend (the fine pass twin is path-equivalent).

Usage: [JAX_PLATFORMS=cpu] python scripts/diag_compact_occupancy.py
"""
import os
import sys

import numpy as np


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax
    if os.environ.get('JAX_PLATFORMS') == 'cpu':
        # a jax imported earlier latched its platforms; override
        jax.config.update('jax_platforms', 'cpu')

    from bench import build_batch_pairs
    from describealign_jax.alignment import api, matching

    pairs, lens, planted, kinds = build_batch_pairs()
    k1 = matching.TOP_K
    tot_pull = tot_dense = 0
    for i, ((v, a), (sv, sa), kind) in enumerate(zip(pairs, lens, kinds)):
        npad = max(api._bucket_pad(sv // 210), api._bucket_pad(sa // 210))
        fv, nv = api.host_features_padded(v, sv, npad)
        fa, na = api.host_features_padded(a, sa, npad)
        fav = np.empty((2, 5, npad), np.float16)
        fav[0] = fa
        fav[1] = fv
        dev_av = jax.device_put(fav)
        chunks, starts_dev, _, margin_dev = matching.match_stream_pair(
            dev_av, na, nv)
        nb = matching.nb_for(npad)
        lay = matching.compact_layout(nb, starts_dev.shape[0])
        buf = np.asarray(matching.concat_chunks_compact(chunks, starts_dev,
                                                        margin_dev)[0])
        counts = buf[slice(*lay['counts'])]
        t1 = int(np.sum(counts & 15, dtype=np.int64))
        t2 = int(np.sum(counts >> 4, dtype=np.int64))
        sec = matching.compact2_live_offsets(t1, t2)
        q = min(lay['live_max'],
                -(-sec['total'] // lay['step']) * lay['step'])
        pull = lay['fixed_end'] + q
        k2 = (starts_dev.shape[0] - 1) * (k1 // 2)
        w = 210 * matching._packed_row_words_py(k1) \
            + 105 * matching._packed_row_words_py(k2) \
            + 2 * starts_dev.shape[0]
        dense = nb * w * 2
        occ1 = t1 / (nb * 210 * k1)
        occ2 = t2 / (nb * 105 * k2)
        tot_pull += pull
        tot_dense += dense
        print(f"pair {i} ({kind:7s}): band1 occ {occ1:6.1%}  rescue occ "
              f"{occ2:6.1%}  pull {pull / 1e6:5.2f} MB vs dense "
              f"{dense / 1e6:5.2f} MB ({pull / dense:5.1%})", flush=True)
    print(f"total: {tot_pull / 1e6:.2f} MB pulled vs {tot_dense / 1e6:.2f}"
          f" MB dense ({tot_pull / tot_dense:.1%})")


if __name__ == "__main__":
    main()
