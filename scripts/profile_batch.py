#!/usr/bin/env python
"""Dev profiling: event timeline of the batch streaming path.

Mirrors api._align_batch_streamed with per-event wall/CPU timestamps so the
stall structure is visible: for each pair, feature extraction, uploads,
dispatch, the one concatenated pull, the LIS feed, and the refinement tail,
all stamped on a shared wall clock. Run SOLO on the GPU.

Usage: python scripts/profile_batch.py [reps]
"""
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    from concurrent.futures import ThreadPoolExecutor
    from bench import build_batch_pairs
    from describealign_jax.alignment import api, matching

    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    pairs, lens, planted, kinds = build_batch_pairs()
    batch_minutes = sum(s_a / 44100.0 / 60.0 for (_, s_a) in lens)
    b = len(pairs)

    # warm every bucket
    api.align_batch_from_pcm(pairs, true_samples=lens)

    events = []
    ev_mu = threading.Lock()
    wall0 = [0.0]

    def ev(tag, i, t0, c0):
        # thread_time: per-THREAD CPU so concurrent workers don't
        # contaminate each other's stage attribution
        t1, c1 = time.time(), time.thread_time()
        with ev_mu:
            events.append((t0 - wall0[0], t1 - wall0[0], c1 - c0, tag, i))
        return t1, c1

    use_compact = api._use_compact()

    def run_once(device_depth=4, host_workers=2):
        events.clear()
        results = [None] * b
        in_flight = threading.Semaphore(max(2, device_depth + 1))
        from describealign_jax.alignment import lis

        def cpu_dense(packed, starts, fa, fv, na, nv, i):
            t0, c0 = time.time(), time.thread_time()
            with api._host_token():
                t0, c0 = ev('token', i, t0, c0)
                y, x = api._consume_stream(iter([packed]), starts)
                t0, c0 = ev('lis', i, t0, c0)
                r = api._host_stages_from_path(y, x, fa, fv, na, nv,
                                               'native', True)
            ev('tail', i, t0, c0)
            return r

        def pull_dense(cpu_pool, combo_dev, w_st, fa, fv, na, nv, i):
            try:
                t0, c0 = time.time(), time.thread_time()
                buf = np.asarray(combo_dev)
                t0, c0 = ev('pull', i, t0, c0)
                starts = np.ascontiguousarray(
                    buf[:, -w_st:]).view(np.int32).T
                # margin words (2) sit between the packed rows and starts
                packed = buf[:, :-(w_st + 2)]    # strided in-place feed
            finally:
                in_flight.release()
            return cpu_pool.submit(cpu_dense, packed, starts,
                                   fa, fv, na, nv, i)

        def cpu_compact(ctx, counts, live, sec, sg, fa, fv, na, nv, i):
            t0, c0 = time.time(), time.thread_time()
            with api._host_token():
                t0, c0 = ev('token', i, t0, c0)
                with ctx:
                    ctx.feed_compact(
                        counts,
                        live[slice(*sec['codes1'])],
                        live[slice(*sec['lo1'])],
                        live[slice(*sec['hi1'])],
                        live[slice(*sec['codes2'])],
                        live[slice(*sec['lo2'])],
                        live[slice(*sec['hi2'])],
                        sg, blk=210)
                    y, x = ctx.finish()
                t0, c0 = ev('lis', i, t0, c0)
                r = api._host_stages_from_path(y, x, fa, fv, na, nv,
                                               'native', True)
            ev('tail', i, t0, c0)
            return r

        def pull_sliced(cpu_pool, sliced_dev, t1, t2, nb, n_tracks,
                        fa, fv, na, nv, i):
            try:
                t0, c0 = time.time(), time.thread_time()
                lay = matching.compact_layout(nb, n_tracks)
                buf = np.asarray(sliced_dev)
                t0, c0 = ev('pull_sliced', i, t0, c0)
                counts = buf[slice(*lay['counts'])]
                st = np.ascontiguousarray(
                    buf[slice(*lay['starts'])]).view(np.int32).reshape(
                        nb, -1)
                sg = np.column_stack([st[:, 0], st[:, 0], st[:, 1]])
                ctx = lis.LisStream(int(sg.max()) + 32768)
                sec = matching.compact2_live_offsets(t1, t2)
                live = buf[lay['live']:]
            finally:
                in_flight.release()
            return cpu_pool.submit(cpu_compact, ctx, counts, live, sec,
                                   sg, fa, fv, na, nv, i)

        pending = []

        def flush_one():
            (i, compact_dev, totals_dev, nb, n_tracks,
             fa, fv, na, nv) = pending.pop(0)
            t0, c0 = time.time(), time.thread_time()
            totals = np.asarray(totals_dev)
            t0, c0 = ev('totals', i, t0, c0)
            t1, t2 = int(totals[0]), int(totals[1])
            lay = matching.compact_layout(nb, n_tracks)
            sec = matching.compact2_live_offsets(t1, t2)
            q = min(lay['live_max'],
                    -(-sec['total'] // lay['step']) * lay['step'])
            sliced_dev = compact_dev[:lay['fixed_end'] + q]
            ev('slice_disp', i, t0, c0)
            futs.append((i, pull_pool.submit(
                pull_sliced, cpu_pool, sliced_dev, t1, t2, nb,
                n_tracks, fa, fv, na, nv, i)))

        def pull_compact(cpu_pool, fixed_dev, compact_dev, nb, n_tracks,
                         fa, fv, na, nv, i):
            try:
                t0, c0 = time.time(), time.thread_time()
                lay = matching.compact_layout(nb, n_tracks)
                if fixed_dev is None:
                    buf = np.asarray(compact_dev)
                    fixed = buf[:lay['fixed_end']]
                else:
                    buf = None
                    fixed = np.asarray(fixed_dev)
                t0, c0 = ev('pull_fixed', i, t0, c0)
                counts = fixed[slice(*lay['counts'])]
                st = np.ascontiguousarray(
                    fixed[slice(*lay['starts'])]).view(np.int32).reshape(
                        nb, -1)
                sg = np.column_stack([st[:, 0], st[:, 0], st[:, 1]])
                ctx = lis.LisStream(int(sg.max()) + 32768)
                t1 = int(np.sum(counts & 15, dtype=np.int64))
                t2 = int(np.sum(counts >> 4, dtype=np.int64))
                sec = matching.compact2_live_offsets(t1, t2)
                p0 = lay['live']
                q = min(lay['live_max'],
                        -(-sec['total'] // lay['step']) * lay['step'])
                live = (buf[p0:p0 + q] if buf is not None
                        else np.asarray(compact_dev[p0:p0 + q]))
                t0, c0 = ev('pull_live', i, t0, c0)
            finally:
                in_flight.release()
            return cpu_pool.submit(cpu_compact, ctx, counts, live, sec,
                                   sg, fa, fv, na, nv, i)

        t_start = time.time()
        c_start = time.process_time()
        wall0[0] = t_start
        futs = []
        with ThreadPoolExecutor(max_workers=host_workers) as cpu_pool, \
             ThreadPoolExecutor(max_workers=api._pull_threads()) as pull_pool:
            for i in range(b):
                v, a = pairs[i]
                sv, sa = lens[i]
                t0, c0 = time.time(), time.thread_time()
                while len(pending) >= 2:
                    flush_one()
                in_flight.acquire()
                t0, c0 = ev('acquire', i, t0, c0)
                npad = max(api._bucket_pad(sv // 210),
                           api._bucket_pad(sa // 210))
                with api._host_token():
                    t0, c0 = ev('token_m', i, t0, c0)
                    fv, nv = api.host_features_padded(v, sv, npad)
                    t0, c0 = ev('feat_v', i, t0, c0)
                    fa, na = api.host_features_padded(a, sa, npad)
                    t0, c0 = ev('feat_a', i, t0, c0)
                    fav = np.empty((2, 5, npad), np.float16)
                    fav[0] = fa
                    fav[1] = fv
                dev_av = jax.device_put(fav)
                t0, c0 = ev('h2d', i, t0, c0)
                chunks, starts_dev, _, margin_dev = matching.match_stream_pair(
                    dev_av, na, nv)
                if use_compact:
                    compact_dev, totals_dev = matching.concat_chunks_compact(
                        chunks, starts_dev, margin_dev)
                    nb = matching.nb_for(npad)
                    mode = api._pull_mode()
                    if mode == 'sliced':
                        t0, c0 = ev('dispatch', i, t0, c0)
                        pending.append((i, compact_dev, totals_dev, nb,
                                        starts_dev.shape[0],
                                        fa, fv, na, nv))
                        continue
                    fixed_dev = (None if mode == 'whole' else
                                 api._prefetch_fixed(compact_dev, nb,
                                                     starts_dev.shape[0]))
                    t0, c0 = ev('dispatch', i, t0, c0)
                    futs.append((i, pull_pool.submit(
                        pull_compact, cpu_pool, fixed_dev, compact_dev,
                        nb, starts_dev.shape[0], fa, fv, na, nv, i)))
                else:
                    combo_dev = matching.concat_chunks_with_starts(
                        chunks, starts_dev, margin_dev)
                    combo_dev.copy_to_host_async()
                    t0, c0 = ev('dispatch', i, t0, c0)
                    futs.append((i, pull_pool.submit(
                        pull_dense, cpu_pool, combo_dev,
                        2 * starts_dev.shape[0], fa, fv, na, nv, i)))
            while pending:
                flush_one()
            for i, f in futs:
                results[i] = f.result().result()
        wall = time.time() - t_start
        cpu = time.process_time() - c_start
        return wall, cpu

    best = (float('inf'), None, None)
    for _ in range(reps):
        wall, cpu = run_once()
        snap = list(events)
        if wall < best[0]:
            best = (wall, cpu, snap)
        print(f"wall={wall:6.2f} s  cpu={cpu:6.2f} s  "
              f"rate={batch_minutes / wall:5.2f} audio-min/s", flush=True)

    wall, cpu, snap = best
    print(f"\nBEST wall={wall:.2f}  cpu={cpu:.2f}  "
          f"rate={batch_minutes / wall:.2f} audio-min/s")
    print(f"{'tag':10s} {'count':>5s} {'wall_sum':>9s} {'cpu_sum':>8s}")
    agg = {}
    for (ts, te, c, tag, i) in snap:
        w, cc, n = agg.get(tag, (0.0, 0.0, 0))
        agg[tag] = (w + (te - ts), cc + c, n + 1)
    for tag, (w, cc, n) in sorted(agg.items()):
        print(f"{tag:10s} {n:5d} {w:9.2f} {cc:8.2f}")
    print("\ntimeline (start-end s, cpu s):")
    for (ts, te, c, tag, i) in sorted(snap):
        bar = ' ' * int(ts * 4) + '#' * max(1, int((te - ts) * 4))
        print(f"{ts:6.2f}-{te:6.2f} c={c:5.2f} p{i} {tag:9s} |{bar}")


if __name__ == "__main__":
    main()
