"""align(): the top-level alignment algorithm.

Same contract as the reference's align (describealign.py:595-1027):

    align(video_features, audio_desc_features, video_energy, audio_energy)
      -> (audio_times_s, video_times_s, similarity_percent, path, median_slope)

plus the fast path align_from_pcm(video_pcm, audio_pcm) used by the
pipeline: host C++ features go up as f16 stacks, the device runs
preprocess -> coarse offset DP -> fine banded correlation -> top-K
candidates, and packed candidates stream back into the host LIS.

Host stages (shared by both entries): exact weighted-LIS chain ->
continuity filter -> compression -> L1 piecewise-linear fit (native exact
fused-lasso by default, scipy LP as cross-check) -> pass-2 cluster
refinement -> similarity/nodes.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp

from . import continuity, fit, lis, matching, outputs, preprocess, refine
from .refine_native import refine_dp_flat

BUCKET_FRAMES = 210 * 64          # shape bucket quantum (64 s)
PAD_MARGIN = 210 + preprocess.WINDOW
PCM_BUCKET = 210 * BUCKET_FRAMES  # samples; 210 samples per feature frame


def _bucket_pad(n):
    return -(-(n + PAD_MARGIN) // BUCKET_FRAMES) * BUCKET_FRAMES


def _stack_padded(features, nmin, npad):
    out = np.zeros((5, npad), np.float32)
    for j, f in enumerate(features):
        out[j, :nmin] = np.asarray(f[:nmin], np.float32)
    return out


def _fail_if_short(path_len, num_video, num_audio):
    # exact reference semantics (describealign.py:698, 991): the floor is
    # min(video frames, audio frames)/500 (capped below by 5*210), applied
    # after both the LIS pass and the pass-2 DP
    if path_len < max(min(num_video, num_audio) / 500., 5 * 210):
        raise RuntimeError("Alignment failed, are the input files mismatched?")


def _default_backend(fit_backend):
    return fit_backend or os.environ.get('DESCRIBEALIGN_FIT_BACKEND', 'native')


def align(video_features, audio_desc_features, video_energy, audio_desc_energy,
          fit_backend=None, video_frames=None, audio_frames=None):
    """Feature-list entry (reference-compatible module API).

    video_frames/audio_frames: true 210fps frame counts when the feature
    arrays carry zero-padding (bucketed extraction); default = array length.
    """
    fit_backend = _default_backend(fit_backend)
    _malloc_tune()
    na = min(len(f) for f in audio_desc_features)
    nv = min(len(f) for f in video_features)
    if audio_frames is not None:
        na = min(na, int(audio_frames))
    if video_frames is not None:
        nv = min(nv, int(video_frames))

    print("  memorizing video...        \r", end='')
    npad = max(_bucket_pad(na), _bucket_pad(nv))   # one shape per bucket
    feats_a_np = _stack_padded(audio_desc_features, na, npad)
    feats_v_np = _stack_padded(video_features, nv, npad)

    print("  matching audio...  \r", end='')
    # f16 upload (half the H2D bytes); host stages keep the f32 stacks
    dev_a = jax.device_put(feats_a_np.astype(np.float16))
    dev_v = jax.device_put(feats_v_np.astype(np.float16))
    quals, offs, starts, margin = matching.match_from_features(dev_a, na,
                                                               dev_v, nv)
    result = _host_stages(np.asarray(quals), np.asarray(offs),
                          np.asarray(starts), feats_a_np, feats_v_np, na, nv,
                          fit_backend, margin=float(np.asarray(margin)))
    # the public module API keeps the reference's 5-tuple contract; the
    # low-confidence guard surfaces through the WARNING line protocol
    warn_low_confidence(result[5])
    return result[:5]


def _pad_pcm_i16(pcm_i16):
    target = _padded_len(pcm_i16.shape[1])
    if pcm_i16.shape[1] == target:
        return pcm_i16  # already bucket-padded (decode-ahead thread)
    return np.pad(pcm_i16, ((0, 0), (0, target - pcm_i16.shape[1])))


def _feature_path():
    """Where feature extraction runs for the PCM fast paths.

    'host' (default): the native C++ extractor computes the 5 feature
    streams on the host CPU and only the ~40x-smaller feature stacks go to
    the device. 'device': upload int16 PCM and extract on the device (the
    fused extract_and_match program). Which wins on a given host is an
    open measurement.
    """
    return os.environ.get('DESCRIBEALIGN_FEATURES', 'host')


def host_features_padded(pcm_i16, true_samples=None, npad=None):
    """Host feature extraction into the bucket-padded (5, Npad) f32 stack.

    true_samples is passed through unrounded so the tail samples of a
    partial final frame still feed the smoothing convolutions, exactly as
    on the device extractor. Returns (stack, n_frames).
    """
    from ..ops.host_features import extract_features_host
    true_samples = true_samples or pcm_i16.shape[1]
    n = int(true_samples) // 210
    if npad is None:
        npad = _bucket_pad(n)
    # hand the (5, npad) target straight to the native extractor when the
    # bucket padding can hold every stream (saves a ~7 MB copy per stream
    # on the shared host core); streams may overhang n by 1-2 frames, so
    # re-zero [n:] to keep the padding contract bit-identical
    out = np.zeros((5, max(npad, n + 3)), np.float32)
    fs = extract_features_host(pcm_i16, true_samples, out=out)
    if fs and len(fs[0]) and fs[0].base is out:
        out[:, n:] = 0.0
        return (out if out.shape[1] == npad else out[:, :npad]), n
    out = out[:, :npad]
    if out.base is not None:
        out = np.ascontiguousarray(out)
    for j, f in enumerate(fs):
        k = min(len(f), n)
        out[j, :k] = f[:k]
    return out, n


def align_from_pcm(video_pcm_i16, audio_pcm_i16, fit_backend=None,
                   video_samples=None, audio_samples=None,
                   combine_prints=False):
    """Fast path: int16 PCM in, alignment out, one device round-trip.

    video_samples/audio_samples: true sample counts when the PCM arrays are
    already bucket-padded (e.g. by the pipeline's decode-ahead thread).
    combine_prints=True emits the reference combine()'s per-stage progress
    lines (describealign.py:1100-1113) around the feature stages in addition
    to align()'s own lines - used by the sequential pipeline loop.
    Returns align()'s 5-tuple plus the coarse-confidence margin (see
    matching._coarse_tracks; None only on legacy caches) - callers surface
    the low-confidence WARNING via warn_low_confidence(result[5]).
    Set DESCRIBEALIGN_PROFILE_DIR to capture a JAX/xprof device trace of the
    fused program (viewable with xprof/tensorboard).
    """
    _malloc_tune()
    profile_dir = os.environ.get('DESCRIBEALIGN_PROFILE_DIR')
    if profile_dir:
        with jax.profiler.trace(profile_dir):
            return _align_from_pcm_impl(video_pcm_i16, audio_pcm_i16,
                                        fit_backend, video_samples,
                                        audio_samples, combine_prints)
    return _align_from_pcm_impl(video_pcm_i16, audio_pcm_i16, fit_backend,
                                video_samples, audio_samples, combine_prints)


def _align_from_pcm_impl(video_pcm_i16, audio_pcm_i16, fit_backend=None,
                         video_samples=None, audio_samples=None,
                         combine_prints=False):
    fit_backend = _default_backend(fit_backend)
    if _feature_path() == 'host':
        if combine_prints:
            print("  computing video features... \r", end='')
        else:
            print("  memorizing video...        \r", end='')
        # both streams pad to the COMMON bucket: one compiled shape per
        # bucket serves any video/audio length combination (instead of a
        # quadratic family of (npad_a, npad_v) programs)
        sv = video_samples or video_pcm_i16.shape[1]
        sa = audio_samples or audio_pcm_i16.shape[1]
        npad = max(_bucket_pad(sv // 210), _bucket_pad(sa // 210))
        feats_v_np, nv = host_features_padded(video_pcm_i16, sv, npad)
        dev_v = jax.device_put(feats_v_np.astype(np.float16))  # async, f16
        if combine_prints:
            # the audio stream was decode-ahead'd with the video; the
            # reference's line sequence is preserved (1109-1113)
            print("  reading audio file...       \r", end='')
            print("  computing audio features...\r", end='')
        feats_a_np, na = host_features_padded(audio_pcm_i16, sa, npad)
        dev_a = jax.device_put(feats_a_np.astype(np.float16))
        if combine_prints:
            print("  memorizing video...        \r", end='')
        print("  matching audio...  \r", end='')
        if _use_streaming():
            y, x, margin = _streamed_lis(dev_a, na, dev_v, nv)
            return _host_stages_from_path(y, x, feats_a_np, feats_v_np,
                                          na, nv, fit_backend,
                                          margin=margin)
        quals, offs, starts, margin = matching.match_from_features(
            dev_a, na, dev_v, nv)
        return _host_stages(np.asarray(quals), np.asarray(offs),
                            np.asarray(starts), feats_a_np, feats_v_np,
                            na, nv, fit_backend,
                            margin=float(np.asarray(margin)))

    na = (audio_samples or audio_pcm_i16.shape[1]) // 210
    nv = (video_samples or video_pcm_i16.shape[1]) // 210
    print("  memorizing video...        \r", end='')
    # async uploads of both (half-size) PCM streams overlap
    dev_a = jax.device_put(_pad_pcm_i16(audio_pcm_i16))
    dev_v = jax.device_put(_pad_pcm_i16(video_pcm_i16))
    print("  matching audio...  \r", end='')
    quals, offs, starts, feats_a, feats_v, margin = \
        matching.extract_and_match(dev_a, na, dev_v, nv)
    feats_a_np = np.asarray(feats_a)
    feats_v_np = np.asarray(feats_v)
    return _host_stages(np.asarray(quals), np.asarray(offs),
                        np.asarray(starts), feats_a_np, feats_v_np, na, nv,
                        fit_backend, margin=float(np.asarray(margin)))


def align_batch_from_pcm(pairs, fit_backend=None, device_depth=4,
                         host_workers=None, true_samples=None, mesh=None):
    """Batch fast path: list of (video_pcm_i16, audio_pcm_i16) pairs.

    The device programs are dispatched asynchronously with a bounded queue
    depth (uploads and compute of pair i+1 overlap the result pull of pair
    i), and the host refinement stages run in a thread pool (the native
    DP/fused-lasso solvers release the GIL). This turns the reference's
    fully sequential directory loop (describealign.py:1077) into a
    pipelined batch; a single fused program per pair keeps peak HBM bounded
    regardless of batch size.

    mesh: an optional jax.sharding.Mesh - pairs are then matched
    data-parallel across its devices (sharded over the first axis, no
    collectives) in mesh-sized groups; host refinement stays per-pair.

    Returns a list of align() result tuples with the coarse-confidence
    margin appended (align_from_pcm's 6-tuple), one per pair.
    """
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    fit_backend = _default_backend(fit_backend)
    _malloc_tune()
    host_path = _feature_path() == 'host'
    b = len(pairs)
    if host_workers is None:
        # cores + 1: enough threads to keep one on device waits while the
        # others compute, without oversubscribing the host CPU
        host_workers = min(4, (os.cpu_count() or 1) + 1)
    if true_samples is None:
        true_samples = [(v.shape[1], a.shape[1]) for (v, a) in pairs]
    if mesh is not None:
        return _align_batch_sharded(pairs, true_samples, mesh, fit_backend,
                                    host_workers)
    if host_path and _use_streaming():
        return _align_batch_streamed(pairs, true_samples, fit_backend,
                                     host_workers, device_depth)

    def dispatch(i):
        v, a = pairs[i]
        sv, sa = true_samples[i]
        if host_path:
            npad = max(_bucket_pad(sv // 210), _bucket_pad(sa // 210))
            with _host_token():
                fv, nv = host_features_padded(v, sv, npad)
            dev_v = jax.device_put(fv.astype(np.float16))
            with _host_token():
                fa, na = host_features_padded(a, sa, npad)
            dev_a = jax.device_put(fa.astype(np.float16))
            quals, offs, starts, margin = matching.match_from_features(
                dev_a, na, dev_v, nv)
            return (i, (quals, offs, starts, fa, fv, margin))
        dev_a = jax.device_put(_pad_pcm_i16(a))
        dev_v = jax.device_put(_pad_pcm_i16(v))
        quals, offs, starts, feats_a, feats_v, margin = \
            matching.extract_and_match(dev_a, sa // 210, dev_v, sv // 210)
        return (i, (quals, offs, starts, feats_a, feats_v, margin))

    def pull_and_refine(i, out):
        # runs in a pool thread: the D2H pulls release the GIL, so the
        # transfer of pair i overlaps the CPU-bound feature extraction of
        # pair i+1 happening on the main thread
        quals = np.asarray(out[0])
        offs = np.asarray(out[1])
        starts = np.asarray(out[2])
        feats_a = np.asarray(out[3])
        feats_v = np.asarray(out[4])
        margin = float(np.asarray(out[5]))
        sv, sa = true_samples[i]
        with _host_token():
            return _host_stages(quals, offs, starts, feats_a, feats_v,
                                sa // 210, sv // 210, fit_backend, True,
                                margin=margin)

    in_flight = deque(dispatch(i) for i in range(min(device_depth, b)))
    next_i = len(in_flight)
    futs = []
    with ThreadPoolExecutor(max_workers=host_workers) as pool:
        while in_flight:
            i, out = in_flight.popleft()
            futs.append(pool.submit(pull_and_refine, i, out))
            if next_i < b:
                in_flight.append(dispatch(next_i))
                next_i += 1
        return [f.result() for f in futs]


def _pull_mode():
    """Batch compact-transport pull mode (DESCRIBEALIGN_BATCH_PULL):

    - 'sliced' (default): the MAIN thread pulls the pair's (2,) live
      totals two dispatches behind (the matcher has finished and the
      totals are their own output buffer, so no extra device program
      runs), dispatches an occupancy-bucketed prefix slice
      [0:fixed_end+ceil(live)] BEFORE the next pair's matcher (so it runs
      at once instead of queueing behind later matchers), and the pull
      pool moves counts+starts+occupied live bytes in ONE transfer.
    - 'whole': one D2H of the entire padded buffer - no totals pull, no
      slice program, live_max dead bytes.
    - 'exact': two-phase fixed-then-live pull from the pull pool; its
      live slice queues behind other in-flight pairs' matcher programs."""
    mode = os.environ.get('DESCRIBEALIGN_BATCH_PULL', 'sliced')
    return mode if mode in ('sliced', 'whole', 'exact') else 'sliced'


def _prefetch_fixed(compact_dev, nb, n_tracks):
    """Enqueue the compact transport's fixed-region slice right behind the
    pair's matcher program and start its D2H copy immediately (from the
    DISPATCH thread). By the time a pull worker picks the pair up, the
    counts+starts bytes are typically already host-side - the same bytes
    the consumer reads first, so the prefetch costs nothing extra."""
    lay = matching.compact_layout(nb, n_tracks)
    fixed_dev = compact_dev[:lay['fixed_end']]
    fixed_dev.copy_to_host_async()
    return fixed_dev


def _align_batch_streamed(pairs, true_samples, fit_backend, host_workers,
                          device_depth=4):
    """Batch via the streaming matcher, pipelined in three stages:

    - the MAIN thread extracts features (CPU), uploads, and dispatches
      pair i's device programs, then immediately moves to pair i+1;
    - a small PULL pool owns the transfers: it pulls each pair's result
      buffer(s) off the device (D2H releases the GIL) and releases the
      pair's in-flight slot as soon as the bytes are host-side;
    - the HOST pool runs the CPU stages (C++ LIS feed + refinement tail)
      on the pulled bytes, bounded by the core-count token.

    Splitting pull from CPU keeps transfer waits from occupying a CPU
    worker: during the drain (after the last dispatch) the remaining
    pairs' transfers proceed concurrently with the LIS/tail of earlier
    pairs instead of queueing behind them (scripts/profile_batch.py
    draws the timeline). In-flight device buffers stay bounded by
    device_depth (+1 being pulled).

    Unlike the latency-oriented single-pair path (which pulls chunks as
    they finish so the LIS can start early), throughput mode concatenates
    every chunk ON DEVICE and pulls one buffer per pair: one pull pays one
    fixed per-transfer cost instead of n_chunks, and other pairs' CPU work
    hides the transfer in the batch regime. Byte-identical input to the
    LIS either way (split-feed equivalence is native-layer-tested)."""
    import threading
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    b = len(pairs)
    results = [None] * b
    in_flight = threading.Semaphore(max(2, device_depth + 1))
    use_compact = _use_compact()
    use_fused = _use_fused_batch()
    pull_mode = _pull_mode()
    whole_pull = pull_mode == 'whole'

    def cpu_dense(packed, starts_tracks, margin, fa, fv, na, nv):
        with _host_token():
            y, x = _consume_stream(iter([packed]), starts_tracks)
            return _host_stages_from_path(y, x, fa, fv, na, nv,
                                          fit_backend, True, margin=margin)

    def _pull_dense_parts(combo_dev, n_tracks):
        # one pull per pair: the trailing int16 words per row are the
        # margin f16 word + pad, then 2*T bitcast band starts
        # (match_pair_combo / concat_chunks_with_starts)
        buf = np.asarray(combo_dev)
        w_st = 2 * n_tracks
        starts_tracks = np.ascontiguousarray(
            buf[:, -w_st:]).view(np.int32).T              # (T, B_pad)
        margin = matching.margin_from_i16(buf[0, -w_st - 2])
        # leading-columns VIEW: the strided native feed reads the
        # packed rows in place (no second media-scale copy)
        packed = buf[:, :-(w_st + 2)]
        return packed, starts_tracks, margin

    def pull_dense(cpu_pool, combo_dev, n_tracks, fa, fv, na, nv):
        try:
            packed, starts_tracks, margin = _pull_dense_parts(combo_dev,
                                                              n_tracks)
        finally:
            in_flight.release()
        return cpu_pool.submit(cpu_dense, packed, starts_tracks, margin,
                               fa, fv, na, nv)

    def cpu_compact(ctx, counts, live, sec, starts_grouped, margin,
                    fa, fv, na, nv):
        with _host_token():
            with ctx:
                ctx.feed_compact(
                    counts,
                    live[slice(*sec['codes1'])], live[slice(*sec['lo1'])],
                    live[slice(*sec['hi1'])],
                    live[slice(*sec['codes2'])], live[slice(*sec['lo2'])],
                    live[slice(*sec['hi2'])],
                    starts_grouped, blk=210)
                y, x = ctx.finish()
            return _host_stages_from_path(y, x, fa, fv, na, nv,
                                          fit_backend, True, margin=margin)

    def pull_compact(cpu_pool, fixed_dev, compact_dev, dense_dispatch,
                     n_tracks, nb, fa, fv, na, nv):
        """Pull stage for the compact transport: reads the (prefetched)
        fixed counts+starts region, recomputes the exact live-plane sizes
        from the counts, pulls just the occupied live bytes (quantized to
        lay['step'] so the eager slice programs stay bounded per shape
        bucket), then chains the CPU stage. Transfers are occupancy-exact
        with no budget to overflow; the dense fallback via
        dense_dispatch() remains only for an LIS frontier-cap miss and
        runs while the in-flight slot still bounds the device buffers."""
        try:
            lay = matching.compact_layout(nb, n_tracks)
            if fixed_dev is None:            # whole-buffer mode: ONE pull
                buf = np.asarray(compact_dev)
                fixed = buf[:lay['fixed_end']]
            else:
                buf = None
                fixed = np.asarray(fixed_dev)
            margin = matching.margin_from_code(fixed[1])
            counts = fixed[slice(*lay['counts'])]
            st = np.ascontiguousarray(
                fixed[slice(*lay['starts'])]).view(np.int32).reshape(nb, -1)
            starts_grouped = np.column_stack([st[:, 0], st[:, 0], st[:, 1]])
            max_key = int(starts_grouped.max()) + 32768
            ctx = None
            if max_key + 2 <= lis.LIS_STREAM_KEY_CAP:
                try:
                    ctx = lis.LisStream(max_key)
                except RuntimeError:
                    ctx = None
            if ctx is None:
                # frontier cap miss: dense fallback (rare)
                packed, starts_tracks, margin = _pull_dense_parts(
                    *dense_dispatch())
                return cpu_pool.submit(cpu_dense, packed, starts_tracks,
                                       margin, fa, fv, na, nv)
            t1 = int(np.sum(counts & 15, dtype=np.int64))
            t2 = int(np.sum(counts >> 4, dtype=np.int64))
            sec = matching.compact2_live_offsets(t1, t2)
            p0 = lay['live']
            q = min(lay['live_max'],
                    -(-sec['total'] // lay['step']) * lay['step'])
            if buf is not None:
                live = buf[p0:p0 + q]        # host view, no second pull
            else:
                live = np.asarray(compact_dev[p0:p0 + q])
        finally:
            in_flight.release()
        return cpu_pool.submit(cpu_compact, ctx, counts, live, sec,
                               starts_grouped, margin, fa, fv, na, nv)

    def pull_sliced(cpu_pool, sliced_dev, t1, t2, dense_dispatch,
                    n_tracks, nb, fa, fv, na, nv):
        """Pull stage for 'sliced' mode: the main thread already sized and
        dispatched the occupancy-bucketed prefix slice (counts + starts +
        occupied live bytes); this worker just moves it in ONE transfer
        and chains the CPU stage. Dense fallback only for an LIS
        frontier-cap miss, as in pull_compact."""
        try:
            lay = matching.compact_layout(nb, n_tracks)
            buf = np.asarray(sliced_dev)
            margin = matching.margin_from_code(buf[1])
            counts = buf[slice(*lay['counts'])]
            st = np.ascontiguousarray(
                buf[slice(*lay['starts'])]).view(np.int32).reshape(nb, -1)
            starts_grouped = np.column_stack([st[:, 0], st[:, 0], st[:, 1]])
            max_key = int(starts_grouped.max()) + 32768
            ctx = None
            if max_key + 2 <= lis.LIS_STREAM_KEY_CAP:
                try:
                    ctx = lis.LisStream(max_key)
                except RuntimeError:
                    ctx = None
            if ctx is None:
                packed, starts_tracks, margin = _pull_dense_parts(
                    *dense_dispatch())
                return cpu_pool.submit(cpu_dense, packed, starts_tracks,
                                       margin, fa, fv, na, nv)
            sec = matching.compact2_live_offsets(t1, t2)
            live = buf[lay['live']:]
        finally:
            in_flight.release()
        return cpu_pool.submit(cpu_compact, ctx, counts, live, sec,
                               starts_grouped, margin, fa, fv, na, nv)

    # 'sliced' mode: compact pairs wait here (lag 2) until their matcher
    # has certainly finished; the main thread then pulls the tiny totals
    # (pure round trip), dispatches the occupancy-bucketed prefix slice
    # BEFORE the next matcher (so it executes immediately on the stream),
    # and hands the one-transfer pull to the pull pool
    pending = deque()

    def flush_one(cpu_pool, pull_pool, futs):
        (i, compact_dev, totals_dev, dense_dispatch, n_tracks, nb,
         fa, fv, na, nv) = pending.popleft()
        totals = np.asarray(totals_dev)
        t1, t2 = int(totals[0]), int(totals[1])
        lay = matching.compact_layout(nb, n_tracks)
        sec = matching.compact2_live_offsets(t1, t2)
        q = min(lay['live_max'],
                -(-sec['total'] // lay['step']) * lay['step'])
        sliced_dev = compact_dev[:lay['fixed_end'] + q]
        futs.append((i, pull_pool.submit(
            pull_sliced, cpu_pool, sliced_dev, t1, t2, dense_dispatch,
            n_tracks, nb, fa, fv, na, nv)))

    futs = []
    with ThreadPoolExecutor(max_workers=host_workers) as cpu_pool, \
         ThreadPoolExecutor(max_workers=_pull_threads()) as pull_pool:
        for i in range(b):
            v, a = pairs[i]
            sv, sa = true_samples[i]
            while len(pending) >= 2:
                flush_one(cpu_pool, pull_pool, futs)
            in_flight.acquire()
            try:
                npad = max(_bucket_pad(sv // 210), _bucket_pad(sa // 210))
                with _host_token():
                    fv, nv = host_features_padded(v, sv, npad)
                    fa, na = host_features_padded(a, sa, npad)
                    # one combined H2D per pair ([0]=audio, [1]=video):
                    # one fixed per-transfer cost instead of two
                    fav = np.empty((2, 5, npad), np.float16)
                    fav[0] = fa
                    fav[1] = fv
                dev_av = jax.device_put(fav)
                nb = matching.nb_for(npad)
                if use_fused and matching.N_TRACKS == 2:
                    # ONE device dispatch per pair (coarse + all fine
                    # chunks + transport packing fused, matching.
                    # _match_pair_fused) - chunk-level dispatch only buys
                    # latency overlap, which batch mode gets from
                    # cross-pair pipelining, while each dispatch costs
                    # host CPU
                    if use_compact:
                        compact_dev, totals_dev = matching.match_pair_compact(
                            dev_av, na, nv)
                        dense_dispatch = (
                            lambda d=dev_av, a_=na, v_=nv:
                            (matching.match_pair_combo(d, a_, v_),
                             matching.N_TRACKS))
                        if pull_mode == 'sliced':
                            pending.append((i, compact_dev, totals_dev,
                                            dense_dispatch,
                                            matching.N_TRACKS, nb,
                                            fa, fv, na, nv))
                            continue
                        fixed_dev = (None if whole_pull else
                                     _prefetch_fixed(compact_dev, nb,
                                                     matching.N_TRACKS))
                        futs.append((i, pull_pool.submit(
                            pull_compact, cpu_pool, fixed_dev, compact_dev,
                            dense_dispatch,
                            matching.N_TRACKS, nb, fa, fv, na, nv)))
                    else:
                        combo_dev = matching.match_pair_combo(dev_av,
                                                              na, nv)
                        combo_dev.copy_to_host_async()
                        futs.append((i, pull_pool.submit(
                            pull_dense, cpu_pool, combo_dev,
                            matching.N_TRACKS, fa, fv, na, nv)))
                    continue
                chunks, starts_dev, _, margin_dev = \
                    matching.match_stream_pair(dev_av, na, nv)
                if use_compact and starts_dev.shape[0] == 2:
                    compact_dev, totals_dev = matching.concat_chunks_compact(
                        chunks, starts_dev, margin_dev)
                    dense_dispatch = (
                        lambda ch=chunks, sd=starts_dev, md=margin_dev:
                        (matching.concat_chunks_with_starts(ch, sd, md),
                         sd.shape[0]))
                    if pull_mode == 'sliced':
                        pending.append((i, compact_dev, totals_dev,
                                        dense_dispatch,
                                        starts_dev.shape[0], nb,
                                        fa, fv, na, nv))
                        continue
                    fixed_dev = (None if whole_pull else
                                 _prefetch_fixed(compact_dev, nb, 2))
                    futs.append((i, pull_pool.submit(
                        pull_compact, cpu_pool, fixed_dev, compact_dev,
                        dense_dispatch,
                        starts_dev.shape[0], nb, fa, fv, na, nv)))
                else:
                    combo_dev = matching.concat_chunks_with_starts(
                        chunks, starts_dev, margin_dev)
                    combo_dev.copy_to_host_async()
                    futs.append((i, pull_pool.submit(
                        pull_dense, cpu_pool, combo_dev,
                        starts_dev.shape[0], fa, fv, na, nv)))
            except BaseException:
                # a failing dispatch must not leak its semaphore slot;
                # in-flight pulls finish (and release theirs) during the
                # pools' shutdown. Like the non-streamed path, the first
                # error aborts the batch.
                in_flight.release()
                raise
        while pending:
            flush_one(cpu_pool, pull_pool, futs)
        for i, f in futs:
            results[i] = f.result().result()
    return results


def _align_batch_sharded(pairs, true_samples, mesh, fit_backend,
                         host_workers):
    """Data-parallel batch over a device mesh: pairs are grouped to the
    mesh size, features are padded to each group's COMMON bucket, and one
    shard_mapped program matches the whole group (one pair per device, no
    collectives - pure data parallelism). Host features and refinement remain
    per-pair on the host.
    """
    from concurrent.futures import ThreadPoolExecutor

    from ..parallel.batch import sharded_match

    n_dev = mesh.devices.size
    b = len(pairs)
    results = [None] * b
    with ThreadPoolExecutor(max_workers=host_workers) as pool:
        for g0 in range(0, b, n_dev):
            idx = list(range(g0, min(g0 + n_dev, b)))
            npad = max(max(_bucket_pad(sv // 210), _bucket_pad(sa // 210))
                       for (sv, sa) in (true_samples[i] for i in idx))
            fa_g = np.zeros((n_dev, 5, npad), np.float32)
            fv_g = np.zeros((n_dev, 5, npad), np.float32)
            lens_a = np.zeros(n_dev, np.int32)
            lens_v = np.zeros(n_dev, np.int32)
            for j, i in enumerate(idx):
                v, a = pairs[i]
                sv, sa = true_samples[i]
                fv_g[j], lens_v[j] = host_features_padded(v, sv, npad)
                fa_g[j], lens_a[j] = host_features_padded(a, sa, npad)
            # ragged tail groups replicate the last pair into empty slots
            for j in range(len(idx), n_dev):
                fa_g[j], fv_g[j] = fa_g[len(idx) - 1], fv_g[len(idx) - 1]
                lens_a[j], lens_v[j] = lens_a[len(idx) - 1], lens_v[len(idx) - 1]
            # f16 uploads, like the single-pair paths (same matcher view)
            quals, offs, starts, margins = sharded_match(
                mesh, fa_g.astype(np.float16), lens_a,
                fv_g.astype(np.float16), lens_v)
            quals = np.asarray(quals)
            offs = np.asarray(offs)
            starts = np.asarray(starts)
            margins = np.asarray(margins)
            futs = []
            for j, i in enumerate(idx):
                sv, sa = true_samples[i]
                futs.append((i, pool.submit(
                    _host_stages, quals[j], offs[j], starts[j],
                    fa_g[j], fv_g[j], sa // 210, sv // 210, fit_backend,
                    True, float(margins[j]))))
            for i, f in futs:
                results[i] = f.result()
    return results


def _padded_len(s):
    return (-(-(s + PAD_MARGIN * 210) // PCM_BUCKET)) * PCM_BUCKET


def warmup_compile(max_minutes):
    """Pre-compile the device matcher for every feature-bucket shape a
    media file of up to `max_minutes` can produce (the results land in the
    persistent compilation cache, so first real runs skip the multi-minute
    compile). The fast path pads both streams to the COMMON bucket, so one
    shape per bucket covers any video/audio length pairing."""
    buckets = sorted({_bucket_pad(int(m * 60 * 210))
                      for m in np.arange(1.0, max_minutes + 1.0)})
    for npad in buckets:
        print(f"  compiling bucket {npad}...      \r", end='')
        fa16 = np.zeros((5, npad), np.float16)
        fv16 = np.zeros((5, npad), np.float16)
        fa16[0, :210 * 30] = fv16[0, :210 * 30] = 1.0
        # production signatures: f16 uploads + the streamed coarse/chunk
        # programs, plus the single-shot program the feature-list align()
        # and non-native fallbacks use
        dev_a = jax.device_put(fa16)
        dev_v = jax.device_put(fv16)
        chunks, starts_dev, _, margin_dev = matching.match_stream(
            dev_a, 210 * 30, dev_v, 210 * 30)
        np.asarray(chunks[0])
        if _use_compact() and starts_dev.shape[0] == 2:
            # single-pair production path pulls per-chunk compact buffers
            k2 = (starts_dev.shape[0] - 1) * (matching.TOP_K // 2)
            np.asarray(matching.compact_chunk(chunks[0], k2=k2))
        np.asarray(starts_dev)
        out = matching.match_from_features(dev_a, 210 * 30, dev_v, 210 * 30)
        np.asarray(out[0])
        # the batch path (multi-pair combine()) uses the combined
        # ([0]=audio, [1]=video) upload; warm whichever dispatch mode +
        # transport it will use under the current env
        fav = np.zeros((2, 5, npad), np.float16)
        fav[:, 0, :210 * 30] = 1.0
        dev_av = jax.device_put(fav)
        compact_dev = totals_dev = None
        if _use_fused_batch() and matching.N_TRACKS == 2:
            if _use_compact():
                compact_dev, totals_dev = matching.match_pair_compact(
                    dev_av, 210 * 30, 210 * 30)
            else:
                np.asarray(matching.match_pair_combo(dev_av, 210 * 30,
                                                     210 * 30))
        else:
            chunks, starts_dev, _, margin_dev = matching.match_stream_pair(
                dev_av, 210 * 30, 210 * 30)
            if _use_compact() and starts_dev.shape[0] == 2:
                compact_dev, totals_dev = matching.concat_chunks_compact(
                    chunks, starts_dev, margin_dev)
            else:
                np.asarray(matching.concat_chunks_with_starts(
                    chunks, starts_dev, margin_dev))
        if compact_dev is not None:
            # warm the active pull mode's program family: the totals pull
            # plus each step-quantized slice size - 'sliced' prefix
            # slices [0:fixed_end+q], 'exact' live slices [p0:p0+q] -
            # dispatching compiles them (results land in the persistent
            # cache) without pulling the bytes
            np.asarray(totals_dev)
            lay = matching.compact_layout(matching.nb_for(npad),
                                          matching.N_TRACKS)
            np.asarray(compact_dev[:lay['fixed_end']])
            p0, step = lay['live'], lay['step']
            sliced = _pull_mode() == 'sliced'
            q = step
            while q < lay['live_max']:
                compact_dev[:p0 + q] if sliced else compact_dev[p0:p0 + q]
                q += step
            (compact_dev[:p0 + lay['live_max']] if sliced else
             compact_dev[p0:p0 + lay['live_max']])
    print(f"warmed {len(buckets)} shape buckets.            ")


def _packed_row_words(k):
    """int16 words per packed row of k slots (matching._pack_slots)."""
    return matching._packed_row_words_py(k)


def _unpack_chunk(packed, k1, k2):
    """Split a streamed chunk's flat int16 buffer back into band-1
    (u8 codes, i16 offsets) at full frame rate and rescue slots at even
    frames. Decodes matching._pack_slots' layout: per row, k u8 codes,
    k u8 offset low bytes, then k/4 high-bit bytes (2 bits/slot) padded
    to an even count."""
    c = packed.shape[0]
    blk = 210
    w1, w2 = _packed_row_words(k1), _packed_row_words(k2)
    n1 = blk * w1
    band1 = packed[:, :n1].reshape(c, blk, w1)
    rescue = packed[:, n1:].reshape(c, blk // 2, w2)

    def split(rows, k):
        by = np.ascontiguousarray(rows).view(np.uint8)
        q = by[:, :, :k]
        lo = by[:, :, k:2 * k].astype(np.int16)
        hi = by[:, :, 2 * k:2 * k + (k + 3) // 4]
        j = np.arange(k)
        hi_bits = ((hi[:, :, j // 4] >> (2 * (j % 4))) & 3).astype(np.int16)
        return q, lo | (hi_bits << 8)

    q1, o1 = split(band1, k1)
    q2, o2 = split(rescue, k2)
    return q1, o1, q2, o2


def _qual_dequant_np(code_u8):
    """Numpy twin of matching._qual_dequantize_f16 (bit-identical)."""
    code = code_u8.astype(np.int32)
    bits = np.where(code > 0,
                    (code + matching.QUAL_CODE_BASE) << 6, 0)
    return bits.astype(np.uint16).view(np.float16)


def _consume_stream(packed_iter, starts_tracks):
    """Feed streamed chunk buffers (numpy, in audio order) into a fresh
    C++ LIS and return the (video_path, audio_path) chain. Shared by the
    single-pair and batch streaming paths. Chunks may carry any number of
    blocks (256-block streaming pieces, or one whole-media buffer from the
    batch path's single-pull transport)."""
    # grouped starts for the LIS: band 1 twice (half-spans) + rescues
    starts_grouped = np.stack(
        [starts_tracks[0], starts_tracks[0]] + list(starts_tracks[1:]),
        axis=1).astype(np.int32)                      # (B_pad, G)
    # the frontier spans the video length plus the int16 offset range
    max_key = int(starts_grouped.max()) + 32768
    k1 = matching.TOP_K
    k2 = (starts_grouped.shape[1] - 2) * (matching.TOP_K // 2)
    ctx = None
    if max_key + 2 <= lis.LIS_STREAM_KEY_CAP:
        try:
            ctx = lis.LisStream(max_key)
        except RuntimeError:
            ctx = None
    if ctx is None:
        # the native frontier rejects key ranges over its cap (~355 h of
        # video) or may fail to allocate: degrade to assembling the full
        # candidate arrays and running the single-shot LIS (which has its
        # own native -> Python fallback) instead of crashing.
        quals_all, offs_all = [], []
        for packed in packed_iter:
            q1, o1, q2, o2 = _unpack_chunk(packed, k1, k2)
            c = q1.shape[0]
            q = np.zeros((c, 210, k1 + k2), np.float32)
            o = np.zeros((c, 210, k1 + k2), np.int16)
            q[:, :, :k1] = _qual_dequant_np(q1)
            o[:, :, :k1] = o1
            q[:, ::2, k1:] = _qual_dequant_np(q2)
            o[:, ::2, k1:] = o2
            quals_all.append(q)
            offs_all.append(o)
        quals = np.concatenate(quals_all)
        offs = np.concatenate(offs_all)
        return lis.lis_from_match(quals, offs, starts_grouped[:len(quals)])
    with ctx:
        row = 0
        for packed in packed_iter:
            nblk = packed.shape[0]
            ctx.feed_packed(packed, starts_grouped[row:row + nblk],
                            a_base=row * 210, blk=210, k1=k1, k2=k2)
            row += nblk
        return ctx.finish()


def _pull_threads():
    # two concurrent D2H pulls overlap each transfer's fixed cost across
    # chunks
    return int(os.environ.get('DESCRIBEALIGN_PULL_THREADS', '2'))


_host_token_sem = None


def _host_token():
    """Semaphore bounding CONCURRENT heavy native sections in batch mode
    to the physical core count (DESCRIBEALIGN_HOST_TOKENS overrides).

    The batch path's CPU-heavy sections (feature extraction, the LIS
    feed, the refinement tail) all release the GIL, so worker threads
    genuinely timeslice on the core(s). Their working sets are multi-MB,
    so each preemption refills the cache: per-thread CPU measured ~15-25%
    higher when two native sections interleave on one core than solo
    (scripts/profile_batch.py vs profile_tail.py). Holding a token for
    the duration of a section keeps at most n_cores of them in flight;
    device pulls and dispatches stay OUTSIDE the token so transfers
    still overlap compute.
    """
    global _host_token_sem
    if _host_token_sem is None:
        import threading
        n = int(os.environ.get('DESCRIBEALIGN_HOST_TOKENS', '0') or '0')
        if n <= 0:
            n = os.cpu_count() or 1
        _host_token_sem = threading.BoundedSemaphore(n)
    return _host_token_sem


_malloc_tuned = False


def _malloc_tune():
    """One-time glibc allocator tuning for the media-scale host stages.

    The host tail allocates tens of MB of numpy temporaries per pair
    (concatenated pass-2 planes, sort keys, pulled candidate buffers) -
    all far above glibc's default 128 KB M_MMAP_THRESHOLD, so by default
    every one is a fresh mmap, faulted in page by page and munmapped on
    free: a cold refinement tail pays several times its warm CPU in
    page-fault/zeroing kernel time, and concurrent batch threads
    serialize on mmap_lock. Raising the mmap/trim thresholds keeps those
    buffers on reusable arena heap. Costs retained heap (bounded by the
    per-thread working set); DESCRIBEALIGN_MALLOC_TUNE=0 opts out."""
    global _malloc_tuned
    if _malloc_tuned or os.environ.get('DESCRIBEALIGN_MALLOC_TUNE') == '0':
        return
    _malloc_tuned = True
    try:
        import ctypes
        libc = ctypes.CDLL(None)
        m_mmap_threshold, m_trim_threshold = -3, -1
        libc.mallopt(m_mmap_threshold, 256 << 20)
        libc.mallopt(m_trim_threshold, 256 << 20)
    except Exception:
        pass    # non-glibc platforms: default allocator behavior


def _use_compact():
    """Whether the compacted candidate transport is enabled (fewer D2H
    bytes + a live-slots-only LIS feed; dense fallback on budget
    overflow, so correctness never depends on it). Default ON; set
    DESCRIBEALIGN_COMPACT=0 for the dense transport (scripts/
    bench_batch_ab.py compares the two)."""
    return os.environ.get('DESCRIBEALIGN_COMPACT', '1') != '0'


def _use_fused_batch():
    """Whether the batch path dispatches the whole matcher as ONE fused
    program per pair (matching.match_pair_combo/_compact) instead of
    coarse + per-chunk programs. Content-identical output buffers.
    Default OFF: per-chunk pulls overlap the C++ LIS feed, which the
    fused program's single end-of-dispatch pull cannot; set
    DESCRIBEALIGN_FUSED_BATCH=1 to opt in."""
    return os.environ.get('DESCRIBEALIGN_FUSED_BATCH', '0') == '1'


def _consume_stream_compact(bufs_iter, dense_chunks, starts_tracks):
    """Compact streaming consumer: per-chunk compact buffers feed the C++
    LIS through the live-prefix entry (matching.compact_chunk layout); a
    chunk whose live slots overflowed its budgets (header flag) falls back
    to pulling THAT chunk's dense buffer, which is still dispatchable. If
    the native frontier rejects the key range, degrade to the dense
    consumer wholesale (it carries its own single-shot fallback)."""
    starts_grouped = np.stack(
        [starts_tracks[0], starts_tracks[0]] + list(starts_tracks[1:]),
        axis=1).astype(np.int32)                      # (B_pad, G)
    max_key = int(starts_grouped.max()) + 32768
    k1 = matching.TOP_K
    k2 = (starts_grouped.shape[1] - 2) * (matching.TOP_K // 2)
    ctx = None
    if max_key + 2 <= lis.LIS_STREAM_KEY_CAP:
        try:
            ctx = lis.LisStream(max_key)
        except RuntimeError:
            ctx = None
    if ctx is None:
        return _consume_stream(
            (np.asarray(ch) for ch in dense_chunks), starts_tracks)
    with ctx:
        row = 0
        for ci, buf in enumerate(bufs_iter):
            nblk = dense_chunks[ci].shape[0]
            if buf[0]:
                # budget overflow (rare): this chunk rides the dense
                # transport; content is identical either way
                ctx.feed_packed(np.asarray(dense_chunks[ci]),
                                starts_grouped[row:row + nblk],
                                a_base=row * 210, blk=210, k1=k1, k2=k2)
            else:
                lay = matching.compact_chunk_layout(nblk)
                ctx.feed_compact(
                    buf[slice(*lay['counts'])],
                    buf[slice(*lay['codes1'])], buf[slice(*lay['lo1'])],
                    buf[slice(*lay['hi1'])],
                    buf[slice(*lay['codes2'])], buf[slice(*lay['lo2'])],
                    buf[slice(*lay['hi2'])],
                    starts_grouped[row:row + nblk], blk=210,
                    a_base=row * 210)
            row += nblk
        return ctx.finish()


def _streamed_lis(dev_a, na, dev_v, nv):
    """Chunked matcher + streaming LIS: the fine pass is dispatched in
    FINE_CHUNK-block pieces; prefetch threads pull chunks off the device
    (the D2H releases the GIL, so transfers overlap each other and
    the compute) while the main thread feeds finished chunks into the
    stateful C++ LIS in audio order. Returns (video_path, audio_path,
    coarse margin); the paths are identical to the single-shot
    pipeline's."""
    from concurrent.futures import ThreadPoolExecutor

    chunks, starts_tracks_dev, _, margin_dev = matching.match_stream(
        dev_a, na, dev_v, nv)
    if _use_compact() and starts_tracks_dev.shape[0] == 2:
        k2 = (starts_tracks_dev.shape[0] - 1) * (matching.TOP_K // 2)
        comp = [matching.compact_chunk(ch, k2=k2) for ch in chunks]
        with ThreadPoolExecutor(_pull_threads()) as pool:
            futs = [pool.submit(lambda c=c: np.asarray(c)) for c in comp]
            mfut = pool.submit(lambda: float(np.asarray(margin_dev)))
            starts_tracks = np.asarray(starts_tracks_dev)
            y, x = _consume_stream_compact((f.result() for f in futs),
                                           chunks, starts_tracks)
            return y, x, mfut.result()
    with ThreadPoolExecutor(_pull_threads()) as pool:
        futs = [pool.submit(lambda ch=ch: np.asarray(ch)) for ch in chunks]
        mfut = pool.submit(lambda: float(np.asarray(margin_dev)))
        # pull the (tiny) coarse starts while the first chunks compute
        starts_tracks = np.asarray(starts_tracks_dev)
        y, x = _consume_stream((f.result() for f in futs), starts_tracks)
        return y, x, mfut.result()


def _use_streaming():
    import os
    return (os.environ.get('DESCRIBEALIGN_STREAM', '1') != '0'
            and lis.LisStream.available())


def _rescale_native(feats_a_np, feats_v_np, na, nv, xi, yi,
                    audio_scaled, video_scaled):
    """Native one-pass twin of the rescale loop below (features.cpp
    rescale_feature); returns False when the library is unavailable so the
    numpy path runs instead. Equality is unit-tested (test_host_features).
    """
    import ctypes

    from .native import native_lib
    lib = native_lib()
    if lib is None or not hasattr(lib, 'rescale_feature'):
        return False
    if not (feats_a_np.dtype == np.float32 and feats_a_np.flags.c_contiguous
            and feats_v_np.dtype == np.float32
            and feats_v_np.flags.c_contiguous):
        return False
    fp = ctypes.POINTER(ctypes.c_float)
    lp = ctypes.POINTER(ctypes.c_int64)
    for j in range(3):
        rc = lib.rescale_feature(
            feats_v_np[j].ctypes.data_as(fp), ctypes.c_int64(nv),
            feats_a_np[j].ctypes.data_as(fp), ctypes.c_int64(na),
            yi.ctypes.data_as(lp), xi.ctypes.data_as(lp),
            ctypes.c_int64(len(xi)),
            ctypes.cast(audio_scaled.ctypes.data + 4 * j, fp),
            ctypes.cast(video_scaled.ctypes.data + 4 * j, fp),
            ctypes.c_int64(3))
        if rc != 0:
            return False
    return True


def warn_low_confidence(margin):
    """Emit the low-confidence WARNING line when the coarse k-best margin
    sits below the campaign-calibrated floor (matching.COARSE_MARGIN_FLOOR;
    see matching._coarse_tracks). The reference's equivalent is the
    hash-gate path starving into a raise (describealign.py:698-699); we
    warn instead of refusing because the fine gates + LIS recover correct
    maps on 5 of 12 adjudicated narrowband draws where the reference
    raises (scripts/diag_narrowband.py)."""
    if margin is not None and margin < matching.COARSE_MARGIN_FLOOR:
        print(f"  WARNING: low alignment confidence (coarse margin "
              f"{margin:.3f}), likely mismatched or heavily distorted "
              f"files")


def _host_stages(quals, offs, starts, feats_a_np, feats_v_np, na, nv,
                 fit_backend, quiet=False, margin=None):
    """LIS -> filter -> rescale -> compress -> fit -> pass 2 -> outputs."""
    y, x = lis.lis_from_match(quals, offs, starts)  # y=video, x=audio
    return _host_stages_from_path(y, x, feats_a_np, feats_v_np, na, nv,
                                  fit_backend, quiet, margin=margin)


def _host_stages_from_path(y, x, feats_a_np, feats_v_np, na, nv,
                           fit_backend, quiet=False, margin=None):
    try:
        if os.environ.get('DESCRIBEALIGN_TAIL_DEBUG'):
            r = _host_stages_from_path_timed(y, x, feats_a_np, feats_v_np,
                                             na, nv, fit_backend, quiet)
        else:
            r = _host_stages_from_path_inner(y, x, feats_a_np, feats_v_np,
                                             na, nv, fit_backend, quiet)
    except RuntimeError:
        # the reference's "Alignment failed" path-length raise
        # (describealign.py:698-699): before refusing, take the 5-stream
        # second look too - a too-short LIS chain is the SAME coarse-
        # signal starvation the low-margin guard detects, just one stage
        # later. The retry requires its own margin to clear the floor
        # (not the failed track's), so a genuine mismatch still raises.
        if margin is not None and _use_coarse_retry():
            retried = _coarse_retry(feats_a_np, feats_v_np, na, nv,
                                    fit_backend, quiet, None)
            if retried is not None:
                return retried
        raise
    if (margin is not None and margin < matching.COARSE_MARGIN_FLOOR
            and _use_coarse_retry()):
        retried = _coarse_retry(feats_a_np, feats_v_np, na, nv,
                                fit_backend, quiet, margin)
        if retried is not None:
            return retried
    return r + (margin,)


def _use_coarse_retry():
    return os.environ.get('DESCRIBEALIGN_COARSE_RETRY', '1') != '0'


def _coarse_retry(feats_a_np, feats_v_np, na, nv, fit_backend, quiet,
                  margin):
    """Low-confidence escalation: re-run the matcher with the coarse pass
    over ALL 5 feature streams (matching.COARSE_RETRY_STREAMS).

    The 3-stream coarse descriptors lose their signal when energy and
    zero-crossings are corrupted (DC offsets, narrowband channels - the
    dcrate/narrowband campaign regimes); the two upper band features are
    immune, the same reason the reference's candidate gate survives there
    (it consults all 5 hash dicts, describealign.py:650-652). Every
    transport funnels through _host_stages_from_path, so single-pair,
    streamed, batch, and sharded paths all escalate identically (the
    retry itself is deterministic given the feature stacks).

    The retried result replaces the original ONLY when its margin -
    normalized to the 3-stream scale the confidence floor was calibrated
    at (scores are sums over streams) - clears both the floor and the
    original margin; otherwise the original result ships with its
    WARNING. On the raise path (margin=None: the original track already
    failed the reference's minimum-path-length check) only the floor
    gates acceptance. Any retry failure (e.g. the retried track also
    collapses the path below the minimum-length raise) falls back to the
    original result/raise. Disable with DESCRIBEALIGN_COARSE_RETRY=0."""
    if matching.COARSE_STREAMS >= matching.COARSE_RETRY_STREAMS:
        return None         # already running on the full descriptor set
    try:
        if not quiet:
            print("  rechecking alignment (full-band descriptors)...\r",
                  end='')
        dev_a = jax.device_put(feats_a_np.astype(np.float16))
        dev_v = jax.device_put(feats_v_np.astype(np.float16))
        quals, offs, starts, m_r = matching.match_from_features(
            dev_a, na, dev_v, nv, nf=matching.COARSE_RETRY_STREAMS)
        m_r = (float(np.asarray(m_r))
               * matching.COARSE_STREAMS / matching.COARSE_RETRY_STREAMS)
        # margin=None: raise-path escalation - the original track already
        # failed outright, so only the calibrated floor gates the retry
        bar = (matching.COARSE_MARGIN_FLOOR if margin is None else
               max(margin, matching.COARSE_MARGIN_FLOOR))
        if not (np.isfinite(m_r) and m_r > bar):
            return None
        y, x = lis.lis_from_match(np.asarray(quals), np.asarray(offs),
                                  np.asarray(starts))
        r = _host_stages_from_path_inner(y, x, feats_a_np, feats_v_np,
                                         na, nv, fit_backend, quiet)
        return r + (m_r,)
    except Exception:
        return None


def _host_stages_from_path_timed(y, x, feats_a_np, feats_v_np, na, nv,
                                 fit_backend, quiet=False):
    """Dev-only (DESCRIBEALIGN_TAIL_DEBUG=1): per-stage wall+thread-CPU
    prints for each tail invocation, for profiling the batch path."""
    import time

    marks = [('start', time.time(), time.thread_time())]

    def mark(tag):
        marks.append((tag, time.time(), time.thread_time()))

    r = _host_stages_from_path_inner(y, x, feats_a_np, feats_v_np, na, nv,
                                     fit_backend, quiet, mark)
    parts = " ".join(
        f"{tag}={1e3 * (t1 - t0):.0f}/{1e3 * (c1 - c0):.0f}ms"
        for (tag, t1, c1), (_, t0, c0) in zip(marks[1:], marks[:-1]))
    print(f"[tail-debug] len={len(x)} {parts}", flush=True)
    return r


def _host_stages_from_path_inner(y, x, feats_a_np, feats_v_np, na, nv,
                                 fit_backend, quiet=False, mark=None):
    _fail_if_short(len(x), nv, na)

    if not quiet:
        print("  refining match: pass 1 of 2...\r", end='')
    x, y = continuity.continuity_filter(
        np.asarray(x, np.float64), np.asarray(y, np.float64))
    if mark:
        mark('cont')

    # least-squares gain match of video features to the audio's scale
    # (reference 733-741); the (N,1) lstsq reduces to a ratio of dots.
    # Scalar reductions stay f64; the scaled streams are stored f32 - the
    # pass-2 scoring consumes them through log10 of |differences| ~1e-4..1,
    # where f32's 1e-7 relative noise is far below the cluster DP's
    # decision scale (reference-parity campaign re-validated at f32).
    # Only the first 3 streams are rescaled: they are all the pass-2
    # scorer consumes (the reference rescales all 5 but likewise only
    # feeds the first 3 into pass 2, describealign.py:864, 933).
    yi = np.ascontiguousarray(y, np.int64)
    xi = np.ascontiguousarray(x, np.int64)
    audio_scaled = np.empty((na, 3), np.float32)
    video_scaled = np.empty((nv, 3), np.float32)
    if not _rescale_native(feats_a_np, feats_v_np, na, nv, xi, yi,
                           audio_scaled, video_scaled):
        for j in range(3):
            vf = feats_v_np[j, :nv].astype(np.float64)
            af = feats_a_np[j, :na].astype(np.float64)
            af_std = np.std(af)
            vy = vf[yi]
            scale = np.dot(vy, af[xi]) / np.maximum(np.dot(vy, vy), 1e-30)
            audio_scaled[:, j] = af / af_std
            video_scaled[:, j] = vf * (scale / af_std)

    if mark:
        mark('rescale')
    cx, cy = continuity.compress_path(x, y)
    if mark:
        mark('compress')
    fit_result = fit.solve_l1_fit(cx, cy, backend=fit_backend)
    if mark:
        mark('fit')
    smooth_path = list(zip(cx, fit_result['smooth_y']))

    if not quiet:
        print("  refining match: pass 2 of 2...\r", end='')
    clusters = refine.build_line_clusters(smooth_path, fit_result['slopes'])
    if mark:
        mark('clusters')
    pj, pc, pq, offsets = refine.build_points_flat(clusters, audio_scaled,
                                                   video_scaled)
    if mark:
        mark('p2score')
    path = refine_dp_flat(pj, pc, pq, offsets, len(clusters),
                          len(video_scaled))
    if mark:
        mark('p2dp')
    _fail_if_short(len(path), nv, na)

    audio_times, video_times, similarity_percent, path_s = \
        outputs.similarity_and_nodes(path, len(audio_scaled),
                                     len(video_scaled), na, nv)
    if mark:
        mark('outputs')
    return (audio_times, video_times, similarity_percent, path_s,
            fit_result['median_slope'])
