"""Weighted longest-increasing-subsequence chain over match candidates.

Exact reference semantics (describealign.py:654-699): candidates are
processed in (audio, video, qual) order; a sorted structure keyed by video
index holds the best cumulative quality ending at each video position;
dominated entries (later video, lower cum quality) are pruned; backpointers
reconstruct the maximal monotone chain.

Irregular, data-dependent DP does not map to dense accelerator kernels; it
runs on the host. A C++ implementation (native/dp.cpp) handles production
sizes; the Python version here is the semantic reference used to validate
it.
"""
import bisect

import numpy as np

from .native import native_lib

# dp.cpp lis_stream_new rejects caps over 2^28 keys (~355 h of video at
# 210 fps; bounds the frontier allocation at ~4.3 GB). Callers pre-check
# their max key against this and fall back to the single-shot path.
LIS_STREAM_KEY_CAP = 1 << 28


class KeyedList:
    """Tuples kept sorted by their first element (the Python reference
    DPs' frontier). A new tuple goes after those with an equal key; reads,
    deletes and slices index the sorted order."""

    def __init__(self):
        self._keys = []
        self._items = []

    def bisect_right(self, key):
        return bisect.bisect_right(self._keys, key)

    def add(self, item):
        i = bisect.bisect_right(self._keys, item[0])
        self._keys.insert(i, item[0])
        self._items.insert(i, item)

    def __len__(self):
        return len(self._items)

    def __getitem__(self, i):
        return self._items[i]

    def __delitem__(self, i):
        del self._keys[i]
        del self._items[i]


def weighted_lis_py(audio_idx, video_idx, qual):
    """Pure-Python exact LIS. Inputs sorted by (audio, video, qual).

    Returns (video_path, audio_path) int64 arrays (increasing audio order).
    """
    # entries: (video, cum_qual, node_id); node-id backpointers cannot cycle
    # even on duplicate (video, audio) keys (the reference's dict-keyed walk
    # relies on unique keys and a 1e8 failsafe, describealign.py:691-694)
    best = KeyedList()
    best.add((-1, 0.0, 0))
    nodes_v = [-1]
    nodes_a = [-1]
    nodes_prev = [-1]
    for v, i, q in zip(video_idx.tolist(), audio_idx.tolist(), qual.tolist()):
        cur = best.bisect_right(v)
        _, prev_cum, prev_node = best[cur - 1]
        cum = prev_cum + q
        while cur < len(best) and best[cur][1] <= cum:
            del best[cur]
        nodes_v.append(v)
        nodes_a.append(i)
        nodes_prev.append(prev_node)
        best.add((v, cum, len(nodes_v) - 1))
    path = []
    node = best[-1][2]
    while node != 0:
        path.append((nodes_v[node], nodes_a[node]))
        node = nodes_prev[node]
    path.reverse()
    arr = np.array(path, dtype=np.int64).reshape(-1, 2)
    return arr[:, 0], arr[:, 1]


def weighted_lis_native(audio_idx, video_idx, qual):
    import ctypes
    lib = native_lib()
    n = len(qual)
    out_v = np.empty(n + 1, np.int64)
    out_a = np.empty(n + 1, np.int64)
    out_len = ctypes.c_longlong(0)
    rc = lib.weighted_lis(
        video_idx.astype(np.int64).ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        audio_idx.astype(np.int64).ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        qual.astype(np.float64).ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_longlong(n),
        out_v.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        out_a.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        ctypes.byref(out_len))
    if rc != 0:
        raise RuntimeError("native weighted_lis failed")
    m = out_len.value
    return out_v[:m].copy(), out_a[:m].copy()


def weighted_lis(audio_idx, video_idx, qual):
    """Dispatch to the native DP when available, Python otherwise."""
    if native_lib() is not None:
        return weighted_lis_native(audio_idx, video_idx, qual)
    return weighted_lis_py(audio_idx, video_idx, qual)


def lis_from_match(quals, offs, starts):
    """Fused flatten + sort + LIS straight off the compressed matcher output.

    quals: (B, 210, G*K) f32, 0 marks empty; offs: (B, 210, G*K) int16
    band offsets; starts: (B, G) int32 band starts - slot j belongs to
    band j // K and its video frame is starts[b, j//K] + off. (G=1 with a
    1-D starts array also works.) One C++ pass replaces the
    flatten/lexsort/LIS cascade - the flatten and full lexsort dominated
    the host stages at media scale; exact duplicates from overlapping
    bands collapse like the reference's per-frame candidate sets.
    """
    import ctypes
    quals = np.ascontiguousarray(quals, np.float32)
    offs = np.ascontiguousarray(offs, np.int16)
    starts = np.ascontiguousarray(starts, np.int32)
    if starts.ndim == 1:
        starts = starts[:, None]
    nb, blk, k = quals.shape
    n_groups = starts.shape[1]
    lib = native_lib()
    if lib is not None and hasattr(lib, 'lis_from_match'):
        cap = nb * blk * k + 1
        out_v = np.empty(cap, np.int64)
        out_a = np.empty(cap, np.int64)
        out_len = ctypes.c_longlong(0)
        rc = lib.lis_from_match(
            quals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_longlong(nb), ctypes.c_longlong(blk),
            ctypes.c_longlong(k), ctypes.c_longlong(n_groups),
            out_v.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            out_a.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            ctypes.byref(out_len))
        if rc == 0:
            m = out_len.value
            return out_v[:m].copy(), out_a[:m].copy()
    slot_starts = np.repeat(starts.astype(np.int64), k // n_groups, axis=1)
    vids = slot_starts[:, None, :] + offs
    a, v, q = candidates_from_match_output(quals, vids)
    # overlapping bands can duplicate a candidate; the reference's
    # per-frame candidate sets keep one copy
    _, first = np.unique(np.stack([a, v, q.view(np.int64)]), axis=1,
                         return_index=True)
    keep = np.sort(first)
    return weighted_lis_py(a[keep], v[keep], q[keep])


class LisStream:
    """Streaming weighted LIS over chunked matcher output.

    Feed chunks in audio order (each chunk shaped like lis_from_match's
    input, plus its absolute first audio frame); finish() returns the same
    (video_path, audio_path) the single-shot lis_from_match would. Lets the
    host DP run while later chunks are still computing on the device or in
    flight on the link. Requires the native library (callers check
    available() and fall back to the single-shot path).
    """

    def __init__(self, max_video_key):
        import ctypes
        self._lib = native_lib()
        if self._lib is None or not hasattr(self._lib, 'lis_stream_new'):
            raise RuntimeError("native library unavailable")
        self._ctx = self._lib.lis_stream_new(
            ctypes.c_longlong(int(max_video_key) + 2))
        if not self._ctx:
            raise RuntimeError("lis_stream_new failed")

    @staticmethod
    def available():
        lib = native_lib()
        return lib is not None and hasattr(lib, 'lis_stream_new')

    def feed(self, quals, offs, starts, a_base):
        import ctypes
        quals = np.ascontiguousarray(quals, np.float32)
        offs = np.ascontiguousarray(offs, np.int16)
        starts = np.ascontiguousarray(starts, np.int32)
        if starts.ndim == 1:
            starts = starts[:, None]
        nb, blk, k = quals.shape
        rc = self._lib.lis_stream_feed(
            ctypes.c_void_p(self._ctx),
            quals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_longlong(nb), ctypes.c_longlong(blk),
            ctypes.c_longlong(k), ctypes.c_longlong(starts.shape[1]),
            ctypes.c_longlong(int(a_base)))
        if rc != 0:
            raise RuntimeError("lis_stream_feed failed")

    def feed_u8(self, qcodes, offs, starts, a_base):
        """Feed a chunk whose qualities are u8 transport codes (the grid of
        matching._qual_quantize_u8); decoded in C++ bit-identically to the
        f16 values the single-shot path returns."""
        import ctypes
        qcodes = np.ascontiguousarray(qcodes, np.uint8)
        offs = np.ascontiguousarray(offs, np.int16)
        starts = np.ascontiguousarray(starts, np.int32)
        if starts.ndim == 1:
            starts = starts[:, None]
        nb, blk, k = qcodes.shape
        rc = self._lib.lis_stream_feed_u8(
            ctypes.c_void_p(self._ctx),
            qcodes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_longlong(nb), ctypes.c_longlong(blk),
            ctypes.c_longlong(k), ctypes.c_longlong(starts.shape[1]),
            ctypes.c_longlong(int(a_base)))
        if rc != 0:
            raise RuntimeError("lis_stream_feed_u8 failed")

    def feed_packed(self, packed, starts, a_base, blk, k1, k2):
        """Feed a chunk straight from its packed int16 transport buffer
        (matching.match_fine_chunk's layout: band-1 code words + offsets at
        full frame rate, rescue rows for even frames) - zero host-side
        copies; semantics identical to feed_split on the unpacked arrays.

        `packed` may be a leading-columns VIEW of a wider (nb, W) int16
        array (the batch path's combined transport buffer carries bitcast
        band starts in its trailing words): rows that are int16-contiguous
        but a constant stride apart feed in place via the strided native
        entry, with no 2-D copy."""
        import ctypes
        packed = np.asarray(packed)
        strided = (packed.ndim == 2 and packed.dtype == np.int16
                   and packed.strides[1] == 2 and packed.strides[0] >= 0
                   and packed.strides[0] % 2 == 0
                   and hasattr(self._lib, 'lis_stream_feed_packed_strided'))
        if not strided:
            packed = np.ascontiguousarray(packed, np.int16)
        starts = np.ascontiguousarray(starts, np.int32)
        if starts.ndim == 1:
            starts = starts[:, None]
        nb = packed.shape[0]
        if strided:
            row_stride_words = (packed.strides[0] // 2 if nb > 1
                                else packed.shape[1])
            rc = self._lib.lis_stream_feed_packed_strided(
                ctypes.c_void_p(self._ctx),
                packed.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                ctypes.c_longlong(row_stride_words),
                starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                ctypes.c_longlong(nb), ctypes.c_longlong(blk),
                ctypes.c_longlong(k1), ctypes.c_longlong(k2),
                ctypes.c_longlong(starts.shape[1]),
                ctypes.c_longlong(int(a_base)))
        else:
            rc = self._lib.lis_stream_feed_packed(
                ctypes.c_void_p(self._ctx),
                packed.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                ctypes.c_longlong(nb), ctypes.c_longlong(blk),
                ctypes.c_longlong(k1), ctypes.c_longlong(k2),
                ctypes.c_longlong(starts.shape[1]),
                ctypes.c_longlong(int(a_base)))
        if rc != 0:
            raise RuntimeError("lis_stream_feed_packed failed")

    def feed_compact(self, counts, codes1, lo1, hi1, codes2, lo2, hi2,
                     starts, blk, a_base=0):
        """Feed a whole pair from the compact batch transport's planes
        (matching.concat_chunks_compact layout): per-frame counts + live-
        prefix slot planes with globally 2-bit-packed offset highs.
        starts: (nb, 3) i32 (band-1 half-groups must share one start)."""
        import ctypes
        counts = np.ascontiguousarray(counts, np.uint8)
        starts = np.ascontiguousarray(starts, np.int32)
        if starts.ndim != 2 or starts.shape[1] != 3:
            raise ValueError("compact feed needs (nb, 3) starts")
        if not np.array_equal(starts[:, 0], starts[:, 1]):
            raise ValueError("band-1 half-group starts differ")
        planes = [np.ascontiguousarray(p, np.uint8)
                  for p in (codes1, lo1, hi1, codes2, lo2, hi2)]
        nb = starts.shape[0]
        if counts.size != nb * blk:
            raise ValueError("counts size mismatch")
        u8p = ctypes.POINTER(ctypes.c_uint8)
        rc = self._lib.lis_stream_feed_compact(
            ctypes.c_void_p(self._ctx),
            counts.ctypes.data_as(u8p),
            planes[0].ctypes.data_as(u8p), planes[1].ctypes.data_as(u8p),
            planes[2].ctypes.data_as(u8p),
            ctypes.c_longlong(planes[0].size),
            planes[3].ctypes.data_as(u8p), planes[4].ctypes.data_as(u8p),
            planes[5].ctypes.data_as(u8p),
            ctypes.c_longlong(planes[3].size),
            starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_longlong(nb), ctypes.c_longlong(blk),
            ctypes.c_longlong(starts.shape[1]),
            ctypes.c_longlong(int(a_base)))
        if rc != 0:
            raise RuntimeError(f"lis_stream_feed_compact failed (rc={rc})")

    def feed_split(self, q1, o1, q2, o2, starts, a_base):
        """Feed a chunk in the split transport layout: band-1 u8 codes and
        offsets at full frame rate (nb, blk, k1) plus rescue-band codes and
        offsets for even frames only (nb, blk//2, k2)."""
        import ctypes
        q1 = np.ascontiguousarray(q1, np.uint8)
        o1 = np.ascontiguousarray(o1, np.int16)
        q2 = np.ascontiguousarray(q2, np.uint8)
        o2 = np.ascontiguousarray(o2, np.int16)
        starts = np.ascontiguousarray(starts, np.int32)
        if starts.ndim == 1:
            starts = starts[:, None]
        nb, blk, k1 = q1.shape
        k2 = q2.shape[2]
        rc = self._lib.lis_stream_feed_split(
            ctypes.c_void_p(self._ctx),
            q1.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            o1.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            q2.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            o2.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_longlong(nb), ctypes.c_longlong(blk),
            ctypes.c_longlong(k1), ctypes.c_longlong(k2),
            ctypes.c_longlong(starts.shape[1]),
            ctypes.c_longlong(int(a_base)))
        if rc != 0:
            raise RuntimeError("lis_stream_feed_split failed")

    def finish(self):
        import ctypes
        cap = int(self._lib.lis_stream_count(ctypes.c_void_p(self._ctx))) + 1
        out_v = np.empty(cap, np.int64)
        out_a = np.empty(cap, np.int64)
        out_len = ctypes.c_longlong(0)
        rc = self._lib.lis_stream_finish(
            ctypes.c_void_p(self._ctx),
            out_v.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            out_a.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            ctypes.byref(out_len))
        if rc != 0:
            raise RuntimeError("lis_stream_finish failed")
        m = out_len.value
        return out_v[:m].copy(), out_a[:m].copy()

    def close(self):
        import ctypes
        if getattr(self, '_ctx', None):
            self._lib.lis_stream_free(ctypes.c_void_p(self._ctx))
            self._ctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def candidates_from_match_output(quals, vids, block=210):
    """Flatten device matcher output to sorted candidate arrays.

    quals, vids: (B, block, K) arrays; qual == 0 marks empty slots.
    Returns (audio_idx, video_idx, qual) sorted by (audio, video, qual).
    """
    quals = np.asarray(quals)
    vids = np.asarray(vids)
    nb, blk, k = quals.shape
    audio = (np.arange(nb * blk).repeat(k)).reshape(nb, blk, k)
    keep = quals > 0
    a = audio[keep].astype(np.int64)
    v = vids[keep].astype(np.int64)
    q = quals[keep].astype(np.float64)
    order = np.lexsort((q, v, a))
    return a[order], v[order], q[order]
