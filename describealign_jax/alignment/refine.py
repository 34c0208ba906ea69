"""Pass-2 refinement: colinear clustering, per-line refit, cluster-switch DP.

Reference semantics (describealign.py:860-993):
1. Group smooth-path points into colinear clusters keyed by
   (round(slope, 6), round(offset)); merge clusters whose endpoints lie
   within 3 frames of an existing cluster's line; keep clusters spanning
   >10 frames with >5 points.
2. Least-squares refit each cluster's line; apply a sub-frame offset
   correction estimated from the feature time-derivative when it exceeds
   8 sigma of noise.
3. Score every audio frame in each cluster's (+/-30 s extended) range
   against the video features interpolated along the line; build per-frame
   candidate points.
4. A second DP chooses among cluster lines with switch penalties
   (-1000 global jump / -50 within-cluster / -100-100*d^2 local) to produce
   the final path.

The dense scoring in step 3 is vectorized numpy (it can move to JAX);
the cluster bookkeeping and DP are host-side (native C++ planned), as the
data structures are inherently irregular.
"""
import ctypes
from collections import defaultdict

import numpy as np

from .lis import KeyedList
from .native import native_lib

EXTEND_RADIUS = 210 * 30


def _round6(arr):
    """Per-element Python round(v, 6) semantics (correctly-rounded decimal,
    half-to-even on decimal ties - np.round's scale-and-round can differ on
    ties, drifting cluster keys). The native twin formats+parses via glibc's
    correctly-rounded %.6f/strtod; the fallback is the Python builtin."""
    lib = native_lib()
    if lib is not None and hasattr(lib, 'round_decimals6_f64'):
        arr = np.ascontiguousarray(arr, np.float64)
        out = np.empty_like(arr)
        if lib.round_decimals6_f64(
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                ctypes.c_longlong(arr.size),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))) == 0:
            return out.tolist()
    return [round(v, 6) for v in arr.tolist()]


def build_line_clusters(smooth_path, slopes):
    """Steps 1-2a: colinear clustering + merge (reference 860-893)."""
    slopes_plus_ends = np.hstack((slopes[:1], slopes, slopes[-1:]))
    px_arr = np.asarray([p[0] for p in smooth_path], float)
    py_arr = np.asarray([p[1] for p in smooth_path], float)
    n = len(px_arr)
    # both candidate lines per point, keys rounded vectorized (the python
    # round() per point dominated this stage at media scale); append order
    # stays point-major like the reference (merge tests read endpoints)
    ks = []
    for s_arr in (slopes_plus_ends[:n], slopes_plus_ends[1:n + 1]):
        # int(round(v, 0)) == np.rint: ndigits=0 midpoints (x.5) are dyadic,
        # so binary half-to-even IS decimal half-to-even - no decimal-
        # correctness caveat like the slope key's round(v, 6)
        ks.append((_round6(s_arr),
                   np.rint(py_arr - s_arr * px_arr).astype(
                       np.int64).tolist(),
                   ((s_arr >= .1) & (s_arr <= 10)).tolist()))
    colinear = defaultdict(list)
    pts = list(zip(px_arr.tolist(), py_arr.tolist()))
    for i in range(n):
        for keys_s, keys_o, ok in ks:
            if ok[i]:
                colinear[(keys_s[i], keys_o[i])].append(pts[i])

    line_clusters = []
    added = set()
    for (slope, offset), pts in sorted(colinear.items(),
                                       key=lambda kv: -len(kv[1])):
        if (slope, offset) in added:
            continue
        line_clusters.append(pts)
        added.add((slope, offset))
        del colinear[(slope, offset)]
        for (slope2, offset2), pts2 in list(colinear.items()):
            if (abs(pts2[0][1] - (pts2[0][0] * slope + offset)) < 3
                    and abs(pts2[-1][1] - (pts2[-1][0] * slope + offset)) < 3):
                line_clusters[-1].extend(colinear[(slope2, offset2)])
                added.add((slope2, offset2))
                del colinear[(slope2, offset2)]
    line_clusters = [sorted(c) for c in line_clusters]
    line_clusters = [c for c in line_clusters
                     if (abs(c[0][0] - c[-1][0]) > 10) and len(c) > 5]

    refit = []
    for cluster in line_clusters:
        cx, cy = np.array(cluster).T
        design = np.hstack((np.ones((len(cx), 1)), cx[:, None]))
        coef = np.linalg.lstsq(design, cy, rcond=None)[0]
        refit.append((cx, coef[0], coef[1]))  # (x points, offset, slope)
    return refit


def _interp_video(video_scaled, yq):
    """Linear interpolation of (Nv, 3) features at fractional rows yq."""
    yq = np.asarray(yq)
    lo = np.floor(yq).astype(np.int64)
    lo = np.clip(lo, 0, len(video_scaled) - 2)
    frac = (yq - lo)[:, None]
    return video_scaled[lo] * (1 - frac) + video_scaled[lo + 1] * frac


def build_points(line_clusters, audio_scaled, video_scaled):
    """Steps 2b-3: offset correction + dense scoring (reference 895-944).

    Returns points[i] = sorted list of (video_pos, cluster_index, qual) per
    audio frame i.
    """
    na = len(audio_scaled)
    nv = len(video_scaled)
    audio_max_energy = np.max(audio_scaled[:, 0])
    video_max_energy = np.max(video_scaled[:, 0])

    def get_x_limits(cx, offset, slope, extend_horiz=EXTEND_RADIUS,
                     buffer_vert=4):
        limits = (max(int(cx[0]) - extend_horiz, 0),
                  min(int(cx[-1]) + extend_horiz, na - 1))
        limits = (max(limits[0], int(np.ceil((buffer_vert - offset) / slope))),
                  min(limits[1],
                      int(np.floor((nv - buffer_vert - offset) / slope))))
        return limits

    def get_matches(limits, slope, offset):
        xs = np.arange(*limits)
        ys = slope * xs + offset
        return xs, ys, audio_scaled[slice(*limits)], _interp_video(video_scaled, ys)

    points = [[] for _ in range(na)]
    seen = set()
    for cluster_index, (cx, offset, slope) in enumerate(line_clusters):
        limits = get_x_limits(cx, offset, slope, extend_horiz=0)
        if limits[1] < limits[0] + 5:
            continue
        if limits[1] > limits[0] + 100:
            # sub-frame offset correction via the feature time-derivative
            xs, ys, audio_match, video_match = get_matches(limits, slope, offset)
            err = audio_match[1:-1] - video_match[1:-1]
            valid = np.mean(err, axis=-1) < 0.1
            if np.count_nonzero(valid) > 50:
                vdiff = (video_match[2:] - video_match[:-2]) / 2.
                err_v = err[valid]
                vdiff_v = vdiff[valid]
                design = vdiff_v.reshape(-1, 1)
                lin_fit, residual, _, _ = np.linalg.lstsq(
                    design, err_v.flatten(), rcond=None)
                if residual.size:
                    explained = 1 - (residual / np.sum(err_v ** 2))
                    stds_above = np.sqrt(explained * np.prod(err_v.shape)) - 1.
                    if stds_above > 8 and abs(lin_fit[0]) < 2:
                        offset += lin_fit[0]
        limits = get_x_limits(cx, offset, slope)
        xs, ys, audio_match, video_match = get_matches(limits, slope, offset)
        quals = np.sum(-.5 - np.log10(1e-4 + np.abs(audio_match - video_match)),
                       axis=1)
        quals *= np.clip(video_match[:, 0] + 2.5 - video_max_energy, 0, 1)
        quals += np.clip(audio_match[:, 0] + 2.5 - audio_max_energy, 0, 1) * .1
        for i, j, qual in zip(xs.tolist(), ys.tolist(), quals.tolist()):
            point = (i, int(j))
            if point not in seen:
                seen.add(point)
                points[i].append((j, cluster_index, qual))
    return [sorted(p) for p in points]


def _native_refine_lib(audio_scaled, video_scaled):
    """The native scorer handles the production dtype/layout (f32, C
    contiguous); anything else takes the numpy path."""
    import os
    if os.environ.get('DESCRIBEALIGN_NO_NATIVE_SCORER'):
        return None
    from .native import native_lib
    lib = native_lib()
    if (lib is None or not hasattr(lib, 'refine_score_cluster')
            or audio_scaled.dtype != np.float32
            or video_scaled.dtype != np.float32
            or not audio_scaled.flags.c_contiguous
            or not video_scaled.flags.c_contiguous):
        return None
    return lib


def _score_cluster_native(lib, limits, slope, offset, audio_scaled,
                          video_scaled, amax, vmax):
    import ctypes
    n = limits[1] - limits[0]
    quals = np.empty(n, np.float64)
    rc = lib.refine_score_cluster(
        audio_scaled.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_longlong(len(audio_scaled)),
        video_scaled.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_longlong(len(video_scaled)),
        ctypes.c_double(slope), ctypes.c_double(offset),
        ctypes.c_longlong(limits[0]), ctypes.c_longlong(limits[1]),
        ctypes.c_double(amax), ctypes.c_double(vmax),
        quals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return quals if rc == 0 else None


def build_points_flat(line_clusters, audio_scaled, video_scaled):
    """Vectorized build_points producing flat arrays for the native DP.

    Returns (pj, pc, pq, offsets): per-frame candidate points sorted by
    (audio frame, video pos, cluster, qual) with offsets[i]..offsets[i+1]
    indexing frame i's points. Semantics identical to build_points
    (first-processed cluster wins duplicate (frame, int(video)) points).
    The dense per-cluster scoring runs in C++ when available (same math,
    ~1e-13 relative from the fused log10; see dp.cpp refine_score_cluster)
    - it was the largest single numpy stage left on the host tail.
    """
    na = len(audio_scaled)
    nv = len(video_scaled)
    audio_max_energy = np.max(audio_scaled[:, 0])
    video_max_energy = np.max(video_scaled[:, 0])
    lib = _native_refine_lib(audio_scaled, video_scaled)

    all_i, all_j, all_c, all_q = [], [], [], []
    for cluster_index, (cx, offset, slope) in enumerate(line_clusters):
        limits = _cluster_limits(cx, offset, slope, na, nv, extend_horiz=0)
        if limits[1] < limits[0] + 5:
            continue
        if limits[1] > limits[0] + 100:
            offset = _offset_correction(limits, slope, offset,
                                        audio_scaled, video_scaled, lib)
        limits = _cluster_limits(cx, offset, slope, na, nv)
        xs = np.arange(*limits)
        ys = slope * xs + offset
        quals = None
        if lib is not None:
            quals = _score_cluster_native(
                lib, limits, slope, offset, audio_scaled, video_scaled,
                float(audio_max_energy), float(video_max_energy))
        if quals is None:
            audio_match = audio_scaled[slice(*limits)]
            video_match = _interp_video(video_scaled, ys)
            quals = np.sum(
                -.5 - np.log10(1e-4 + np.abs(audio_match - video_match)),
                axis=1)
            quals *= np.clip(video_match[:, 0] + 2.5 - video_max_energy,
                             0, 1)
            quals += np.clip(audio_match[:, 0] + 2.5 - audio_max_energy,
                             0, 1) * .1
        all_i.append(xs)
        all_j.append(ys)
        all_c.append(np.full(len(xs), cluster_index, np.int64))
        all_q.append(quals)
    if not all_i:
        return (np.empty(0), np.empty(0, np.int64), np.empty(0),
                np.zeros(na + 1, np.int64))
    pi = np.concatenate(all_i).astype(np.int64)
    pj = np.concatenate(all_j)
    pc = np.concatenate(all_c)
    pq = np.concatenate(all_q)
    # ONE stable sort on the composite (frame, int(video)) key both dedupes
    # (keep the first occurrence in cluster processing order = smallest
    # original index, which stable sort puts first in each equal-key run)
    # and yields the final (frame, video, cluster, qual) order: after the
    # dedupe each frame has unique int(video), so ordering by the key IS
    # ordering by fractional video position too.
    keys = pi * np.int64(nv + 2) + pj.astype(np.int64)
    order = np.argsort(keys, kind='stable')
    keys = keys[order]
    first = np.ones(len(keys), bool)
    first[1:] = keys[1:] != keys[:-1]
    sel = order[first]
    pi, pj, pc, pq = pi[sel], pj[sel], pc[sel], pq[sel]
    offsets = np.zeros(na + 1, np.int64)
    np.cumsum(np.bincount(pi, minlength=na), out=offsets[1:])
    return pj, pc, pq, offsets


def _cluster_limits(cx, offset, slope, na, nv, extend_horiz=EXTEND_RADIUS,
                    buffer_vert=4):
    limits = (max(int(cx[0]) - extend_horiz, 0),
              min(int(cx[-1]) + extend_horiz, na - 1))
    return (max(limits[0], int(np.ceil((buffer_vert - offset) / slope))),
            min(limits[1],
                int(np.floor((nv - buffer_vert - offset) / slope))))


def _offset_correction(limits, slope, offset, audio_scaled, video_scaled,
                       lib=None):
    """Sub-frame offset correction via the feature time-derivative
    (reference 916-930); returns the possibly-adjusted offset.

    With the native library, the interp + masked single-column lstsq
    reduce to one C++ pass over the window (refine_offset_stats) and the
    acceptance rule is applied here from its sufficient statistics - for a
    rank-1 design, lstsq's solution and residual are num/den and
    sq - num^2/den."""
    import ctypes
    if lib is not None:
        valid = ctypes.c_longlong(0)
        num = ctypes.c_double(0.0)
        den = ctypes.c_double(0.0)
        sq = ctypes.c_double(0.0)
        rc = lib.refine_offset_stats(
            audio_scaled.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_longlong(len(audio_scaled)),
            video_scaled.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_longlong(len(video_scaled)),
            ctypes.c_double(slope), ctypes.c_double(offset),
            ctypes.c_longlong(limits[0]), ctypes.c_longlong(limits[1]),
            ctypes.byref(valid), ctypes.byref(num), ctypes.byref(den),
            ctypes.byref(sq))
        if rc == 0:
            if valid.value > 50 and den.value > 0 and sq.value > 0:
                lin_fit = num.value / den.value
                residual = sq.value - num.value * num.value / den.value
                explained = 1.0 - residual / sq.value
                stds_above = np.sqrt(max(explained, 0.0)
                                     * (3.0 * valid.value)) - 1.0
                if stds_above > 8 and abs(lin_fit) < 2:
                    return offset + lin_fit
            return offset
    xs = np.arange(*limits)
    ys = slope * xs + offset
    audio_match = audio_scaled[slice(*limits)]
    video_match = _interp_video(video_scaled, ys)
    err = audio_match[1:-1] - video_match[1:-1]
    valid = np.mean(err, axis=-1) < 0.1
    if np.count_nonzero(valid) > 50:
        vdiff = (video_match[2:] - video_match[:-2]) / 2.
        err_v = err[valid]
        vdiff_v = vdiff[valid]
        design = vdiff_v.reshape(-1, 1)
        lin_fit, residual, _, _ = np.linalg.lstsq(design, err_v.flatten(),
                                                  rcond=None)
        if residual.size:
            explained = 1 - (residual / np.sum(err_v ** 2))
            stds_above = np.sqrt(explained * np.prod(err_v.shape)) - 1.
            if stds_above > 8 and abs(lin_fit[0]) < 2:
                return offset + lin_fit[0]
    return offset


def refine_dp_py(points, num_clusters, num_video):
    """Step 4: the cluster-switch DP (reference 946-983), Python version.

    Returns the path as an (M, 5) float array of
    (video, audio, cluster_index, qual, cum_qual) rows.
    """
    import itertools
    best = KeyedList()
    best.add((0, 0, -1, 0, 0))
    clusters_best = [(0, 0, 0, -1000)] * num_clusters
    backptr = {}
    prev_cache = np.full((num_video, 5), -np.inf)
    prev_cache[0] = (0, 0, -1, 0, 0)
    rev_min = [min(p)[0] if len(p) > 0 else np.inf for p in points[::-1]]
    forward_min = list(itertools.accumulate(rev_min, min))[::-1]

    for i in range(len(points)):
        for j, cluster_index, qual in points[i]:
            cur = best.bisect_right(j)
            prev_j, prev_i, prev_cluster, prev_qual, best_cum = best[cur - 1]
            cluster_last = clusters_best[cluster_index]
            if cluster_last[3] >= best_cum:
                prev_j, prev_i, prev_qual, best_cum = cluster_last
                prev_cluster = cluster_index
            for pj in range(max(0, int(j) - 2), int(j) + 1):
                node = prev_cache[pj].tolist()
                if node[4] == -np.inf:
                    continue        # never set (the C++ twin's `set` flag)
                if cluster_index != node[2]:
                    node[4] -= 100 + 100 * ((j - node[0]) - (i - node[1])) ** 2
                if node[1] >= (i - 2) and node[0] <= j and node[4] >= best_cum:
                    prev_j, prev_i, prev_cluster, prev_qual, best_cum = node
            cum = best_cum + qual
            prev_cache[int(j)] = (j, i, cluster_index, qual, cum)
            cum_jump = cum - 1000
            if best[cur - 1][4] < cum_jump:
                while cur < len(best) and best[cur][4] <= cum_jump:
                    del best[cur]
                best.add((j, i, cluster_index, qual, cum_jump))
            if forward_min[i] == j and cur > 1:
                del best[:cur - 1]
            cum_cluster = cum - 50
            if cluster_last[3] < cum_cluster:
                clusters_best[cluster_index] = (j, i, qual, cum_cluster)
            backptr[(j, i)] = (prev_j, prev_i, prev_cluster, prev_qual, best_cum)

    path = [tuple(best[-1])]
    while path[-1][:2] in backptr:
        path.append(backptr[path[-1][:2]])
    path.pop()
    path.reverse()
    return np.array(path, dtype=np.float64)


def refine_dp(points, num_clusters, num_video):
    """Dispatch to the native DP when available (falls back to Python)."""
    from .refine_native import refine_dp_native_available, refine_dp_native
    if refine_dp_native_available():
        return refine_dp_native(points, num_clusters, num_video)
    return refine_dp_py(points, num_clusters, num_video)
