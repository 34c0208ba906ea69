"""Continuity filtering and path compression (host, vectorized numpy).

Reference semantics:
- get_continuity_err (describealign.py:702-724): forward/backward
  half-hann-smoothed local linear fits; a point's continuity error is its
  distance to the better of the two local lines.
- pass-1 filter (726-731): drop match points with continuity error >= 3.
- compression (743-767): runs of 70 well-fit points collapse to their mean;
  duplicate audio indices are deduped by averaging their video indices.

These run on the compressed match path (thousands of points) - host numpy
is the right tool; there is nothing here for the device.
"""
import ctypes

import numpy as np

from ..ops.windows import hann_window
from .native import native_lib
from .preprocess import SAMPLES_PER_NODE

_HALF = SAMPLES_PER_NODE // 2          # 10
_FIT_DELAY = SAMPLES_PER_NODE + _HALF - 2  # 29


def _conv(x, taps, mode):
    """np.convolve(x, taps, mode) for f64 data via the native tap-major
    kernel (~4x numpy's scalar correlate loop on media-length paths);
    numpy fallback when the library is unavailable."""
    lib = native_lib()
    # np.convolve swaps its arguments so the longer array is the signal;
    # the native kernel does not, and would compute a negative 'valid'
    # length (or a too-short 'same') for sub-taps-length inputs
    if lib is not None and hasattr(lib, 'conv_f64') and len(x) >= len(taps):
        x = np.ascontiguousarray(x, np.float64)
        taps = np.ascontiguousarray(taps, np.float64)
        same = 1 if mode == 'same' else 0
        out = np.empty(len(x) if same else len(x) - len(taps) + 1)
        if len(out) > 0 and lib.conv_f64(
                x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                ctypes.c_longlong(len(x)),
                taps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                ctypes.c_longlong(len(taps)), ctypes.c_int(same),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))) == 0:
            return out
    return np.convolve(x, taps, mode=mode)


def _half_hann_taps():
    w = hann_window(2 * SAMPLES_PER_NODE + 1)[1:-1]
    w = w / np.sum(w)
    half = w[:SAMPLES_PER_NODE - 1]
    return half / np.sum(half)


def get_continuity_err(x, y, deriv=False):
    """Distance of each point to its local (past or future) linear fit."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    taps = _half_hann_taps()

    def diff_by(arr, offset=_HALF):
        return arr[offset:] - arr[:-offset]

    x_fut = _conv(x, taps, 'valid')
    y_fut = _conv(y, taps, 'valid')
    slopes_fut = diff_by(y_fut) / diff_by(x_fut)
    offsets_fut = y_fut[:-_HALF] - x_fut[:-_HALF] * slopes_fut

    x_past = _conv(x, taps[::-1], 'valid')
    y_past = _conv(y, taps[::-1], 'valid')
    slopes_past = diff_by(y_past) / diff_by(x_past)
    offsets_past = y_past[_HALF:] - x_past[_HALF:] * slopes_past

    err = np.full(len(x) - (1 if deriv else 0), np.inf)
    fd = _FIT_DELAY - (1 if deriv else 0)
    err[:-fd] = np.abs(slopes_fut * x[:-_FIT_DELAY]
                       + offsets_fut - y[:-_FIT_DELAY])
    err[fd:] = np.minimum(err[fd:],
                          np.abs(slopes_past * x[_FIT_DELAY:]
                                 + offsets_past - y[_FIT_DELAY:]))
    return err


def continuity_filter(x, y, threshold=3.0):
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    lib = native_lib()
    if (lib is not None and hasattr(lib, 'continuity_filter_f64')
            and x.flags.c_contiguous and y.flags.c_contiguous
            and len(x) == len(y)):
        # one fused native pass (4 convs + err + compaction); bit-equal to
        # the numpy chain below (same conv kernel, same expression order)
        taps = np.ascontiguousarray(_half_hann_taps(), np.float64)
        out_x = np.empty_like(x)
        out_y = np.empty_like(y)
        out_n = ctypes.c_longlong(0)
        rc = lib.continuity_filter_f64(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_longlong(len(x)),
            taps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_longlong(len(taps)), ctypes.c_longlong(_HALF),
            ctypes.c_double(threshold),
            out_x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            out_y.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.byref(out_n))
        if rc == 0:
            m = out_n.value
            return out_x[:m].copy(), out_y[:m].copy()
    keep = get_continuity_err(x, y) < threshold
    return x[keep], y[keep]


def _smooth_mean(arr):
    """41-tap hann local mean (reference get_mean, 596-599)."""
    w = hann_window(2 * SAMPLES_PER_NODE + 1)[1:-1]
    w = w / np.sum(w)
    # np.convolve is commutative and 'same' keeps the longer length, so
    # (arr, w) ordering matches the reference's (w, arr) call exactly
    return _conv(np.asarray(arr, np.float64), w, 'same')[:len(arr)]


def compress_path(x, y, run=70, err_threshold=3.0):
    """Collapse well-fit runs to their means; dedupe repeated audio indices.

    Returns (x_nodes f64, y_nodes f64) with strictly increasing x.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    smooth_x = _smooth_mean(x)
    smooth_y = _smooth_mean(y)
    slopes = np.diff(smooth_y) / np.diff(smooth_x)
    offsets = smooth_y[:-1] - smooth_x[:-1] * slopes
    err_y = slopes * x[:-1] + offsets - y[:-1]

    # run flags and means are vectorized (the original per-element Python
    # list building dominated the host tail at media scale); the element
    # sequence matches the reference loop exactly, including its tail
    # handling when the loop body is empty
    starts = np.arange(10, max(len(x) - run - 10, 10), run)
    if len(starts):
        ok = np.abs(err_y) < err_threshold
        csum = np.concatenate([[0], np.cumsum(ok)])
        flags = (csum[starts + run] - csum[starts]) == run
        fstarts = starts[flags]
        if len(fstarts):
            idx = fstarts[:, None] + np.arange(run)[None, :]
            mean_x = np.mean(x[idx], axis=1)   # row-wise == per-slice mean
            mean_y = np.mean(y[idx], axis=1)
        last = starts[-1]
        # assemble into preallocated outputs (the per-run list-of-pieces +
        # concatenate paid ~2 us per piece across ~5k runs); flagged runs
        # write one mean, and only the usually-rare unflagged runs loop
        pos = np.empty(len(starts) + 1, np.int64)
        pos[0] = 10
        np.cumsum(np.where(flags, 1, run), out=pos[1:])
        pos[1:] += 10
        tail_n = len(x[last + run:last + 2 * run])
        cx = np.empty(pos[-1] + tail_n)
        cy = np.empty_like(cx)
        cx[:10] = x[:10]
        cy[:10] = y[:10]
        fpos = pos[:-1][flags]
        if len(fstarts):
            cx[fpos] = mean_x
            cy[fpos] = mean_y
        for k in np.flatnonzero(~flags):
            p, s = pos[k], starts[k]
            cx[p:p + run] = x[s:s + run]
            cy[p:p + run] = y[s:s + run]
        cx[pos[-1]:] = x[last + run:last + 2 * run]
        cy[pos[-1]:] = y[last + run:last + 2 * run]
    else:
        last = 10 - run
        cx = np.concatenate([x[:10], x[last + run:last + 2 * run]])
        cy = np.concatenate([y[:10], y[last + run:last + 2 * run]])
    # dedupe: average video indices of equal audio indices, preserving the
    # first-occurrence order (reference 760-767)
    if len(cx) > 1 and np.all(np.diff(cx) >= 0):
        # cx is non-decreasing by construction (the LIS path's audio
        # frames are, and each run's mean stays within the run's range),
        # so equal values sit in contiguous groups: segmented sums replace
        # np.unique's sort + the notoriously slow np.add.at. reduceat's
        # SIMD inner loop may accumulate a multi-element group in a
        # different order than a scalar loop (~1 ulp, ~1e-13 on real
        # sums); immaterial downstream - fit tolerances are ms-scale and
        # the pass-2 round(slope, 6) keys have 1e-6 spacing. The general
        # branch below stays as the fallback for the theoretical
        # non-monotone case (never taken on LIS output).
        starts_g = np.concatenate(
            [[0], np.flatnonzero(np.diff(cx) != 0) + 1])
        sums = np.add.reduceat(cy, starts_g)
        counts = np.diff(np.concatenate([starts_g, [len(cx)]]))
        return cx[starts_g], sums / counts
    x_unique, first_idx, inverse = np.unique(cx, return_index=True,
                                             return_inverse=True)
    sums = np.zeros(len(x_unique))
    counts = np.zeros(len(x_unique))
    np.add.at(sums, inverse, cy)
    np.add.at(counts, inverse, 1)
    means = sums / counts
    order = np.argsort(first_idx)
    # reference iterates in encounter order; x is monotone enough in practice
    # that encounter order == sorted order, but we preserve it exactly
    return x_unique[order], means[order]
