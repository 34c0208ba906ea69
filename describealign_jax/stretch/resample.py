"""Pitch-shifting resampler (JAX).

Replaces the reference's chunked scipy quadratic-spline interpolator
(describealign.py:233-244): evaluates the description waveform at uniformly
spaced fractional sample positions, changing pitch with rate. Used when the
pitch shift is imperceptible (<=0.5%), the offset is tiny (<30 samples), or
--no_pitch_correction is set.

Device design: ONE device dispatch per segment - a single gather + local
3-point quadratic Lagrange weighting over the whole (bucketed) output.
The reference's global quadratic spline and local Lagrange interpolation
differ by sub-quantization amounts on band-limited audio; stretch-mode
parity is perceptual (SURVEY.md section 7 step 6).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import AUDIO_SAMPLE_RATE

MIN_BUCKET = AUDIO_SAMPLE_RATE * 2  # segments are >= 2 s by the rules


def _bucket(n):
    b = MIN_BUCKET
    while b < n:
        b *= 2
    return b


@jax.jit
def _resample_full(seg, start_frac, step, n_out):
    """Evaluate seg at start_frac + step*arange(OUT_pad); OUT_pad static."""
    out_pad = seg.shape[1]  # seg padded to the output bucket too
    pos = start_frac + step * jnp.arange(out_pad, dtype=jnp.float32)
    base = jnp.clip(jnp.round(pos).astype(jnp.int32), 1, seg.shape[1] - 2)
    t = pos - base.astype(jnp.float32)              # in [-.5, .5]
    w_m1 = 0.5 * t * (t - 1.0)
    w_0 = (1.0 - t) * (1.0 + t)
    w_p1 = 0.5 * t * (t + 1.0)
    live = jnp.arange(out_pad) < n_out
    out = (w_m1 * seg[:, base - 1] + w_0 * seg[:, base]
           + w_p1 * seg[:, base + 1])
    return out * live[None, :]


def _resample_host(audio_arr, x_start, x_end, num_out):
    """Host twin of _resample_full: same 3-point quadratic Lagrange
    weighting, with float64 sample positions (like the reference's
    linspace, describealign.py:412 - f32 positions lose whole samples
    past ~16.7M on multi-minute segments). Production path is the native
    single-pass kernel (features.cpp::resample_quad, bit-equal - tested);
    the numpy twin below is the fallback and the equality oracle."""
    import ctypes

    from ..alignment.native import native_lib

    a = np.ascontiguousarray(audio_arr, np.float32)
    lib = native_lib()
    if lib is not None and hasattr(lib, 'resample_quad'):
        out = np.empty((a.shape[0], num_out), np.float32)
        fp = ctypes.POINTER(ctypes.c_float)
        rc = lib.resample_quad(
            a.ctypes.data_as(fp), ctypes.c_int64(a.shape[0]),
            ctypes.c_int64(a.shape[1]), ctypes.c_double(float(x_start)),
            ctypes.c_double(float(x_end)), ctypes.c_int64(int(num_out)),
            out.ctypes.data_as(fp))
        if rc == 0:
            return out
    pos = x_start + (x_end - x_start) / num_out * np.arange(num_out)
    base = np.clip(np.round(pos).astype(np.int64), 1,
                   audio_arr.shape[1] - 2)
    t = (pos - base).astype(np.float32)[None, :]
    w_m1 = 0.5 * t * (t - 1.0)
    w_0 = (1.0 - t) * (1.0 + t)
    w_p1 = 0.5 * t * (t + 1.0)
    out = (w_m1 * a[:, base - 1] + w_0 * a[:, base]
           + w_p1 * a[:, base + 1])
    return out.astype(np.float16).astype(np.float32)


def _resample_backend():
    import os
    return os.environ.get('DESCRIBEALIGN_RESAMPLE', 'host')


def resample_segment(audio_arr, x_start, x_end, num_out):
    """Stretch audio_arr[:, x_start:x_end] to num_out samples.

    Mirrors the reference's sample_points = linspace(x_start, x_end,
    num_out, endpoint=False) evaluation (describealign.py:412-414).
    Returns (C, num_out) float32 on the f16 grid (like the reference's f16
    write-back). Host numpy by default (the device path pays two
    PCM-sized transfers per segment; scripts/bench_stretch.py compares
    them); DESCRIBEALIGN_RESAMPLE=device runs the bucketed one-dispatch
    JAX kernel.
    """
    audio_arr = np.asarray(audio_arr)
    if _resample_backend() != 'device':
        return _resample_host(audio_arr, x_start, x_end, num_out)
    c = audio_arr.shape[0]
    step = (x_end - x_start) / num_out
    in0 = max(int(np.floor(x_start)) - 4, 0)
    n_in = int(np.ceil(x_end - in0)) + 8
    pad = _bucket(max(n_in, num_out))
    seg = np.zeros((c, pad), np.float32)
    lo = in0
    hi = min(in0 + pad, audio_arr.shape[1])
    if hi > lo:
        seg[:, :hi - lo] = audio_arr[:, lo:hi]
    out = _resample_full(jnp.asarray(seg), jnp.float32(x_start - in0),
                         jnp.float32(step), jnp.int32(num_out))
    return (np.asarray(out)[:, :num_out]
            .astype(np.float16).astype(np.float32))
