"""Pitch-preserving time stretch: phase vocoder (JAX, batched FFT).

A data-parallel alternative to the reference's WSOLA-style DP splicer
(describealign.py:296-387): instead of searching jump points with Pearson
correlations and splicing with crossfades (irregular, sequential), we STFT
the segment, advance phases with the classic phase-vocoder recurrence plus
identity phase locking (Laroche & Dolson style), and overlap-add the iSTFT.
Rates are within +/-10% (segment rule), where PV quality is high.

Device design: ONE device dispatch per segment - all analysis windows
gather as a single batched rfft, phase propagation is a lax.scan over
frames of (513,) vectors, synthesis is a scatter-add overlap-add. Segment
lengths are bucketed (geometric, x2) so a handful of compiled shapes serve
any media; per-dispatch latency amortizes over the whole segment.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import AUDIO_SAMPLE_RATE
from ..ops.windows import hann_window

N_FFT = 1024
HOP_SYN = 256
_BINS = N_FFT // 2 + 1
_WINDOW = hann_window(N_FFT).astype(np.float32)
MIN_BUCKET = AUDIO_SAMPLE_RATE * 2  # segments are >= 2 s by the rules


def _bucket(n):
    b = MIN_BUCKET
    while b < n:
        b *= 2
    return b


@partial(jax.jit, static_argnames=('num_frames',))
def _pv_segment(seg, rate, n_out, num_frames):
    """seg: (C, S_pad) f32; rate: input samples per output sample;
    n_out: true output length; num_frames: static frame count covering the
    padded output. Returns (C, OUT_pad = num_frames*HOP_SYN + N_FFT)."""
    window = jnp.asarray(_WINDOW)
    k = jnp.arange(num_frames)
    t_a = k.astype(jnp.float32) * (HOP_SYN * rate)
    pos = jnp.clip(jnp.round(t_a).astype(jnp.int32), 0,
                   seg.shape[1] - N_FFT - 1)
    # zero analysis frames beyond the needed output (they stay silent)
    frame_live = (k * HOP_SYN) < n_out

    idx = pos[:, None] + jnp.arange(N_FFT)[None, :]       # (F, N_FFT)
    frames = seg[:, idx] * window[None, None, :]          # (C, F, N_FFT)
    spec = jnp.fft.rfft(frames, axis=2)                   # (C, F, BINS)

    omega = (2 * np.pi * np.arange(_BINS) * HOP_SYN / N_FFT).astype(np.float32)
    omega = jnp.asarray(omega)

    def propagate(spec_c):
        mag = jnp.abs(spec_c)
        phase = jnp.angle(spec_c)

        def step(carry, inp):
            prev_phase_a, prev_phase_s = carry
            phase_a, mag_k = inp
            dphi = phase_a - prev_phase_a - omega * rate
            dphi = dphi - 2 * np.pi * jnp.round(dphi / (2 * np.pi))
            inst = omega * rate + dphi                    # per analysis hop
            phase_s = prev_phase_s + inst / rate          # per synthesis hop
            # identity phase locking: slave bins inherit their dominant
            # neighbor's rotation (reduces phasiness on speech)
            rot = phase_s - phase_a
            left = jnp.roll(mag_k, 1).at[0].set(0)
            right = jnp.roll(mag_k, -1).at[-1].set(0)
            dom_rot = jnp.where(left > jnp.maximum(mag_k, right),
                                jnp.roll(rot, 1),
                                jnp.where(right > mag_k, jnp.roll(rot, -1),
                                          rot))
            phase_locked = phase_a + dom_rot
            return (phase_a, phase_locked), phase_locked

        init = (phase[0], phase[0])
        _, phases = jax.lax.scan(step, init, (phase[1:], mag[1:]))
        phases = jnp.concatenate([phase[:1], phases], axis=0)
        return mag * jnp.exp(1j * phases)

    spec_out = jax.vmap(propagate)(spec)
    frames_out = (jnp.fft.irfft(spec_out, n=N_FFT, axis=2)
                  * window[None, None, :]
                  * frame_live[None, :, None])

    out_len = num_frames * HOP_SYN + N_FFT
    out_pos = (k * HOP_SYN)[:, None] + jnp.arange(N_FFT)[None, :]

    def ola(frames_c):
        buf = jnp.zeros((out_len,), jnp.float32)
        return buf.at[out_pos.reshape(-1)].add(frames_c.reshape(-1))

    out = jax.vmap(ola)(frames_out)
    wsum = jnp.zeros((out_len,), jnp.float32).at[out_pos.reshape(-1)].add(
        jnp.tile(jnp.asarray(_WINDOW) ** 2, (num_frames,)))
    return out / jnp.maximum(wsum, 1e-3)


def _phase_lock(phase_a, mag, inst_over_rate, init_locked=None):
    """Locked synthesis phases (native C++; numpy fallback). The frame
    recurrence is sequential because the locked phase is the carry.

    init_locked=None: whole-segment semantics (frame 0's phases pass
    through; inst_over_rate is (C, F-1, BINS)). With init_locked (C, BINS):
    chunked semantics - every frame runs the recurrence seeded by the
    previous block's last locked phases, and inst_over_rate[k] is the
    increment from frame k-1 (shape (C, F, BINS))."""
    import ctypes

    from ..alignment.native import native_lib

    def f32p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    c, f, bins = phase_a.shape
    lib = native_lib()
    if lib is not None and hasattr(lib, 'pv_phase_lock_carry'):
        phases = np.empty_like(phase_a)
        if init_locked is None:
            rc = lib.pv_phase_lock(
                f32p(phase_a), f32p(mag), f32p(inst_over_rate),
                ctypes.c_int64(c), ctypes.c_int64(f), ctypes.c_int64(bins),
                f32p(phases))
        else:
            init_locked = np.ascontiguousarray(init_locked, np.float32)
            rc = lib.pv_phase_lock_carry(
                f32p(phase_a), f32p(mag), f32p(inst_over_rate),
                f32p(init_locked),
                ctypes.c_int64(c), ctypes.c_int64(f), ctypes.c_int64(bins),
                f32p(phases))
        if rc == 0:
            return phases
    phases = np.empty_like(phase_a)
    if init_locked is None:
        phases[:, 0] = phase_a[:, 0]
        prev_locked = phase_a[:, 0].copy()
        k0 = 1
    else:
        prev_locked = np.asarray(init_locked, np.float32)
        k0 = 0
    for k in range(k0, f):
        iors = inst_over_rate[:, k - k0]
        rot = prev_locked + iors - phase_a[:, k]
        m = mag[:, k]
        left_m = np.roll(m, 1, axis=1)
        left_m[:, 0] = 0
        right_m = np.roll(m, -1, axis=1)
        right_m[:, -1] = 0
        dom_rot = np.where(left_m > np.maximum(m, right_m),
                           np.roll(rot, 1, axis=1),
                           np.where(right_m > m, np.roll(rot, -1, axis=1),
                                    rot))
        prev_locked = phase_a[:, k] + dom_rot
        phases[:, k] = prev_locked
    return phases


# frames per streamed block of the host PV: the spectral working set is
# ~9 arrays x (C, BLKF, N_FFT) f32 = ~70 MB at stereo/2048, vs GBs for
# media-length segments materialized whole (a 22-min all-stretched segment
# is ~230k frames; the unchunked pipeline streamed >15 GB of temporaries
# through DRAM and was memory-bound, PERF.md round 4/5)
_HOST_BLK_FRAMES = 2048


def _pv_host(seg, rate, num_out):
    """Host phase vocoder: the same math as _pv_segment, vectorized
    numpy/scipy over bounded frame blocks (the locked phase carries across
    blocks, so block boundaries are exact - identical arithmetic to the
    whole-segment pipeline; only the overlap-add's FP accumulation order
    differs at block seams, inside the final f16 write-back grid). The
    default: stretched segments are full-length f32 PCM, so the device
    path pays two PCM-sized transfers per segment."""
    import scipy.fft

    c, n_in = seg.shape
    f = -(-num_out // HOP_SYN)                      # frames with k*HOP < out
    pad = np.zeros((c, n_in + N_FFT + 8), np.float32)
    pad[:, :n_in] = seg
    # row-gather through a sliding-window view copies contiguous frames
    # (4 KB memcpy each) instead of the elementwise 2-D fancy-index
    # gather - measured 4x faster at media scale
    sw = np.lib.stride_tricks.sliding_window_view(pad, N_FFT, axis=1)
    omega = (2 * np.pi * np.arange(_BINS) * HOP_SYN / N_FFT).astype(np.float32)
    omega_rate = omega[None, None, :] * rate

    out_len = f * HOP_SYN + N_FFT
    out = np.zeros((c, out_len), np.float32)
    wsum = np.zeros(out_len, np.float32)
    w2 = (_WINDOW * _WINDOW).astype(np.float32)

    prev_phase_a = None                 # (C, 1, BINS) last frame of block
    prev_locked = None                  # (C, BINS) carried locked phases
    for b0 in range(0, f, _HOST_BLK_FRAMES):
        b1 = min(b0 + _HOST_BLK_FRAMES, f)
        fb = b1 - b0
        k = np.arange(b0, b1)
        pos = np.clip(np.round(k * (HOP_SYN * rate)).astype(np.int64), 0,
                      pad.shape[1] - N_FFT - 1)
        frames = np.empty((c, fb, N_FFT), np.float32)
        for ch in range(c):
            np.multiply(sw[ch][pos], _WINDOW[None, :], out=frames[ch])
        spec = scipy.fft.rfft(frames, axis=2)       # (C, fb, BINS) complex64
        # sqrt(re^2+im^2) skips complex abs's overflow-safe hypot (values
        # are bounded by N_FFT * PCM amplitude, far inside f32 range)
        re, im = spec.real, spec.imag
        mag = np.ascontiguousarray(
            np.sqrt(re * re + im * im, dtype=np.float32))
        phase_a = np.ascontiguousarray(np.arctan2(im, re).astype(np.float32))
        # all-frames phase increments are vectorized; the frame recurrence
        # stays a loop because the LOCKED phase is what carries forward
        # (identity phase locking with dominant-neighbor rotations, as in
        # _pv_segment)
        if b0 == 0:
            dphi = phase_a[:, 1:] - phase_a[:, :-1] - omega_rate
            dphi -= 2 * np.pi * np.round(dphi / (2 * np.pi))
            inst_over_rate = np.ascontiguousarray(
                (omega_rate + dphi) / rate, np.float32)
            phases = _phase_lock(phase_a, mag, inst_over_rate)
        else:
            pa_ext = np.concatenate([prev_phase_a, phase_a], axis=1)
            dphi = pa_ext[:, 1:] - pa_ext[:, :-1] - omega_rate
            dphi -= 2 * np.pi * np.round(dphi / (2 * np.pi))
            inst_over_rate = np.ascontiguousarray(
                (omega_rate + dphi) / rate, np.float32)
            phases = _phase_lock(phase_a, mag, inst_over_rate, prev_locked)
        prev_phase_a = phase_a[:, -1:].copy()
        prev_locked = phases[:, -1].copy()
        # stay in single precision: 1j*phases would promote to complex128
        spec_out = np.empty(phases.shape, np.complex64)
        np.multiply(mag, np.cos(phases), out=spec_out.real)
        np.multiply(mag, np.sin(phases), out=spec_out.imag)
        frames_out = scipy.fft.irfft(spec_out, n=N_FFT, axis=2)  # f32
        np.multiply(frames_out, _WINDOW[None, None, :], out=frames_out)

        base = b0 * HOP_SYN
        for g in range(N_FFT // HOP_SYN):           # 4 shifted group adds
            lo = g * HOP_SYN
            out[:, base + lo:base + lo + fb * HOP_SYN] += \
                frames_out[:, :, lo:lo + HOP_SYN].reshape(c, fb * HOP_SYN)
            wsum[base + lo:base + lo + fb * HOP_SYN] += \
                np.tile(w2[lo:lo + HOP_SYN], fb)
    return out[:, :num_out] / np.maximum(wsum[None, :num_out], 1e-3)


def _pv_backend():
    """'host' (default: full-length f32 segments cost two transfers on the
    device path) or 'device'."""
    import os
    return os.environ.get('DESCRIBEALIGN_PV', 'host')


def pv_stretch(seg, num_out):
    """Stretch seg (C, n_in) to (C, num_out) with pitch preserved.

    Host numpy/scipy by default; DESCRIBEALIGN_PV=device runs
    the bucketed one-dispatch JAX kernel instead (same math).
    """
    seg = np.asarray(seg, np.float32)
    c, n_in = seg.shape
    rate = n_in / num_out
    if _pv_backend() != 'device':
        out = _pv_host(seg, rate, num_out)
        return out.astype(np.float16).astype(np.float32)
    s_pad = _bucket(n_in + N_FFT + 8)
    seg_pad = np.zeros((c, s_pad), np.float32)
    seg_pad[:, :n_in] = seg
    num_frames = _bucket(num_out) // HOP_SYN + 1
    out = _pv_segment(jnp.asarray(seg_pad), jnp.float32(rate),
                      jnp.int32(num_out), num_frames)
    out = np.asarray(out)[:, :num_out]
    return out.astype(np.float16).astype(np.float32)
