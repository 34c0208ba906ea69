"""Feature extraction front-end on the device (JAX).

Turns raw PCM (channels, samples) into the reference's 5 feature streams at
210 frames/sec (describealign.py:545-593):

  0. smoothed log energy              (get_energy,         545-555)
  1. zero-crossing rate               (get_zero_crossings, 557-566)
  2-4. cascaded frequency-band log energies (get_freq_bands, 568-593)

The math is kept numerically identical to the reference (float16-quantized
PCM, float32 accumulation, identical hann taps and cascade factors) so that
segment boundaries downstream match. Everything here is shape-static,
jit-friendly, and fuses into a handful of XLA elementwise/reduce kernels.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .windows import hann_taps

_PRECISION = jax.lax.Precision.HIGHEST


def _conv_same(x, taps):
    """np.convolve(x, taps, mode='same') with zero padding, f32.

    Implemented as shift-and-add over static slices rather than a
    convolution op: taps are short (<= 41) everywhere, so the sum fuses
    into one elementwise loop over the 1-D signal.
    """
    x = x.astype(jnp.float32)
    taps = np.asarray(taps, np.float32)
    t = len(taps)
    n = x.shape[0]
    c = (t - 1) // 2
    xpad = jnp.pad(x, (t - 1, t - 1))
    out = None
    # out[i] = sum_m taps[m] * x[i + c - m]
    for m in range(t):
        start = c - m + (t - 1)
        term = taps[m] * xpad[start:start + n]
        out = term if out is None else out + term
    return out


def energy_feature(pcm):
    """Smoothed log energy at 210 fps. pcm: (C, S) f32 on the f16 grid."""
    c, s = pcm.shape
    n = s - s % 105
    blocks = pcm[:, :n].reshape(c, -1, 105)
    energy = jnp.sum(blocks * blocks, axis=(0, 2)) / (105. * c)
    smooth = _conv_same(energy, hann_taps(15))
    return (jnp.log10(1. + smooth) / 2.)[::2]


def zero_crossing_feature(pcm, kill_crossing_at=None, kill_enabled=True):
    """Zero-crossing counts per 210-sample block at 210 fps, smoothed.

    kill_crossing_at: optional static sample index whose crossing is
    suppressed when kill_enabled (a traced bool) - used by the
    sequence-sharded extractor to cancel the artificial data->zero-halo
    crossing on the last shard.
    """
    sign = jnp.signbit(pcm)
    prev = jnp.concatenate([jnp.zeros((pcm.shape[0], 1), bool), sign[:, :-1]],
                           axis=1)
    xings = sign != prev
    if kill_crossing_at is not None:
        killed = jnp.logical_and(xings[:, kill_crossing_at],
                                 jnp.logical_not(kill_enabled))
        xings = xings.at[:, kill_crossing_at].set(killed)
    n = xings.shape[1] - xings.shape[1] % 210
    per_block = xings[:, :n].reshape(xings.shape[0], -1, 210)
    counts = jnp.sum(per_block, axis=(0, 2)).astype(jnp.float32)
    if pcm.shape[0] == 1:
        counts = counts * 2
    return _conv_same(counts, hann_taps(15))


def _downsample_blur(arr, downsample, blur):
    """Polyphase hann lowpass + decimate-by-`downsample` (reference 568-573).

    Equivalent to summing per-phase 'same' convolutions of the strided
    components with the strided hann taps.
    """
    taps = hann_taps(downsample * blur + 2)
    n = arr.shape[0] - arr.shape[0] % downsample
    arr = arr[:n]
    out = None
    for i in range(downsample):
        part = _conv_same(arr[i::downsample], taps[i::downsample])
        out = part if out is None else out + part
    return out


def freq_band_features(pcm):
    """Three cascaded band log-energies at 210 fps (reference 575-593).

    Channel mean (f16-rounded like the reference's float16 PCM mean), then a
    cascade of polyphase downsample stages (factors 5, 7, 6); each stage's
    residual energy (x - blur(x))^2 is hann-smoothed to 210 fps and
    log-compressed. A crude 3-band filterbank, NOT an STFT - required for
    segment-boundary parity with the reference.
    """
    if pcm.shape[0] > 1:
        arr = jnp.mean(pcm, axis=0)
        arr = arr.astype(jnp.float16).astype(jnp.float32)  # f16 grid parity
    else:
        arr = pcm[0]
    arr = arr[:arr.shape[0] - arr.shape[0] % 210]
    downsamples = [5, 7, 6]
    decimation = 1
    bands = []
    for ds in downsamples:
        if ds == downsamples[-1]:
            bottom = jnp.zeros((1,), jnp.float32)
        else:
            bottom = _downsample_blur(arr, ds, 3)
        decimation *= ds
        arr2d = arr.reshape(-1, ds)
        band_energy = None
        for i in range(ds):
            term = (arr2d[:, i].astype(jnp.float32) - bottom) ** 2
            band_energy = term if band_energy is None else band_energy + term
        band = _downsample_blur(band_energy, 210 // decimation, 15) / 210.
        bands.append(jnp.log10(1. + band) / 2.)
        arr = bottom
    return bands


@partial(jax.jit, static_argnames=('num_channels', 'frontend'))
def _extract(pcm, num_channels, frontend='cascade'):
    del num_channels  # shape-static; kept for cache keying clarity
    energy = energy_feature(pcm)
    zcr = zero_crossing_feature(pcm)
    if frontend == 'mel':
        from .mel import mel_band_features
        bands = mel_band_features(pcm)
    else:
        bands = freq_band_features(pcm)
    return (energy, zcr) + tuple(bands)


def extract_features(pcm):
    """All 5 feature streams for one PCM array (channels, samples).

    Returns a tuple of 5 f32 device arrays at 210 fps. Lengths may differ by
    one frame between streams (energy keeps a half-block tail), matching the
    reference exactly. DESCRIBEALIGN_FRONTEND=mel swaps streams 2-4 for the
    optional mel filterbank (ops/mel.py; not parity-preserving).
    """
    from .mel import frontend_name
    pcm = jnp.asarray(pcm, jnp.float32)
    return _extract(pcm, pcm.shape[0], frontend_name())
