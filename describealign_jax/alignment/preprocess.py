"""Alignment preprocessing: local-mean subtraction, windowed norms, masks.

Reference semantics (describealign.py:595-633):
- per-feature local mean subtraction with a 41-tap hann (samples_per_node=21)
- windowed L2 norms over 41 frames, clipped at .001
- "quiet" frames (energy <= .5) are excluded from matching
- video frames are additionally subsampled to every 4th *non-quiet* frame

The reference does this math in float64 (numpy promotion); GPUs run f64 at
a small fraction of their f32 rate, so we compute in f32. The downstream quantities (1 - corr, qual) only
need ~1e-5 absolute accuracy against thresholds of ~1e-3, so f32 is ample;
the parity tests bound the difference.

All functions take zero-padded arrays plus a true length so shapes stay
static under jit (bucketed compilation).
"""
import jax
import jax.numpy as jnp
import numpy as np

from ..constants import TIMESTEPS_PER_SECOND
from ..ops.windows import hann_window

SAMPLES_PER_NODE = 210 // TIMESTEPS_PER_SECOND  # 21
WINDOW = 2 * SAMPLES_PER_NODE - 1               # 41

_PRECISION = jax.lax.Precision.HIGHEST


def mean_sub_taps(dtype=np.float32):
    w = hann_window(2 * SAMPLES_PER_NODE + 1)[1:-1]
    return (w / np.sum(w)).astype(dtype)


def local_mean_subtract(feature):
    """feature - hann41-smoothed local mean (reference 596-606)."""
    from ..ops.features import _conv_same
    mean = _conv_same(feature, mean_sub_taps())
    return feature.astype(jnp.float32) - mean


def uniform_norm(feature_ms):
    """Windowed L2 norm over 41 frames, clipped at .001 (reference 600-608).

    Same-length output: entry i is the norm of frames [i, i+41); the last 40
    entries (incomplete windows in the reference's 'valid' mode) are padded
    with the clip floor and are never used (masks exclude them).
    Shift-add instead of a convolution op (see ops/features._conv_same).
    """
    sq = feature_ms ** 2
    n = sq.shape[0] - (WINDOW - 1)
    window_sums = None
    for m in range(WINDOW):
        term = sq[m:m + n]
        window_sums = term if window_sums is None else window_sums + term
    norms = jnp.clip(window_sums ** 0.5, 0.001, None)
    return jnp.pad(norms, (0, WINDOW - 1), constant_values=0.001)


def valid_audio_mask(energy_padded, true_len):
    """Non-quiet frames eligible as match anchors (reference 657-658):
    energy > .5 and frame index < true_len - 41."""
    idx = jnp.arange(energy_padded.shape[0])
    return (idx < true_len - WINDOW) & (energy_padded > 0.5)


def valid_video_mask(energy_padded, true_len):
    """Video anchor mask: every 4th frame of the non-quiet subsequence
    (reference 629-633: `arange(...)[not_quiet][::4]`)."""
    base = valid_audio_mask(energy_padded, true_len)
    rank = jnp.cumsum(base.astype(jnp.int32)) - 1
    return base & (rank % 4 == 0)


@jax.jit
def preprocess_features(features_stacked):
    """Mean-sub + norms for a (F, Npad) stacked feature matrix.

    Returns (features_ms (F, Npad) f32, norms (F, Npad) f32).
    """
    ms = jax.vmap(local_mean_subtract)(features_stacked)
    norms = jax.vmap(uniform_norm)(ms)
    return ms, norms
