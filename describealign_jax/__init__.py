"""describealign-jax: audio-description alignment on an accelerator.

A from-scratch JAX/XLA re-design of the capabilities of
julbean/describealign (reference v2.0.8): aligns an audio-description track
to a video's original soundtrack and muxes a combined output. The dense
matching - coarse descriptor correlation with a max-plus DP and the banded
fine correlation - runs on the GPU; host code handles feature extraction,
the irregular DPs, the L1 rate-change fit, ffmpeg I/O, orchestration, and
reports.

Public API (matches the reference's documented module API):

    import describealign_jax as da
    da.combine('video.mp4', 'audio.mp3')
"""

__version__ = '0.1.0'

from .utils.jaxsetup import setup_jax_cache as _setup_jax_cache

_setup_jax_cache()

from .constants import (  # noqa: E402,F401
    AUDIO_SAMPLE_RATE, AUDIO_EXTENSIONS, VIDEO_EXTENSIONS,
    DEFAULT_ALIGNMENT_DIR, DEFAULT_OUTPUT_DIR,
)


def combine(*args, **kwargs):
    """Align and combine media pairs (lazy import to keep CLI startup fast)."""
    from .pipeline import combine as _combine
    return _combine(*args, **kwargs)


def align(*args, **kwargs):
    """Align one feature pair; see describealign_jax.alignment.api.align."""
    from .alignment.api import align as _align
    return _align(*args, **kwargs)
