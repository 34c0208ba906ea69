"""Shim: synthetic media generation lives in the package (bench uses it)."""
from describealign_jax.utils.synthmedia import (SR, build_pair,
                                                mapping_from_segments,
                                                speech_like)
