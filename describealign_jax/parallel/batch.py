"""Batch and multi-chip execution of the device-side alignment pipeline.

The reference processes directory pairs in a sequential Python loop
(describealign.py:1077). Here the pairs dimension is a real batch axis:

- batched_match: jax.vmap of the full device matcher over same-bucket pairs
  (one chip amortizes FFT/matmul launch overheads across pairs).
- sharded_match: the same, sharded over a 1-D device mesh ("data" axis) -
  pure data parallelism, no cross-pair communication.
- make_mesh: standard mesh helper.

Pairs are length-bucketed by the caller (all members of a batch share
padded shapes); true lengths ride along as per-pair scalars.
"""
from functools import lru_cache

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..alignment.matching import _match_core
from ..alignment.preprocess import preprocess_features


def make_mesh(n_devices=None, axis='data'):
    devices = np.array(jax.devices()[:n_devices] if n_devices
                       else jax.devices())
    return Mesh(devices, (axis,))


def device_align_step(feats_a, len_a, feats_v, len_v):
    """Full device-side pipeline for one pair: preprocess + match.

    feats_*: (5, Npad) stacked raw features (f16 uploads welcome - cast
    to f32 here, like the single-pair entry points). Returns the
    compressed candidate form (quals f16 (B,210,K), offs int16,
    starts int32) plus the coarse-confidence margin (f32 scalar) that
    the host stages consume (video frame = starts[b] + off). Qualities
    ride the same u8 transport grid as the single-pair paths, so sharded
    and serial results are identical.
    """
    import jax.numpy as jnp
    from ..alignment.matching import _qual_dequantize_f16, _qual_quantize_u8
    feats_a = feats_a.astype(jnp.float32)
    feats_v = feats_v.astype(jnp.float32)
    ms_a, norms_a = preprocess_features(feats_a)
    ms_v, norms_v = preprocess_features(feats_v)
    quals, offs, starts, _, margin = _match_core(
        ms_a, norms_a, feats_a[0], len_a,
        ms_v, norms_v, feats_v[0], len_v)
    return (_qual_dequantize_f16(_qual_quantize_u8(quals)), offs, starts,
            margin)


@jax.jit
def batched_match(feats_a, lens_a, feats_v, lens_v):
    """vmap over the pair axis. feats_*: (B, 5, Npad); lens_*: (B,)."""
    return jax.vmap(device_align_step)(feats_a, lens_a, feats_v, lens_v)


def sharded_match(mesh, feats_a, lens_a, feats_v, lens_v):
    """Data-parallel batched matching over a device mesh.

    Pairs are sharded along the mesh's first axis; each device runs the
    batched matcher on its shard. No collectives are needed (pure DP); XLA
    inserts only the initial scatter and final gather.
    """
    shard = NamedSharding(mesh, P(mesh.axis_names[0]))

    def place(x):
        return jax.device_put(x, shard)

    return _sharded_step(mesh)(place(feats_a), place(lens_a),
                               place(feats_v), place(lens_v))


@lru_cache(maxsize=None)
def _sharded_step(mesh):
    """One jitted program per mesh, so repeated groups reuse its compile."""
    shard = NamedSharding(mesh, P(mesh.axis_names[0]))
    return jax.jit(jax.vmap(device_align_step),
                   in_shardings=(shard, shard, shard, shard),
                   out_shardings=shard)
