"""Sequence-parallel feature extraction (shard_map + halo exchange).

For hours-long media the 44.1 kHz PCM is sharded along time over the mesh's
'seq' axis; each device computes the 210 fps features for its shard. All
feature ops are local convolutions/reductions whose reach is bounded
(~2000 samples for the band cascade, ~1500 for the energy smoother), so a
halo of HALO_FRAMES*210 samples exchanged with ring neighbors via
jax.lax.ppermute makes every interior frame bit-identical to the unsharded
computation. This is the context-parallel analog of the reference's chunked
streaming (describealign.py:251-294), done as SPMD over the device mesh.

Shard-size contract: per-device PCM length must be a multiple of 210
samples so the polyphase cascade phases stay globally aligned.
"""
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops import features as F

HALO_FRAMES = 16
HALO = HALO_FRAMES * 210  # samples


def _halo_exchange(x, axis_name):
    """Append neighbors' boundary samples: (C, S) -> (C, S + 2*HALO).

    Edge devices get zeros (matching the unsharded zero-padded 'same'
    convolution boundaries).
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    right_edge = x[:, -HALO:]
    left_edge = x[:, :HALO]
    from_left = jax.lax.ppermute(right_edge, axis_name,
                                 [(i, (i + 1) % n) for i in range(n)])
    from_right = jax.lax.ppermute(left_edge, axis_name,
                                  [(i, (i - 1) % n) for i in range(n)])
    from_left = jnp.where(idx == 0, 0.0, from_left)
    from_right = jnp.where(idx == n - 1, 0.0, from_right)
    return jnp.concatenate([from_left, x, from_right], axis=1)


def _local_features(pcm_local, axis_name):
    """Per-shard feature computation on the halo-extended signal."""
    ext = _halo_exchange(pcm_local, axis_name)
    s_loc = pcm_local.shape[1]
    f_loc = s_loc // 210
    n = jax.lax.axis_size(axis_name)
    is_last = jax.lax.axis_index(axis_name) == n - 1
    energy = F.energy_feature(ext)[HALO // 210: HALO // 210 + f_loc]
    # the last shard's right halo is zeros; suppress the artificial
    # data->zero sign crossing the unsharded computation never sees
    zcr = F.zero_crossing_feature(
        ext, kill_crossing_at=HALO + s_loc,
        kill_enabled=is_last)[HALO // 210: HALO // 210 + f_loc]
    bands = [b[HALO // 210: HALO // 210 + f_loc]
             for b in F.freq_band_features(ext)]
    return jnp.stack([energy, zcr] + bands, axis=0)  # (5, f_loc)


def sequence_sharded_features(pcm, mesh, axis='seq'):
    """Extract (5, S//210) features with PCM sharded along time.

    pcm: (C, S) with S a multiple of 210 * mesh.shape[axis].
    """
    fn = shard_map(
        partial(_local_features, axis_name=axis),
        mesh=mesh,
        in_specs=P(None, axis),
        out_specs=P(None, axis),
    )
    sharding = NamedSharding(mesh, P(None, axis))
    return jax.jit(fn)(jax.device_put(pcm, sharding))
