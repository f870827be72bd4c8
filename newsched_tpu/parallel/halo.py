"""Time-axis halo exchange — the DSP analog of context-parallel attention's
ring exchange (SURVEY.md §6): when the sample stream is sharded across
devices along time, every streaming filter needs the (ntaps-1)-sample tail
of its left neighbor's segment. One `ppermute` per batch moves all halos
simultaneously over the device interconnect; device 0 splices in the carry from the previous
batch (its left neighbor in *time* is the last device one batch ago).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def time_halo(x_seg: jax.Array, carry: jax.Array, axis_name: str):
    """Inside shard_map: compute each device's left halo for its segment.

    Args:
      x_seg: this device's (S, ...) time segment of the current batch.
      carry: (H, ...) carried tail from the previous batch (meaningful on
        device 0; uniformly updated everywhere to keep SPMD shapes).
      axis_name: mesh axis the time dimension is sharded over.

    Returns (halo, new_carry): halo is the (H, ...) samples that precede
    this device's segment in absolute stream order; new_carry must be
    threaded to the next batch.
    """
    h = carry.shape[0]
    n = lax.axis_size(axis_name)
    tail = x_seg[-h:]
    perm = [(i, (i + 1) % n) for i in range(n)]
    recv = lax.ppermute(tail, axis_name, perm)
    idx = lax.axis_index(axis_name)
    is_first = (idx == 0)
    halo = jnp.where(is_first, carry, recv)
    # recv on device 0 is the last device's tail of THIS batch — exactly
    # what device 0 needs NEXT batch.
    return halo, recv
