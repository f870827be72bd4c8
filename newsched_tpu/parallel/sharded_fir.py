"""Time-sharded streaming FIR/fft_filter with tag preservation — BASELINE
config #3: overlap-save fast convolution with the sample stream sharded
across devices and stream tags surviving the shard boundaries.

Design: the batch is time-sharded P("t"); each device filters its segment
after a one-`ppermute` halo exchange (parallel/halo.py) — the overlap-save
"overlap" IS the halo. Tags never need communication at all: they are
batch-relative metadata carried outside the sharded data plane, and the
output segments reassemble in time order, so a tag's offset maps as
offset' = offset * num // den exactly as in the unsharded graph. That
"tags ride the batch, not the shard" property is the design answer to the
reference's buffer-attached tags, which must be serialized across its zmq
shard boundaries (reference: buffer_net_zmq tag serialization).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from newsched_tpu.ops import fir as fir_ops
from newsched_tpu.parallel.halo import time_halo
from newsched_tpu.runtime import tags as tags_mod


class ShardedFirState(NamedTuple):
    carry: jax.Array  # (n_dev * (ntaps-1),) input tail carry, time-sharded


class ShardedFirFilter:
    """step(x, tags, state) -> (y, tags', state): x (B,) sharded over "t";
    tags a TagBatch (replicated); y (B/decim,) sharded over "t"."""

    def __init__(self, mesh: Mesh, taps: np.ndarray, decim: int = 1,
                 method: str = "fft", axis: str = "t"):
        self.mesh = mesh
        self.axis = axis
        self.n_dev = mesh.shape[axis]
        self.taps = np.asarray(taps)
        self.ntaps = len(self.taps)
        self.decim = int(decim)
        taps_l = self.taps
        decim_l = self.decim
        method_l = method
        H = self.ntaps - 1
        axis_name = axis

        def spmd(x_seg, carry_seg):
            halo, new_carry = time_halo(x_seg, carry_seg, axis_name)
            st, y = fir_ops.fir_filter(taps_l, fir_ops.FirState(tail=halo), x_seg,
                                       decim=decim_l, method=method_l)
            return y, new_carry

        if self.n_dev == 1:
            def single(x, carry):
                st, y = fir_ops.fir_filter(taps_l, fir_ops.FirState(tail=carry), x,
                                           decim=decim_l, method=method_l)
                return y, x[-H:]

            self._spmd = single
        else:
            from jax import shard_map

            Pt = P(axis_name)
            self._spmd = shard_map(spmd, mesh=mesh, in_specs=(Pt, Pt),
                                   out_specs=(Pt, Pt))

    def init_state(self) -> ShardedFirState:
        dev = NamedSharding(self.mesh, P(self.axis))
        return ShardedFirState(
            carry=jax.device_put(
                jnp.zeros((self.n_dev * (self.ntaps - 1),), jnp.complex64), dev
            )
        )

    def min_batch(self) -> int:
        """Per-device segment must cover the ntaps-1 halo and divide by
        decim."""
        seg = max(-(-(self.ntaps - 1) // self.decim) * self.decim, self.decim)
        return self.n_dev * seg

    def step(self, x: jax.Array, tags: tags_mod.TagBatch | None,
             state: ShardedFirState):
        B = int(x.shape[0])
        seg = B // self.n_dev
        if B % (self.n_dev * self.decim) != 0:
            raise ValueError(f"batch {B} must divide by n_dev*decim")
        if seg < self.ntaps - 1:
            raise ValueError(
                f"segment {seg} smaller than halo {self.ntaps - 1}; raise batch"
            )
        y, carry = self._spmd(x, state.carry)
        out_tags = None
        if tags is not None:
            out_tags = tags_mod.remap(tags, 1, self.decim)
        return y, out_tags, ShardedFirState(carry=carry)

    def input_sharding(self):
        return NamedSharding(self.mesh, P(self.axis))
