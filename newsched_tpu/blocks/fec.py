"""FEC blocks: convolutional encoder / Viterbi decoder, interleavers.

Maps the reference's (minimal) blocklib/fec — GNU Radio's gr-fec CC
encoder/decoder pair — onto the kernels in ops/fec.py. Streams carry
hard bits (ri16 0/1) on the encoder side and soft metrics (rf32 LLRs,
positive = 1 more likely) into the decoder.

Packetized contract: the stream is segmented into fixed ``frame_bits``
message frames; each frame is independently terminated (K-1 flush bits) —
the standard CC framing, and what keeps every shape static per batch.
Rates are exact rationals so the graph compiler's rate algebra sizes
batches correctly: encoder out/in = n*(frame+K-1)/frame, decoder inverse.
"""

from __future__ import annotations

from fractions import Fraction

import jax.numpy as jnp
import numpy as np

from newsched_tpu.ops import fec as fec_ops
from newsched_tpu.runtime.block import Block


class cc_encoder(Block):
    """Rate-1/n convolutional encoder over frames of frame_bits bits."""

    def __init__(self, frame_bits: int = 512, polys=fec_ops.CC_K7_POLYS,
                 K: int = 7, name=None):
        super().__init__(name)
        self.frame_bits = int(frame_bits)
        self.polys = tuple(polys)
        self.K = int(K)
        n = len(self.polys)
        self.coded_per_frame = (self.frame_bits + self.K - 1) * n
        self.add_input("in", "ri16")
        self.add_output("out", "ri16")
        self.relative_rate = Fraction(self.coded_per_frame, self.frame_bits)

    def work(self, state, ins, params, nout):
        bits = ins["in"].reshape(-1, self.frame_bits)

        def enc(frame):
            return fec_ops.conv_encode(frame, self.polys, self.K, terminate=True)

        import jax

        coded = jax.vmap(enc)(bits)
        return state, {"out": coded.reshape(-1).astype(jnp.int16)}


class cc_decoder(Block):
    """Viterbi decoder consuming rf32 LLRs (positive = bit 1); emits the
    decoded frame_bits message bits per frame."""

    def __init__(self, frame_bits: int = 512, polys=fec_ops.CC_K7_POLYS,
                 K: int = 7, name=None):
        super().__init__(name)
        self.frame_bits = int(frame_bits)
        self.polys = tuple(polys)
        self.K = int(K)
        n = len(self.polys)
        self.coded_per_frame = (self.frame_bits + self.K - 1) * n
        self.add_input("in", "rf32")
        self.add_output("out", "ri16")
        self.relative_rate = Fraction(self.frame_bits, self.coded_per_frame)

    def work(self, state, ins, params, nout):
        llr = ins["in"].reshape(-1, self.coded_per_frame)

        def dec(frame):
            return fec_ops.viterbi_decode(frame, self.polys, self.K,
                                          terminated=True)

        import jax

        bits = jax.vmap(dec)(llr)
        return state, {"out": bits.reshape(-1).astype(jnp.int16)}


class interleaver(Block):
    """Block interleaver over fixed frames (write rows, read columns)."""

    def __init__(self, frame: int, rows: int, dtype="rf32", inverse: bool = False,
                 name=None):
        super().__init__(name)
        if frame % rows != 0:
            raise ValueError(f"frame {frame} not divisible by rows {rows}")
        self.frame, self.rows, self.inverse = int(frame), int(rows), bool(inverse)
        self.add_input("in", dtype)
        self.add_output("out", dtype)

    def work(self, state, ins, params, nout):
        x = ins["in"].reshape(-1, self.frame)
        fn = fec_ops.block_deinterleave if self.inverse else fec_ops.block_interleave
        import jax

        y = jax.vmap(lambda f: fn(f, self.rows))(x)
        return state, {"out": y.reshape(-1)}


def deinterleaver(frame: int, rows: int, dtype="rf32", name=None) -> interleaver:
    return interleaver(frame, rows, dtype=dtype, inverse=True, name=name)
