"""Sharded wideband FM channelizer — the flagship multi-device pipeline
(BASELINE config #4: N-channel channelizer + per-channel FM demod, sharded
across devices with a halo exchange).

Layout strategy (one batch = n_dev * seg samples of the wideband stream):

  1. **Time sharding in**: each device holds one contiguous time segment.
     The polyphase filterbank needs M*L-1 preceding samples: one
     ``ppermute`` halo exchange per batch (parallel/halo.py), device 0
     splicing the previous batch's carry.
  2. **Local channelize**: each device runs the full M-channel PFB on its
     segment (grouped conv + IDFT across arms) -> (seg/M, M) local.
  3. **Corner turn**: ``all_to_all`` re-shards from time-sharded full-band
     to channel-sharded full-time: (seg/M * n, M/n). This is the classic
     channelizer corner turn, compiled to the device interconnect.
  4. **Channel-parallel demod + audio**: each device now owns M/n channels
     for the WHOLE batch, so quadrature-demod history and audio-FIR tails
     are plain per-device state — no further communication, perfect
     scaling. Output stays channel-sharded (the natural layout for
     per-channel consumers).

The same code runs on any mesh size including 1 (collectives degenerate),
and on the CPU-simulated mesh for tests — mesh-size-agnostic by
construction (SURVEY.md §8 hard part #6).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from newsched_tpu.ops import fir as fir_ops
from newsched_tpu.ops import pfb as pfb_ops
from newsched_tpu.parallel.halo import time_halo


class ShardedFMState(NamedTuple):
    pfb_carry: jax.Array    # (n_dev * (M*L-1),) time-sharded input tail carry
    demod_prev: jax.Array   # (M,) channel-sharded last channel sample
    audio_tail: jax.Array   # (M, A-1) channel-sharded audio FIR tails


class PlanesFMState(NamedTuple):
    """State of the planes-rows chain (``step_planes``): the last
    ``history_rows`` input rows (ops/fm_chain.py), per device. Only the
    last device's rows matter; the halo exchange splices them to device 0
    at the next batch."""

    carry: jax.Array  # (n_dev * history_rows, 2M), time-sharded


def planes_rows(x: np.ndarray, nchans: int,
                skew_carry: np.ndarray | None = None) -> np.ndarray:
    """Host helper: complex samples -> the (n, 2M) f32 planes-rows stream
    format of the fused chain (ops/fm_chain.py): row k =
    [re | im] of x[kM-(M-1) .. kM]. ``skew_carry`` is the previous batch's
    last M-1 samples (zeros at stream start)."""
    M = int(nchans)
    x = np.asarray(x)
    if skew_carry is None:
        skew_carry = np.zeros(M - 1, x.dtype)
    full = np.concatenate([skew_carry, x])[: (len(x) // M) * M]
    rows = full.reshape(-1, M)
    return np.concatenate([rows.real, rows.imag], axis=1).astype(np.float32)


class ShardedFMChannelizer:
    """Builds the jitted sharded streaming step.

    step(x, state) -> (audio, state): x is the (B,) wideband batch sharded
    P("t"); audio is (B/M/audio_decim, M) sharded P(None, "t") — i.e.
    channel-sharded.
    """

    def __init__(self, mesh: Mesh, nchans: int, taps: np.ndarray,
                 audio_taps: np.ndarray, audio_decim: int = 8,
                 demod_gain: float = 1.0, axis: str = "t",
                 audio_method: str = "auto", pfb_combine: str = "auto",
                 chain_precision=jax.lax.Precision.HIGHEST):
        # chain_precision: the DFT matmul's precision in the planes-rows
        # chain (ops/fm_chain.py): jax.lax.Precision.HIGHEST or "split3".
        self.mesh = mesh
        self.axis = axis
        self.n_dev = mesh.shape[axis]
        self.nchans = int(nchans)
        if self.nchans % self.n_dev != 0:
            raise ValueError(f"nchans {nchans} must divide by mesh size {self.n_dev}")
        self.arm_taps = pfb_ops.pfb_arm_taps(np.asarray(taps, np.float32), self.nchans)
        self.ntaps = int(self.arm_taps.size)
        self.audio_taps = np.asarray(audio_taps, np.float32)
        self.audio_decim = int(audio_decim)
        self.demod_gain = float(demod_gain)
        self.chain_precision = chain_precision
        M, L = self.arm_taps.shape
        # Taps stay host-side numpy: the kernels build their tap matrices
        # at trace time.
        arm = self.arm_taps
        ataps = self.audio_taps
        self.c_fold = arm[::-1, ::-1].T.copy()  # (L, M), ops/pfb.py layout

        axis_name = self.axis
        decim = self.audio_decim
        gain = np.float32(self.demod_gain)

        def chain(Y, demod_prev, audio_tail):
            # Per-channel quadrature demod over the batch + audio FIR.
            xprev = jnp.concatenate([demod_prev[None, :], Y[:-1]], axis=0)
            p = jnp.conj(xprev) * Y
            # zero history -> exactly 0 (the convention of every demod
            # path, see ops/fm_chain.py)
            aud = jnp.where((xprev == 0) | (Y == 0), jnp.float32(0),
                            jnp.arctan2(jnp.imag(p), jnp.real(p))) * gain

            def one(tail, ch):
                st, y = fir_ops.fir_filter(ataps, fir_ops.FirState(tail=tail), ch,
                                           decim=decim, method=audio_method)
                return st.tail, y

            new_tails, ys = jax.vmap(one)(audio_tail, aud.T.astype(jnp.float32))
            return ys.T, Y[-1], new_tails

        if self.n_dev == 1:
            def single_step(x, pfb_carry, demod_prev, audio_tail):
                st, Y = pfb_ops.pfb_channelize(arm, pfb_ops.PfbState(tail=pfb_carry), x,
                                               combine=pfb_combine)
                ys, new_prev, new_tails = chain(Y, demod_prev, audio_tail)
                return ys, st.tail, new_prev, new_tails

            self._spmd_step = single_step
        else:
            def spmd_step(x_seg, pfb_carry, demod_prev, audio_tail):
                # x_seg: (seg,) local segment. pfb_carry: (ntaps-1,) local.
                # demod_prev: (M/n,), audio_tail: (M/n, A-1) local channels.
                halo, new_carry = time_halo(x_seg, pfb_carry, axis_name)
                _, Y = pfb_ops.pfb_channelize(arm, pfb_ops.PfbState(tail=halo),
                                              x_seg, combine=pfb_combine)
                # Y: (seg/M, M) local. Corner turn -> (seg/M * n, M/n).
                Yc = lax.all_to_all(Y, axis_name, split_axis=1, concat_axis=0,
                                    tiled=True)
                ys, new_prev, new_tails = chain(Yc, demod_prev, audio_tail)
                return ys, new_carry, new_prev, new_tails

            Pt = P(axis_name)
            self._spmd_step = shard_map(
                spmd_step, mesh=mesh,
                in_specs=(Pt, Pt, P(axis_name), P(axis_name, None)),
                out_specs=(P(None, axis_name), Pt, P(axis_name), P(axis_name, None)),
            )

    # -- state ----------------------------------------------------------
    def init_state(self, seed: int = 0) -> ShardedFMState:
        M = self.nchans
        A = len(self.audio_taps)
        H = self.ntaps - 1
        dev = NamedSharding(self.mesh, P(self.axis))
        return ShardedFMState(
            pfb_carry=jax.device_put(jnp.zeros((self.n_dev * H,), jnp.complex64), dev),
            demod_prev=jax.device_put(jnp.zeros((M,), jnp.complex64), dev),
            audio_tail=jax.device_put(jnp.zeros((M, A - 1), jnp.float32),
                                      NamedSharding(self.mesh, P(self.axis, None))),
        )

    def step(self, x: jax.Array, state: ShardedFMState):
        """One batch. x: (B,) cf32, B a multiple of batch_multiple() and
        >= min_batch(), sharded (or shardable) over the time axis."""
        B = int(x.shape[0])
        if B % self.batch_multiple() != 0:
            raise ValueError(f"batch {B} not a multiple of {self.batch_multiple()}")
        if B < self.min_batch():
            raise ValueError(
                f"batch {B} too small: per-device segment must cover the "
                f"{self.ntaps - 1}-sample filter halo; need >= {self.min_batch()}"
            )
        audio, carry, prev, tails = self._spmd_step(
            x, state.pfb_carry, state.demod_prev, state.audio_tail
        )
        return audio, state._replace(pfb_carry=carry, demod_prev=prev, audio_tail=tails)

    # -- planes-rows API ---------------------------------------------------
    # The fused chain's native stream format: (n, 2M) f32 rows, row k =
    # [re | im] of input samples x[kM-(M-1) .. kM] (see planes_rows() and
    # ops/fm_chain.py). The chain's state is its input-row history, so for
    # n_dev > 1 it runs per time shard inside shard_map after ONE input-rows
    # ppermute halo: shards never need each other's outputs, no corner
    # turn, and audio stays time-sharded.

    def _history(self) -> int:
        from newsched_tpu.ops.fm_chain import history_rows

        return history_rows(self.arm_taps.shape[1], len(self.audio_taps))

    def _check_planes(self, n_rows: int) -> None:
        n_loc, rem = divmod(n_rows, self.n_dev)
        if rem or n_loc % self.audio_decim:
            raise ValueError(
                f"n_rows {n_rows} must be a multiple of mesh size {self.n_dev}"
                f" x audio decimation {self.audio_decim}")
        if self.n_dev > 1 and n_loc < self._history():
            raise ValueError(
                f"per-device rows {n_loc} < the chain's {self._history()}-row"
                " history: one halo exchange cannot cover it; use a larger "
                "batch")

    def init_state_planes(self, n_rows: int) -> PlanesFMState:
        """n_rows: planes rows per global batch (= batch_samples / nchans)."""
        self._check_planes(n_rows)
        carry = jnp.zeros((self.n_dev * self._history(), 2 * self.nchans),
                          jnp.float32)
        return PlanesFMState(carry=jax.device_put(
            carry, NamedSharding(self.mesh, P(self.axis, None))))

    def step_planes(self, xrows: jax.Array, state: PlanesFMState):
        """One batch of the fused chain on the planes stream.

        xrows: (n_rows, 2M) f32 planes rows, sharded (or shardable)
        P(axis, None). Returns (audio (n_rows // audio_decim, M) f32 —
        time-sharded P(axis, None) — and the next PlanesFMState).
        """
        from newsched_tpu.ops.fm_chain import fm_chain_rows

        self._check_planes(int(xrows.shape[0]))
        h = self._history()

        def chain(rows):
            return fm_chain_rows(rows, self.c_fold, self.audio_taps,
                                 self.audio_decim, self.demod_gain,
                                 self.chain_precision)

        if self.n_dev == 1:
            rows = jnp.concatenate([state.carry, xrows])
            return chain(rows), PlanesFMState(carry=rows[-h:])

        def spmd(xr, carry):
            halo, new_carry = time_halo(xr, carry, self.axis)
            return chain(jnp.concatenate([halo, xr])), new_carry

        P2 = P(self.axis, None)
        aud, new_carry = shard_map(
            spmd, mesh=self.mesh, in_specs=(P2, P2), out_specs=(P2, P2),
        )(xrows, state.carry)
        return aud, PlanesFMState(carry=new_carry)

    def planes_input_sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, P(self.axis, None))

    # -- complex-planes boundary (utils/cplx.py) --------------------------
    def init_state_enc(self):
        """Encoded initial state built WITHOUT any eager complex op."""
        from newsched_tpu.utils.cplx import ComplexParts

        M = self.nchans
        A = len(self.audio_taps)
        H = self.ntaps - 1
        dev = NamedSharding(self.mesh, P(self.axis))
        dev2 = NamedSharding(self.mesh, P(self.axis, None))

        def zf(shape, shard):
            return jax.device_put(jnp.zeros(shape, jnp.float32), shard)

        return ShardedFMState(
            pfb_carry=ComplexParts(zf((self.n_dev * H,), dev), zf((self.n_dev * H,), dev)),
            demod_prev=ComplexParts(zf((M,), dev), zf((M,), dev)),
            audio_tail=zf((M, A - 1), dev2),
        )

    def step_enc(self, x_parts, state_enc):
        """Encoded-boundary step: x_parts is ComplexParts of f32 (B,) planes;
        state_enc an encoded ShardedFMState. Returns (audio f32, state_enc)."""
        from newsched_tpu.utils import cplx

        x = cplx.decode(x_parts)
        audio, new_state = self.step(x, cplx.decode(state_enc))
        return audio, cplx.encode(new_state)

    def batch_multiple(self) -> int:
        return self.n_dev * self.nchans * self.audio_decim

    def min_batch(self) -> int:
        """Smallest legal batch: each device's segment must be >= ntaps-1 (the
        halo a single ppermute can cover) and a multiple of M * audio_decim."""
        unit = self.nchans * self.audio_decim
        seg = -(-(self.ntaps - 1) // unit) * unit
        return self.n_dev * max(seg, unit)

    def input_sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, P(self.axis))
