"""Vector-stream DSP blocks: per-channel kernels over (M,)-vector items.

The reference runs one block chain per channel after a channelizer (its
GRC-level fanout of M demod chains); here a single block processes all M
channels as one batched kernel — the per-channel axis IS the hardware
vector lane / mesh axis (SURVEY.md §3.6 "channel fan-out -> data
parallelism over channels").
"""

from __future__ import annotations

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from newsched_tpu.ops import fir as fir_ops
from newsched_tpu.runtime.block import Block


class vector_quad_demod(Block):
    """Quadrature/FM demod applied per channel on (M,)-vector items:
    cf32[(M,)] -> rf32[(M,)]."""

    def __init__(self, nchans: int, gain: float = 1.0, name=None):
        super().__init__(name)
        self.nchans = int(nchans)
        self.add_input("in", "cf32", item_shape=(self.nchans,))
        self.add_output("out", "rf32", item_shape=(self.nchans,))
        self.declare_param("gain", gain, dtype=np.float32)

    def init_state(self, nin, nout):
        return {"prev": jnp.zeros((self.nchans,), jnp.complex64)}

    def work(self, state, ins, params, nout):
        x = ins["in"]  # (n, M)
        xprev = jnp.concatenate([state["prev"][None, :], x[:-1]], axis=0)
        p = jnp.conj(xprev) * x
        # Zero-history convention: pinned to exactly 0, as in every other
        # demod path (ops/analog.py, parallel/channelizer.py, ops/fm_chain.py).
        y = jnp.where((xprev == 0) | (x == 0), jnp.float32(0),
                      jnp.arctan2(jnp.imag(p), jnp.real(p))) * params["gain"]
        return {"prev": x[-1]}, {"out": y.astype(jnp.float32)}


class vector_fir(Block):
    """Shared-taps FIR (+decimation) applied per channel on vector items:
    the audio filter stage of a channelized receiver. State is a per-channel
    tail; compute vmaps the streaming FIR kernel over the channel axis."""

    def __init__(self, nchans: int, taps, decim: int = 1, dtype="rf32",
                 method: str = "auto", name=None):
        super().__init__(name)
        self.nchans = int(nchans)
        self.taps = np.asarray(taps)
        self.decim = int(decim)
        self.method = method
        self.relative_rate = Fraction(1, self.decim)
        from newsched_tpu.utils.dtypes import port_dtype

        d = port_dtype(dtype)
        self.dtype = d
        self.add_input("in", d, item_shape=(self.nchans,))
        self.add_output("out", d, item_shape=(self.nchans,))

    def init_state(self, nin, nout):
        ntaps = len(self.taps)
        return fir_ops.FirState(
            tail=jnp.zeros((self.nchans, max(ntaps - 1, 0)), self.dtype.jnp_dtype)
        )

    def work(self, state, ins, params, nout):
        x = ins["in"].T  # (M, n)
        taps = self.taps

        def one(tail, xc):
            st, y = fir_ops.fir_filter(taps, fir_ops.FirState(tail=tail), xc,
                                       decim=self.decim, method=self.method)
            return st.tail, y

        tails, ys = jax.vmap(one)(state.tail, x)
        return fir_ops.FirState(tail=tails), {"out": ys.T}


class channel_select(Block):
    """Pick one channel from a vector stream: cf32[(M,)] -> cf32 scalar
    items (utility for tests and single-channel taps off a channelizer)."""

    def __init__(self, nchans: int, channel: int, dtype="cf32", name=None):
        super().__init__(name)
        self.channel = int(channel)
        from newsched_tpu.utils.dtypes import port_dtype

        d = port_dtype(dtype)
        self.add_input("in", d, item_shape=(int(nchans),))
        self.add_output("out", d)

    def work(self, state, ins, params, nout):
        return state, {"out": ins["in"][:, self.channel]}


class cplx_to_planes(Block):
    """Adapter: cf32 scalar stream -> the planes-rows stream format of the
    fused FM chain (ops/fm_chain.py): rf32[(2M,)] rows, row k =
    [re | im] of x[kM-(M-1) .. kM]. Carries the M-1-sample skew between
    batches. Native planes sources (noise_planes_source, or
    vector_source over parallel.channelizer.planes_rows data) skip this
    block — and its lane-concat — entirely."""

    def __init__(self, nchans: int, name=None):
        super().__init__(name)
        self.nchans = int(nchans)
        self.relative_rate = Fraction(1, self.nchans)
        self.add_input("in", "cf32")
        self.add_output("out", "rf32", item_shape=(2 * self.nchans,))

    def init_state(self, nin, nout):
        return {"skew": jnp.zeros((self.nchans - 1,), jnp.complex64)}

    def work(self, state, ins, params, nout):
        M = self.nchans
        x = ins["in"]
        full = jnp.concatenate([state["skew"], x])
        rows = full[: nout * M].reshape(nout, M)
        planes = jnp.concatenate(
            [jnp.real(rows), jnp.imag(rows)], axis=1).astype(jnp.float32)
        return {"skew": full[nout * M:]}, {"out": planes}


class noise_planes_source(Block):
    """Gaussian noise emitted directly in planes-rows format, the producer
    that feeds fm_channelizer_fused_planes its native stream (each lane is
    an i.i.d. draw, so the M-1-sample skew of the row convention is
    immaterial).

    method="threefry" (default) draws each batch from a jax.random key
    that advances per batch, so the stream depends on the batch size.
    method="pure" is the position-pure stream of ops/noise.py: a function
    of (seed, absolute row group) alone, batch-size-invariant, and the
    stream the live flagship source generates (batches in multiples of
    GROUP_ROWS rows).
    """

    def __init__(self, nchans: int, amplitude: float = 1.0, seed: int = 0,
                 method: str = "threefry", name=None):
        super().__init__(name)
        if method not in ("threefry", "pure"):
            raise ValueError(f"method {method!r} not in threefry/pure")
        self.nchans = int(nchans)
        self.seed = int(seed)
        self.method = method
        self.add_output("out", "rf32", item_shape=(2 * self.nchans,))
        self.declare_param("amplitude", amplitude, dtype=np.float32)

    def init_state(self, nin, nout):
        from newsched_tpu.ops.noise import GROUP_ROWS

        if self.method == "pure":
            if nout % GROUP_ROWS:
                raise ValueError(
                    f"noise_planes_source(method='pure') needs batches in "
                    f"multiples of {GROUP_ROWS} rows, got {nout}")
            return {"ghi": jnp.zeros((), jnp.int32),
                    "glo": jnp.zeros((), jnp.int32)}
        return {"key": jax.random.PRNGKey(self.seed)}

    def work(self, state, ins, params, nout):
        from newsched_tpu.ops.noise import GROUP_ROWS, advance_groups, pure_rows

        if self.method == "pure":
            r = pure_rows(self.seed, state["ghi"], state["glo"], nout,
                          2 * self.nchans)
            hi, lo = advance_groups(state["ghi"], state["glo"],
                                    nout // GROUP_ROWS)
            return {"ghi": hi, "glo": lo}, {"out": r * params["amplitude"]}
        key, sub = jax.random.split(state["key"])
        r = jax.random.normal(sub, (nout, 2 * self.nchans), dtype=jnp.float32)
        return {"key": key}, {"out": r * params["amplitude"]}


def _fold_coeffs(nchans: int, taps, taps_per_arm):
    """(L, M) arm-fold coefficients of the channelizer prototype (the
    ``c`` of ops/pfb.py)."""
    from newsched_tpu.ops import firdes, pfb as pfb_ops

    if taps is None:
        taps = firdes.prototype_channelizer_taps(nchans, taps_per_arm or 16)
    arm = pfb_ops.pfb_arm_taps(np.asarray(taps, np.float32), nchans)
    return np.asarray(arm)[::-1, ::-1].T.copy()


class fm_noise_channelizer_source(Block):
    """The LIVE flagship as ONE source block: position-pure Gaussian noise
    (ops/noise.py) generated per batch in planes-rows format and run
    through the FM chain (ops/fm_chain.py). Emits rf32[(M,)] audio items.

    The noise is a function of (seed, absolute row group), so the chain's
    input history is regenerated each batch instead of carried: the only
    state is the 64-bit group counter. Equals ``noise_planes_source(
    method="pure", seed, amplitude) -> fm_channelizer_fused_planes`` with
    the same chain parameters. Under fg.run(mesh=...) each device
    generates its own time shard: no collectives.
    """

    def __init__(self, nchans: int, taps, audio_taps, audio_decim: int = 8,
                 gain: float = 1.0, amplitude: float = 1.0, seed: int = 0,
                 taps_per_arm: int | None = None,
                 precision=jax.lax.Precision.HIGHEST,
                 name=None):
        super().__init__(name)
        self.nchans = int(nchans)
        self.fold_c = _fold_coeffs(self.nchans, taps, taps_per_arm)
        self.audio_taps = np.asarray(audio_taps, np.float32)
        self.audio_decim = int(audio_decim)
        self.gain = float(gain)
        self.seed = int(seed)
        self.precision = precision
        self.add_output("out", "rf32", item_shape=(self.nchans,))
        self.declare_param("amplitude", amplitude, dtype=np.float32)

    def _rows(self, nout: int) -> int:
        from newsched_tpu.ops.noise import GROUP_ROWS

        n = int(nout) * self.audio_decim
        if n % GROUP_ROWS:
            raise ValueError(
                f"{self.name}: batch rows {n} must be a multiple of the "
                f"noise group ({GROUP_ROWS} rows)")
        return n

    def init_state(self, nin, nout):
        self._rows(nout)
        return {"ghi": jnp.zeros((), jnp.int32),
                "glo": jnp.zeros((), jnp.int32)}

    def _audio(self, ghi, glo, amp, n: int):
        """Audio for the n rows starting at group (ghi, glo)."""
        from newsched_tpu.ops.fm_chain import fm_chain_rows, history_rows
        from newsched_tpu.ops.noise import (GROUP_ROWS, add_groups_signed,
                                            pure_rows)

        h = history_rows(self.fold_c.shape[0], len(self.audio_taps))
        back = -(-h // GROUP_ROWS)
        hi, lo = add_groups_signed(ghi, glo, -back)
        rows = pure_rows(self.seed, hi, lo, back * GROUP_ROWS + n,
                         2 * self.nchans, mask_pre=True) * amp
        return fm_chain_rows(rows[back * GROUP_ROWS - h:], self.fold_c,
                             self.audio_taps, self.audio_decim, self.gain,
                             self.precision)

    def work(self, state, ins, params, nout):
        from newsched_tpu.ops.noise import GROUP_ROWS, advance_groups

        n = self._rows(nout)
        aud = self._audio(state["ghi"], state["glo"], params["amplitude"], n)
        hi, lo = advance_groups(state["ghi"], state["glo"], n // GROUP_ROWS)
        return {"ghi": hi, "glo": lo}, {"out": aud}

    def work_sharded(self, state, ins, params, nout, mesh, axis):
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        from newsched_tpu.ops.noise import (GROUP_ROWS, add_groups_signed,
                                            advance_groups)

        nd = mesh.shape[axis]
        n = self._rows(nout)
        if (n // GROUP_ROWS) % nd:
            raise ValueError(f"{self.name}: {n // GROUP_ROWS} row groups per "
                             f"batch do not split over mesh axis {nd}")
        n_loc = n // nd

        def fn(ghi, glo, amp):
            d = jax.lax.axis_index(axis).astype(jnp.int32)
            hi, lo = add_groups_signed(ghi, glo, d * (n_loc // GROUP_ROWS))
            return self._audio(hi, lo, amp, n_loc)

        aud = shard_map(fn, mesh=mesh, in_specs=(P(), P(), P()),
                        out_specs=P(axis, None))(
            state["ghi"], state["glo"], params["amplitude"])
        hi, lo = advance_groups(state["ghi"], state["glo"], n // GROUP_ROWS)
        return {"ghi": hi, "glo": lo}, {"out": aud}


class fm_channelizer_fused_planes(Block):
    """The flagship chain as ONE block on the planes-rows stream:
    rf32[(2M,)] rows in -> rf32[(M,)] audio out at rate 1/decim, computed
    by ops/fm_chain.py. The stream format is the chain's native format, so
    the block pays no per-batch layout conversion. The state is the last
    ``history_rows`` input rows; the demod and audio-FIR lead-in is
    recomputed from them each batch."""

    def __init__(self, nchans: int, taps, audio_taps, audio_decim: int = 8,
                 gain: float = 1.0, taps_per_arm: int | None = None,
                 precision=jax.lax.Precision.HIGHEST, name=None):
        super().__init__(name)
        from newsched_tpu.ops.fm_chain import history_rows

        self.nchans = int(nchans)
        self.fold_c = _fold_coeffs(self.nchans, taps, taps_per_arm)
        self.audio_taps = np.asarray(audio_taps, np.float32)
        self.audio_decim = int(audio_decim)
        self.gain = float(gain)
        self.precision = precision
        self.hist = history_rows(self.fold_c.shape[0], len(self.audio_taps))
        self.relative_rate = Fraction(1, self.audio_decim)
        self.add_input("in", "rf32", item_shape=(2 * self.nchans,))
        self.add_output("out", "rf32", item_shape=(self.nchans,))

    def init_state(self, nin, nout):
        return {"carry": jnp.zeros((self.hist, 2 * self.nchans), jnp.float32)}

    def work(self, state, ins, params, nout):
        from newsched_tpu.ops.fm_chain import fm_chain_rows

        rows = jnp.concatenate([state["carry"], ins["in"]])
        aud = fm_chain_rows(rows, self.fold_c, self.audio_taps,
                            self.audio_decim, self.gain, self.precision)
        return {"carry": rows[-self.hist:]}, {"out": aud}

    # Under fg.run(mesh=...) the block runs per time shard through
    # parallel.channelizer.ShardedFMChannelizer.step_planes: one
    # input-rows ppermute halo, audio stays time-sharded.

    def _sharded_pipe(self, mesh, axis):
        from newsched_tpu.parallel.channelizer import ShardedFMChannelizer

        key = (tuple(d.id for d in mesh.devices.flat), axis)
        cache = getattr(self, "_sharded_cache", None)
        if cache is None or cache[0] != key:
            proto = self.fold_c.T[::-1, ::-1].T.reshape(-1)  # inverse of pfb_arm_taps
            ch = ShardedFMChannelizer(
                mesh, self.nchans, proto, self.audio_taps,
                audio_decim=self.audio_decim, demod_gain=self.gain, axis=axis,
                chain_precision=self.precision)
            self._sharded_cache = (key, ch)
        return self._sharded_cache[1]

    def init_state_sharded(self, nin, nout, mesh, axis):
        st = self._sharded_pipe(mesh, axis).init_state_planes(nin)
        return {"carry": st.carry}

    def work_sharded(self, state, ins, params, nout, mesh, axis):
        from newsched_tpu.parallel.channelizer import PlanesFMState

        aud, st = self._sharded_pipe(mesh, axis).step_planes(
            ins["in"], PlanesFMState(carry=state["carry"]))
        return {"carry": st.carry}, {"out": aud}
