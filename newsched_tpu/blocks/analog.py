"""Analog blocks — reference blocklib/analog: sig_source, noise_source,
agc, quadrature_demod. Waveform generation uses the exact fixed-point NCO
(ops/nco.py), so multi-hour streams keep phase exactly."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

import newsched_tpu.ops.agc as agc_ops
import newsched_tpu.ops.analog as analog_ops
from newsched_tpu.ops import nco
from newsched_tpu.runtime.block import Block, SyncBlock
from newsched_tpu.utils.dtypes import port_dtype


class sig_source(Block):
    """Tone/waveform source (reference analog::sig_source<T>): sin, cos,
    complex exponential, square, triangle, sawtooth at exact NCO phase.

    frequency/amplitude/offset are runtime-settable parameters; waveform and
    dtype are compile-time.
    """

    WAVEFORMS = ("cos", "sin", "complex", "square", "triangle", "saw")

    def __init__(self, sampling_freq: float, waveform: str = "complex",
                 frequency: float = 1000.0, amplitude: float = 1.0,
                 offset: float = 0.0, dtype="cf32", name=None):
        super().__init__(name)
        if waveform not in self.WAVEFORMS:
            raise ValueError(f"waveform {waveform!r} not in {self.WAVEFORMS}")
        self.waveform = waveform
        self.sampling_freq = float(sampling_freq)
        d = port_dtype(dtype)
        self.dtype = d
        self.add_output("out", d)
        self.declare_param("dphase", nco.freq_to_dphase(frequency, sampling_freq),
                           dtype=np.uint32, doc="per-sample phase increment")
        self.declare_param("amplitude", amplitude, dtype=np.float32)
        self.declare_param("offset", offset,
                           dtype=d.np_dtype if d.name != "cf32" else np.complex64)

    def set_frequency(self, freq: float) -> None:
        self.set_param("dphase", nco.freq_to_dphase(freq, self.sampling_freq))

    def init_state(self, nin, nout):
        return {"phase": jnp.zeros((), jnp.uint32)}

    def work(self, state, ins, params, nout):
        ph0, dp = state["phase"], params["dphase"]
        a = params["amplitude"]
        phase = nco.nco_phase(ph0, dp, nout)
        if self.waveform == "complex":
            y = nco.jax_complex(jnp.cos(phase), jnp.sin(phase)) * a.astype(jnp.complex64)
        elif self.waveform == "cos":
            y = jnp.cos(phase) * a
        elif self.waveform == "sin":
            y = jnp.sin(phase) * a
        elif self.waveform == "square":
            y = jnp.where(phase < jnp.pi, a, -a)
        elif self.waveform == "triangle":
            t = phase / (2 * jnp.pi)
            y = a * (4 * jnp.abs(t - 0.5) - 1.0)
        else:  # saw
            y = a * (phase / jnp.pi - 1.0)
        y = (y + params["offset"]).astype(self.dtype.jnp_dtype)
        return {"phase": nco.nco_advance(ph0, dp, nout)}, {"out": y}


class noise_source(Block):
    """Gaussian/uniform noise (reference analog::noise_source<T>) from
    jax.random's counter-based threefry generator; the key advances once
    per batch."""

    def __init__(self, noise_type: str = "gaussian", amplitude: float = 1.0,
                 seed: int = 0, dtype="cf32", name=None):
        super().__init__(name)
        self.noise_type = noise_type
        self.seed = seed
        self.dtype = port_dtype(dtype)
        self.add_output("out", self.dtype)
        self.declare_param("amplitude", amplitude, dtype=np.float32)

    def init_state(self, nin, nout):
        return {"key": jax.random.PRNGKey(self.seed)}

    def work(self, state, ins, params, nout):
        a = params["amplitude"]
        complex_out = self.dtype.name == "cf32"
        key, sub = jax.random.split(state["key"])
        shape = (nout, 2) if complex_out else (nout,)
        if self.noise_type == "gaussian":
            r = jax.random.normal(sub, shape, dtype=jnp.float32)
        else:
            r = jax.random.uniform(sub, shape, dtype=jnp.float32, minval=-1.0, maxval=1.0)
        if complex_out:
            # Match the reference: each of I/Q gets a full-amplitude draw.
            y = nco.jax_complex(r[:, 0], r[:, 1]) * a.astype(jnp.complex64)
        else:
            y = (r * a).astype(self.dtype.jnp_dtype)
        return {"key": key}, {"out": y}


class agc(SyncBlock):
    """AGC (reference analog::agc_cc/_ff) via the parallel-scan kernel."""

    def __init__(self, rate: float = 1e-4, reference: float = 1.0,
                 gain: float = 1.0, max_gain: float = 0.0, dtype="cf32", name=None):
        super().__init__(name)
        d = port_dtype(dtype)
        self.add_input("in", d)
        self.add_output("out", d)
        self.initial_gain = gain
        self.max_gain = max_gain
        self.declare_param("rate", rate, dtype=np.float32)
        self.declare_param("reference", reference, dtype=np.float32)

    def init_state(self, nin, nout):
        return agc_ops.agc_init_state(self.initial_gain)

    def work(self, state, ins, params, nout):
        st, y = agc_ops.agc(state, ins["in"], params["rate"], params["reference"],
                            self.max_gain)
        return st, {"out": y}


class quadrature_demod(Block):
    """FM discriminator (reference analog::quadrature_demod): cf32 -> rf32,
    y[n] = gain * arg(conj(x[n-1]) x[n])."""

    def __init__(self, gain: float = 1.0, name=None):
        super().__init__(name)
        self.add_input("in", "cf32")
        self.add_output("out", "rf32")
        self.declare_param("gain", gain, dtype=np.float32)

    def init_state(self, nin, nout):
        return analog_ops.quad_demod_init_state()

    def work(self, state, ins, params, nout):
        st, y = analog_ops.quadrature_demod(state, ins["in"], params["gain"])
        return st, {"out": y}


def _emphasis_taps(fs: float, tau: float, fh: float | None, deemph: bool):
    """Single-pole emphasis-network taps via the bilinear transform.

    Standard FM broadcast emphasis design (GR-lineage fm_deemph/fm_preemph
    python hier blocks): corner at 1/tau rad/s, prewarped; the pre-emphasis
    network adds an upper corner fh (default 0.925 * fs/2) so gain stops
    rising near Nyquist. Returns (ff_taps, fb_taps) for ops/iir.lfilter.
    """
    import math

    w_cl = 1.0 / tau
    w_cla = 2.0 * fs * math.tan(w_cl / (2.0 * fs))
    if deemph:
        k = -w_cla / (2.0 * fs)
        p1 = (1.0 + k) / (1.0 - k)
        b0 = -k / (1.0 - k)
        return np.array([b0, b0], np.float64), np.array([1.0, -p1], np.float64)
    # Clamp like the GR reference: fh at/above Nyquist puts the pole on or
    # beyond the unit circle (tan singular/negative) -> silent instability.
    if fh is None or fh <= 0.0 or fh >= fs / 2.0:
        fh = 0.925 * fs / 2.0
    w_ch = 2.0 * math.pi * fh
    w_cha = 2.0 * fs * math.tan(w_ch / (2.0 * fs))
    kl = -w_cla / (2.0 * fs)
    kh = -w_cha / (2.0 * fs)
    z1 = (1.0 + kl) / (1.0 - kl)
    p1 = (1.0 + kh) / (1.0 - kh)
    b0 = (1.0 - kl) / (1.0 - kh)
    return np.array([b0, -z1 * b0], np.float64), np.array([1.0, -p1], np.float64)


class fm_deemph(Block):
    """FM broadcast de-emphasis (GR-lineage analog fm_deemph hier block):
    single-pole IIR low-pass, corner 1/tau (tau = 75 us US / 50 us EU),
    run through the companion-matrix IIR scan (ops/iir.py)."""

    def __init__(self, fs: float, tau: float = 75e-6, name=None):
        super().__init__(name)
        self.add_input("in", "rf32")
        self.add_output("out", "rf32")
        from newsched_tpu.ops import iir as iir_ops

        b, a = _emphasis_taps(fs, tau, None, deemph=True)
        self.ff, self.fb = iir_ops.lfilter_taps(b, a)

    def init_state(self, nin, nout):
        from newsched_tpu.ops import iir as iir_ops

        return iir_ops.iir_init_state(len(self.ff), len(self.fb),
                                      dtype=jnp.float32)

    def work(self, state, ins, params, nout):
        from newsched_tpu.ops import iir as iir_ops

        st, y = iir_ops.iir_filter(self.ff, self.fb, state, ins["in"])
        return st, {"out": y}


class fm_preemph(Block):
    """FM broadcast pre-emphasis (GR-lineage analog fm_preemph): one zero
    at the 1/tau corner, one pole at fh (default 0.925 * Nyquist)."""

    def __init__(self, fs: float, tau: float = 75e-6, fh: float = -1.0,
                 name=None):
        super().__init__(name)
        self.add_input("in", "rf32")
        self.add_output("out", "rf32")
        from newsched_tpu.ops import iir as iir_ops

        b, a = _emphasis_taps(fs, tau, fh if fh > 0 else None, deemph=False)
        self.ff, self.fb = iir_ops.lfilter_taps(b, a)

    init_state = fm_deemph.init_state
    work = fm_deemph.work


def _resamp_taps(resamp_interp: int, resamp_decim: int, resamp_taps):
    if resamp_interp != 1:
        raise NotImplementedError(
            "the one-block wbfm chain decimates only (resamp_interp=1); use "
            "the staged wbfm_receiver for rational interpolation")
    if resamp_taps is None:
        from newsched_tpu.ops import firdes

        cutoff = 0.45 / resamp_decim
        trans = 0.1 / resamp_decim
        resamp_taps = firdes.low_pass(1.0, 1.0, cutoff, trans)
    return np.asarray(resamp_taps)


class wbfm_rcv_fused(Block):
    """The wideband-FM receive chain (BASELINE config #1: freq_xlating_fir
    -> quadrature_demod -> rational_resampler) as ONE block over
    ops/wbfm_chain.py: cf32 scalar stream in -> rf32 scalar audio at rate
    1/(decim*resamp_decim).

    Drop-in for the staged chain of models.wbfm_receiver (matches it to
    float32 accuracy). Differences by design: center_freq is a
    recompile-fence parameter (the rotated taps bake it into the trace)
    and the resampler decimates only. The state is the last
    ``plan.history`` input samples, so under fg.run(mesh=...) XLA's SPMD
    partitioner shards the block like any other FIR.
    """

    def __init__(self, chan_taps, center_freq: float, fs: float,
                 decim: int = 4, deviation: float = 75e3,
                 resamp_interp: int = 1, resamp_decim: int = 5,
                 resamp_taps=None, name=None):
        super().__init__(name)
        from fractions import Fraction

        quad_rate = fs / decim
        self._plan_args = (np.asarray(chan_taps), float(fs), int(decim),
                           _resamp_taps(resamp_interp, resamp_decim,
                                        resamp_taps), int(resamp_decim),
                           float(quad_rate / (2 * np.pi * deviation)))
        self.plan = self._build_plan(center_freq)
        # Recompile-fence retune (SURVEY §8): set_param("center_freq", f),
        # locally or over the control socket, rebuilds the plan and the
        # runner retraces at the next batch boundary. The state is raw
        # input samples, so the retuned chain re-locks seamlessly.
        self.declare_param("center_freq", float(center_freq),
                           dtype=np.float64, fence=True)
        self.relative_rate = Fraction(1, decim * resamp_decim)
        self.add_input("in", "cf32")
        self.add_output("out", "rf32")

    def _build_plan(self, center_freq: float):
        from newsched_tpu.ops.wbfm_chain import WbfmChainPlan

        chan_taps, fs, decim, rt, rd, gain = self._plan_args
        return WbfmChainPlan(chan_taps,
                             int(nco.freq_to_dphase(center_freq, fs)),
                             decim, rt, rd, demod_gain=gain)

    def on_fence_param(self, name, value):
        # the history length depends only on tap counts, so the state
        # pytree survives the retrace unchanged
        self.plan = self._build_plan(float(value))

    def init_state(self, nin, nout):
        return {"hist": jnp.zeros((self.plan.history,), jnp.complex64)}

    def work(self, state, ins, params, nout):
        from newsched_tpu.ops.wbfm_chain import wbfm_chain

        x = jnp.concatenate([state["hist"], ins["in"]])
        return ({"hist": x[-self.plan.history:]},
                {"out": wbfm_chain(x, self.plan)})


def _tone_window(phase0, dphase, amp, first, back: int, n: int):
    """cf32 fxpt-NCO tone for the `back` samples before the batch and its n
    samples (uint32 phase wraparound reaches back exactly). On the
    stream's first batch (first != 0) the samples before the stream are 0,
    the staged graph's zero initial state."""
    dp = dphase.astype(jnp.uint32)
    ph = nco.nco_phase(phase0.astype(jnp.uint32) - jnp.uint32(back) * dp, dp,
                       back + n)
    y = nco.jax_complex(jnp.cos(ph), jnp.sin(ph)) * amp.astype(jnp.complex64)
    pre = (first != 0) & (jnp.arange(back + n) < back)
    return jnp.where(pre, jnp.complex64(0), y)


class wbfm_live_source(Block):
    """The LIVE wbfm receiver as ONE source block: an fxpt-NCO test tone
    generated per batch and demodulated by ops/wbfm_chain.py. The only
    stream state is the phase counter (+ a first-batch flag for the
    pre-stream zero region): the chain's input history is regenerated from
    the phase, so each batch, and each time shard under fg.run(mesh=...),
    is a pure function of its absolute sample range. Emits the scalar rf32
    audio stream; equals ``sig_source -> wbfm_rcv_fused`` with the same
    tone and chain parameters.
    """

    def __init__(self, chan_taps, center_freq: float, fs: float,
                 decim: int = 4, deviation: float = 75e3,
                 resamp_interp: int = 1, resamp_decim: int = 5,
                 resamp_taps=None, frequency: float = 0.0,
                 amplitude: float = 1.0, name=None):
        super().__init__(name)
        quad_rate = fs / decim
        self._plan_args = (np.asarray(chan_taps), float(fs), int(decim),
                           _resamp_taps(resamp_interp, resamp_decim,
                                        resamp_taps), int(resamp_decim),
                           float(quad_rate / (2 * np.pi * deviation)))
        self.plan = self._build_plan(center_freq)
        self.sampling_freq = float(fs)
        self.add_output("out", "rf32")
        self.declare_param("dphase", nco.freq_to_dphase(frequency, fs),
                           dtype=np.uint32, doc="tone phase increment")
        self.declare_param("amplitude", amplitude, dtype=np.float32)
        # same recompile-fence retune as wbfm_rcv_fused
        self.declare_param("center_freq", float(center_freq),
                           dtype=np.float64, fence=True)

    _build_plan = wbfm_rcv_fused._build_plan
    on_fence_param = wbfm_rcv_fused.on_fence_param

    def set_frequency(self, freq: float) -> None:
        self.set_param("dphase", nco.freq_to_dphase(freq, self.sampling_freq))

    def init_state(self, nin, nout):
        return {"phase": jnp.zeros((), jnp.uint32),
                "first": jnp.ones((), jnp.int32)}

    def work(self, state, ins, params, nout):
        from newsched_tpu.ops.wbfm_chain import wbfm_chain

        n = int(nout) * self.plan.D * self.plan.Rd
        h = self.plan.history
        x = _tone_window(state["phase"], params["dphase"],
                         params["amplitude"], state["first"], h, n)
        return ({"phase": nco.nco_advance(state["phase"], params["dphase"], n),
                 "first": jnp.zeros((), jnp.int32)},
                {"out": wbfm_chain(x, self.plan)})


class fir_tone_source(Block):
    """Config #0's whole chain as ONE live source: an fxpt-NCO tone
    generated per batch and FIR-filtered (+decimated) in the same jitted
    step (ops/fir.py). A FIR has no recursive state, so the filter's
    lookback is regenerated from the phase counter each batch and the only
    stream state is that counter: each batch, and each time shard under
    fg.run(mesh=...), is a pure function of its absolute sample range.
    Emits the filtered cf32 stream; equals ``sig_source -> fir_filter``.
    """

    def __init__(self, sampling_freq: float, taps, frequency: float = 0.0,
                 amplitude: float = 1.0, decim: int = 1,
                 method: str = "mxu3", name=None):
        super().__init__(name)
        from fractions import Fraction

        self.taps = np.asarray(taps)
        self.decim = int(decim)
        self.method = method
        self.sampling_freq = float(sampling_freq)
        self.relative_rate = Fraction(1)
        self.add_output("out", "cf32")
        self.declare_param("dphase", nco.freq_to_dphase(frequency,
                                                        sampling_freq),
                           dtype=np.uint32, doc="tone phase increment")
        self.declare_param("amplitude", amplitude, dtype=np.float32)

    def set_frequency(self, freq: float) -> None:
        self.set_param("dphase", nco.freq_to_dphase(freq, self.sampling_freq))

    def init_state(self, nin, nout):
        return {"phase": jnp.zeros((), jnp.uint32),
                "first": jnp.ones((), jnp.int32)}

    def work(self, state, ins, params, nout):
        from newsched_tpu.ops import fir as fir_ops

        n = int(nout) * self.decim
        h = len(self.taps) - 1
        x = _tone_window(state["phase"], params["dphase"],
                         params["amplitude"], state["first"], h, n)
        _, y = fir_ops.fir_filter(self.taps, fir_ops.FirState(tail=x[:h]),
                                  x[h:], decim=self.decim, method=self.method)
        return ({"phase": nco.nco_advance(state["phase"], params["dphase"], n),
                 "first": jnp.zeros((), jnp.int32)}, {"out": y})
