"""Filter blocks — reference blocklib/filter: fir_filter (+ decimation),
freq_xlating_fir, iir_filter, fft_filter (overlap-save), moving_average,
rational_resampler, pfb_channelizer. Each wraps the corresponding ops/
kernel and threads its streaming state through the compiled step."""

from __future__ import annotations

from fractions import Fraction

import jax.numpy as jnp
import numpy as np

import newsched_tpu.ops.analog as analog_ops
from newsched_tpu.ops import fir as fir_ops
from newsched_tpu.ops import nco, pfb as pfb_ops
from newsched_tpu.runtime.block import Block
from newsched_tpu.utils.dtypes import port_dtype


def _tap_dtype(taps) -> str:
    return "cf32" if np.iscomplexobj(np.asarray(taps)) else "rf32"


class fir_filter(Block):
    """Streaming FIR, optional decimation (reference filter::fir_filter).

    dtype in == dtype out; taps real or complex. `method` picks the compute
    path (auto/mxu/conv/fft — see ops/fir.py).
    """

    def __init__(self, taps, decim: int = 1, dtype="cf32", method: str = "auto", name=None):
        super().__init__(name)
        self.taps = np.asarray(taps)
        self.decim = int(decim)
        self.method = method
        self.relative_rate = Fraction(1, self.decim)
        d = port_dtype(dtype)
        self.dtype = d
        self.add_input("in", d)
        self.add_output("out", d)

    def init_state(self, nin, nout):
        return fir_ops.fir_init_state(len(self.taps), dtype=self.dtype.jnp_dtype)

    def work(self, state, ins, params, nout):
        st, y = fir_ops.fir_filter(self.taps, state, ins["in"],
                                   decim=self.decim, method=self.method)
        return st, {"out": y}


class freq_xlating_fir(Block):
    """Down-convert by center_freq, filter, decimate — one block, fully
    fused by XLA (reference filter::freq_xlating_fir_filter). The rotator is
    the exact fixed-point NCO, so long streams keep phase."""

    def __init__(self, taps, center_freq: float, sampling_freq: float,
                 decim: int = 1, dtype="cf32", method: str = "auto", name=None):
        super().__init__(name)
        self.taps = np.asarray(taps)
        self.decim = int(decim)
        self.method = method
        self.sampling_freq = float(sampling_freq)
        self.relative_rate = Fraction(1, self.decim)
        self.add_input("in", "cf32")
        self.add_output("out", "cf32")
        self.declare_param("dphase", nco.freq_to_dphase(center_freq, sampling_freq),
                           dtype=np.uint32)

    def set_center_freq(self, f: float) -> None:
        self.set_param("dphase", nco.freq_to_dphase(f, self.sampling_freq))

    def init_state(self, nin, nout):
        return {
            "rot": analog_ops.rotator_init_state(),
            "fir": fir_ops.fir_init_state(len(self.taps), dtype=jnp.complex64),
        }

    def work(self, state, ins, params, nout):
        rot_st, xr = analog_ops.rotate(state["rot"], ins["in"], params["dphase"], conj=True)
        fir_st, y = fir_ops.fir_filter(self.taps, state["fir"], xr,
                                       decim=self.decim, method=self.method)
        return {"rot": rot_st, "fir": fir_st}, {"out": y}


class iir_filter(Block):
    """Streaming IIR (reference filter::iir_filter) via parallel scan."""

    def __init__(self, ff_taps, fb_taps, dtype="rf32", name=None):
        super().__init__(name)
        self.ff = np.asarray(ff_taps, dtype=np.float32)
        self.fb = np.asarray(fb_taps, dtype=np.float32)
        d = port_dtype(dtype)
        self.dtype = d
        self.add_input("in", d)
        self.add_output("out", d)

    def init_state(self, nin, nout):
        from newsched_tpu.ops import iir as iir_ops

        return iir_ops.iir_init_state(len(self.ff), len(self.fb), dtype=self.dtype.jnp_dtype)

    def work(self, state, ins, params, nout):
        from newsched_tpu.ops import iir as iir_ops

        st, y = iir_ops.iir_filter(self.ff, self.fb, state, ins["in"])
        return st, {"out": y}


class fft_filter(Block):
    """Overlap-save fast-convolution FIR (reference filter::fft_filter) on
    XLA's float32 FFT pair."""

    def __init__(self, taps, decim: int = 1, dtype="cf32", fft_size: int | None = None,
                 name=None):
        super().__init__(name)
        self.taps = np.asarray(taps)
        self.decim = int(decim)
        self.fft_size = fft_size
        self.relative_rate = Fraction(1, self.decim)
        d = port_dtype(dtype)
        self.dtype = d
        self.add_input("in", d)
        self.add_output("out", d)

    def init_state(self, nin, nout):
        return fir_ops.fir_init_state(len(self.taps), dtype=self.dtype.jnp_dtype)

    def work(self, state, ins, params, nout):
        st, y = fir_ops.fir_filter(self.taps, state, ins["in"],
                                   decim=self.decim, method="fft",
                                   fft_size=self.fft_size)
        return st, {"out": y}


class moving_average(Block):
    """Length-N moving average with optional scale (reference
    filter::moving_average). Implemented as a ones-FIR — cumsum-diff is a
    later optimization if the conv shows up in profiles."""

    def __init__(self, length: int, scale: float | None = None, decim: int = 1,
                 dtype="rf32", name=None):
        super().__init__(name)
        self.length = int(length)
        scale = 1.0 / length if scale is None else scale
        self.taps = np.full(length, scale, dtype=np.float32)
        self.decim = int(decim)
        self.relative_rate = Fraction(1, self.decim)
        d = port_dtype(dtype)
        self.dtype = d
        self.add_input("in", d)
        self.add_output("out", d)

    def init_state(self, nin, nout):
        return fir_ops.fir_init_state(self.length, dtype=self.dtype.jnp_dtype)

    def work(self, state, ins, params, nout):
        st, y = fir_ops.fir_filter(self.taps, state, ins["in"],
                                   decim=self.decim, method="conv")
        return st, {"out": y}


class rational_resampler(Block):
    """Polyphase rational resampler interp/decim (reference
    filter::rational_resampler, upfirdn semantics). Designs its own taps if
    none given (low-pass at min(1/interp, 1/decim) band edge)."""

    def __init__(self, interp: int, decim: int, taps=None, dtype="cf32", name=None):
        super().__init__(name)
        self.interp = int(interp)
        self.decim = int(decim)
        if taps is None:
            from newsched_tpu.ops import firdes

            cutoff = 0.45 / max(interp, decim)
            trans = 0.1 / max(interp, decim)
            taps = firdes.low_pass(interp, 1.0, cutoff, trans)
        self.taps = np.asarray(taps)
        self.relative_rate = Fraction(self.interp, self.decim)
        d = port_dtype(dtype)
        self.dtype = d
        self.add_input("in", d)
        self.add_output("out", d)

    def init_state(self, nin, nout):
        return fir_ops.resampler_init_state(len(self.taps), self.interp,
                                            dtype=self.dtype.jnp_dtype)

    def work(self, state, ins, params, nout):
        st, y = fir_ops.fir_interp_filter(self.taps, state, ins["in"],
                                          self.interp, self.decim)
        return st, {"out": y}


class pfb_channelizer(Block):
    """M-channel polyphase channelizer (reference filter::pfb_channelizer):
    cf32 stream in -> stream of (M,)-vector items at rate 1/M, channel k
    centered at k/M of the input rate."""

    def __init__(self, nchans: int, taps=None, taps_per_arm: int = 16,
                 attenuation_db: float = 80.0, name=None):
        super().__init__(name)
        self.nchans = int(nchans)
        if taps is None:
            from newsched_tpu.ops import firdes

            taps = firdes.prototype_channelizer_taps(nchans, taps_per_arm, attenuation_db)
        self.taps = np.asarray(taps, dtype=np.float32)
        self.arm_taps = pfb_ops.pfb_arm_taps(self.taps, self.nchans)
        self.relative_rate = Fraction(1, self.nchans)
        self.add_input("in", "cf32")
        self.add_output("out", "cf32", item_shape=(self.nchans,))

    def init_state(self, nin, nout):
        return pfb_ops.pfb_init_state(self.arm_taps.size, dtype=jnp.complex64)

    def work(self, state, ins, params, nout):
        st, Y = pfb_ops.pfb_channelize(self.arm_taps, state, ins["in"])
        return st, {"out": Y}


class pfb_decimator(Block):
    """Single-channel PFB decimator (reference filter::pfb_decimator)."""

    def __init__(self, nchans: int, channel: int = 0, taps=None, taps_per_arm: int = 16,
                 name=None):
        super().__init__(name)
        self.nchans = int(nchans)
        self.channel = int(channel)
        if taps is None:
            from newsched_tpu.ops import firdes

            taps = firdes.prototype_channelizer_taps(nchans, taps_per_arm)
        self.taps = np.asarray(taps, dtype=np.float32)
        self.arm_taps = pfb_ops.pfb_arm_taps(self.taps, self.nchans)
        self.relative_rate = Fraction(1, self.nchans)
        self.add_input("in", "cf32")
        self.add_output("out", "cf32")

    def init_state(self, nin, nout):
        return pfb_ops.pfb_init_state(self.arm_taps.size, dtype=jnp.complex64)

    def work(self, state, ins, params, nout):
        st, y = pfb_ops.pfb_decimate(self.arm_taps, state, ins["in"],
                                     self.channel)
        return st, {"out": y}
