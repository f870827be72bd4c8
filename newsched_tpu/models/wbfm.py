"""Flagship models: the BASELINE.json benchmark flowgraphs.

- fir_chain        — config #0: sig_source -> 128-tap FIR lowpass -> head
- wbfm_receiver    — config #1: freq_xlating_fir -> quadrature_demod ->
                     rational_resampler (broadcast-FM receive chain)
- fm_channelizer   — configs #2/#4: pfb_channelizer -> per-channel FM demod
                     -> per-channel audio FIR decimation

Each returns (Flowgraph, dict of interesting blocks). The channelizer model
is also exposed as a bare step function for the sharded/benchmark paths
(models.wbfm.channelizer_step) so bench.py and parallel/ reuse the exact
same math the graph runs.
"""

from __future__ import annotations

import jax
import numpy as np

from newsched_tpu.blocks import analog, filter as filt, general
from newsched_tpu.blocks import vector_dsp
from newsched_tpu.ops import firdes
from newsched_tpu.runtime.graph import Flowgraph


def fir_chain(n_samples: int = 10_000_000, fs: float = 1e6, ntaps: int = 128,
              frequency: float = 123_456.0, batch_size: int | None = None,
              sink: str = "null", source=None):
    """Config #0: signal_source -> FIR lowpass(ntaps) -> head -> sink.

    source="live" runs the whole chain as one source block
    (blocks.analog.fir_tone_source): the fxpt-NCO tone is generated per
    batch and FIR-filtered in the same step, stateless but for the phase
    counter. Matches the staged chain to float32 accuracy (same fxpt NCO
    values, same taps)."""
    taps = firdes.low_pass(1.0, fs, 0.2 * fs, 0.05 * fs, ntaps=ntaps)
    fg = Flowgraph("fir_chain", batch_size=batch_size)
    if source == "live":
        src = analog.fir_tone_source(fs, taps, frequency=frequency)
        hd = general.head(n_samples)
        snk = general.null_sink() if sink == "null" else general.vector_sink()
        fg.connect(src, 0, hd, 0)
        fg.connect(hd, 0, snk, 0)
        return fg, {"src": src, "fir": src, "head": hd, "sink": snk,
                    "taps": taps}
    src = analog.sig_source(fs, "complex", frequency=frequency)
    # mxu3: the Toeplitz-matmul FIR at the 3-pass bf16 precision
    fir = filt.fir_filter(taps, method="mxu3")
    hd = general.head(n_samples)
    snk = general.null_sink() if sink == "null" else general.vector_sink()
    fg.connect(src, 0, fir, 0)
    fg.connect(fir, 0, hd, 0)
    fg.connect(hd, 0, snk, 0)
    return fg, {"src": src, "fir": fir, "head": hd, "sink": snk, "taps": taps}


def wbfm_receiver(fs: float = 1_000_000.0, center_freq: float = 200_000.0,
                  quad_rate_decim: int = 4, audio_decim: tuple[int, int] = (1, 5),
                  deviation: float = 75_000.0, n_samples: int | None = None,
                  source=None, batch_size: int | None = None, sink: str = "vector",
                  deemph_tau: float | None = None, fused: bool = False):
    """Config #1: wideband FM receiver.

    freq_xlating_fir (channel select + decimate to quad rate) ->
    quadrature_demod -> rational_resampler (audio rate)
    [-> fm_deemph when deemph_tau is given, e.g. 75e-6 — the GR wfm_rcv
    shape; off by default so the benchmark chain matches config #1].
    Default rates: 1 MS/s -> 250 kS/s quad -> 50 kS/s audio.

    fused=True runs xlate->demod->resampler as ONE block
    (blocks.analog.wbfm_rcv_fused / ops/wbfm_chain.py), semantically a
    drop-in for the staged graph (matches it to float32 accuracy; needs
    interp-1 resampling). source="live" (with fused=True) makes the test
    tone generator part of that block (blocks.analog.wbfm_live_source);
    batch_size is then still counted in input samples.
    """
    quad_rate = fs / quad_rate_decim
    chan_taps = firdes.low_pass(1.0, fs, 100e3, 30e3)
    interp, decim = audio_decim
    if source == "live" and not fused:
        raise ValueError("source='live' requires fused=True")
    bsz = batch_size
    if source == "live" and batch_size is not None:
        # reference stream = audio items for the live source
        bsz = max(batch_size // (quad_rate_decim * audio_decim[1]), 1)
    fg = Flowgraph("wbfm_receiver", batch_size=bsz)
    if source is None:
        source = analog.sig_source(fs, "complex", frequency=0.0)
    if fused:
        if source == "live":
            fused_blk = analog.wbfm_live_source(
                chan_taps, center_freq, fs, decim=quad_rate_decim,
                deviation=deviation, resamp_interp=interp,
                resamp_decim=decim, frequency=center_freq)
            source = fused_blk
        else:
            fused_blk = analog.wbfm_rcv_fused(
                chan_taps, center_freq, fs, decim=quad_rate_decim,
                deviation=deviation, resamp_interp=interp, resamp_decim=decim)
            fg.connect(source, 0, fused_blk, 0)
        blocks = {"source": source, "fused": fused_blk, "xlate": fused_blk,
                  "demod": fused_blk, "resamp": fused_blk}
        tail = fused_blk
    else:
        xlate = filt.freq_xlating_fir(chan_taps, center_freq, fs, decim=quad_rate_decim)
        demod = analog.quadrature_demod(gain=quad_rate / (2 * np.pi * deviation))
        resamp = filt.rational_resampler(interp, decim, dtype="rf32")  # audio is real
        fg.connect(source, 0, xlate, 0)
        fg.connect(xlate, 0, demod, 0)
        fg.connect(demod, 0, resamp, 0)
        blocks = {"source": source, "xlate": xlate, "demod": demod,
                  "resamp": resamp}
        tail = resamp
    snk = general.vector_sink(dtype="rf32") if sink == "vector" else general.null_sink(dtype="rf32")
    deemph = None
    if deemph_tau is not None:
        audio_rate = quad_rate * interp / decim
        deemph = analog.fm_deemph(audio_rate, tau=deemph_tau)
        fg.connect(tail, 0, deemph, 0)
        tail = deemph
    if n_samples is not None:
        hd = general.head(n_samples, dtype="rf32")
        fg.connect(tail, 0, hd, 0)
        fg.connect(hd, 0, snk, 0)
    else:
        fg.connect(tail, 0, snk, 0)
    return fg, {**blocks, "deemph": deemph, "sink": snk}


def make_fm_demod_hier(quad_rate: float, deviation: float = 75e3,
                       audio_interp: int = 1, audio_decim: int = 5):
    """FM demod as a reusable HierBlock (reference: hier_block composites
    like GR's wfm_rcv): quadrature_demod -> rational_resampler, exported
    as one block with ports in=cf32, out=rf32."""
    import numpy as _np

    from newsched_tpu.runtime.graph import HierBlock

    class FmDemod(HierBlock):
        def __init__(self, name=None):
            super().__init__(name)
            demod = analog.quadrature_demod(gain=quad_rate / (2 * _np.pi * deviation))
            resamp = filt.rational_resampler(audio_interp, audio_decim, dtype="rf32")
            self.graph.connect(demod, 0, resamp, 0)
            self.map_input("in", demod.i())
            self.map_output("out", resamp.o())

    return FmDemod()


def fm_channelizer(nchans: int = 64, fs: float = 100e6, taps_per_arm: int = 16,
                   audio_decim: int = 8, n_samples: int | None = None,
                   source=None, batch_size: int | None = None, sink: str = "null",
                   deviation_frac: float = 0.3, fused: bool = False,
                   precision=jax.lax.Precision.HIGHEST, audio_taps=None):
    """Configs #2/#4: wideband channelizer + per-channel FM demod + per-
    channel audio decimating FIR. The headline benchmark chain.

    Input: one wideband cf32 stream at fs. Output: (nchans,)-vector rf32
    audio stream at fs / nchans / audio_decim.

    fused=True runs the whole chain as one block on the planes-rows stream
    (vector_dsp.fm_channelizer_fused_planes, ops/fm_chain.py): a cf32
    ``source`` gets a cplx_to_planes adapter; with no source, a
    noise_planes_source feeds the chain its native format directly; a
    source with an (2*nchans,)-vector rf32 output port is used as a planes
    source as-is; source="live" is the one-block live flagship
    (vector_dsp.fm_noise_channelizer_source). Semantics are identical in
    every mode: n_samples bounds the OUTPUT stream (audio (nchans,)-vector
    items, the head block's units); batch_size is wideband samples.
    precision is the fused chain's DFT matmul precision.
    """
    chan_rate = fs / nchans
    if fused:
        return _fm_channelizer_fused(nchans, chan_rate, taps_per_arm,
                                     audio_decim, n_samples, source,
                                     batch_size, sink, deviation_frac,
                                     precision, audio_taps)
    fg = Flowgraph("fm_channelizer", batch_size=batch_size)
    if source is None:
        source = analog.noise_source("gaussian", amplitude=0.5)
    pfb = filt.pfb_channelizer(nchans, taps_per_arm=taps_per_arm)
    demod = vector_dsp.vector_quad_demod(nchans, gain=1.0 / (2 * np.pi * deviation_frac))
    if audio_taps is None:
        audio_taps = firdes.low_pass(1.0, chan_rate, 0.4 * chan_rate / audio_decim,
                                     0.1 * chan_rate / audio_decim)
    audio = vector_dsp.vector_fir(nchans, audio_taps, decim=audio_decim, dtype="rf32")
    snk = (general.null_sink(dtype="rf32", vlen=(nchans,)) if sink == "null"
           else general.vector_sink(dtype="rf32", vlen=(nchans,)))
    fg.connect(source, 0, pfb, 0)
    fg.connect(pfb, 0, demod, 0)
    fg.connect(demod, 0, audio, 0)
    if n_samples is not None:
        hd = general.head(n_samples, dtype="rf32", vlen=(nchans,))
        fg.connect(audio, 0, hd, 0)
        fg.connect(hd, 0, snk, 0)
    else:
        fg.connect(audio, 0, snk, 0)
    return fg, {
        "source": source, "pfb": pfb, "demod": demod, "audio": audio, "sink": snk,
        "audio_taps": audio_taps,
    }


def _fm_channelizer_fused(nchans, chan_rate, taps_per_arm, audio_decim,
                          n_samples, source, batch_size, sink,
                          deviation_frac, precision, audio_taps=None):
    if audio_taps is None:
        audio_taps = firdes.low_pass(1.0, chan_rate, 0.4 * chan_rate / audio_decim,
                                     0.1 * chan_rate / audio_decim)
    gain = 1.0 / (2 * np.pi * deviation_frac)
    snk = (general.null_sink(dtype="rf32", vlen=(nchans,)) if sink == "null"
           else general.vector_sink(dtype="rf32", vlen=(nchans,)))
    adapter = None
    if source == "live":
        # the live flagship: position-pure noise (ops/noise.py, seed 0,
        # amplitude 0.5) generated and channelized in one source block
        fused_blk = vector_dsp.fm_noise_channelizer_source(
            nchans, None, audio_taps, audio_decim=audio_decim, gain=gain,
            amplitude=0.5, seed=0, taps_per_arm=taps_per_arm,
            precision=precision)
        source = fused_blk
        bsz = None if batch_size is None else \
            max(batch_size // (nchans * audio_decim), 1)
        fg = Flowgraph("fm_channelizer_live", batch_size=bsz)
    else:
        fused_blk = vector_dsp.fm_channelizer_fused_planes(
            nchans, None, audio_taps, audio_decim=audio_decim, gain=gain,
            taps_per_arm=taps_per_arm, precision=precision)
        if source is None:
            source = vector_dsp.noise_planes_source(nchans, amplitude=0.5)
        planes_native = any(
            p.item_shape == (2 * nchans,) for p in getattr(source, "outputs", []))
        # Planes-native source: the graph's reference item is a ROW (=
        # nchans wideband samples), so scale the requested batch.
        bsz = None
        if batch_size is not None:
            bsz = (max(batch_size // nchans, 1) if planes_native else batch_size)
        fg = Flowgraph("fm_channelizer_fused", batch_size=bsz)
        if planes_native:
            fg.connect(source, 0, fused_blk, 0)
        else:
            adapter = vector_dsp.cplx_to_planes(nchans)
            fg.connect(source, 0, adapter, 0)
            fg.connect(adapter, 0, fused_blk, 0)
    if n_samples is not None:
        hd = general.head(n_samples, dtype="rf32", vlen=(nchans,))
        fg.connect(fused_blk, 0, hd, 0)
        fg.connect(hd, 0, snk, 0)
    else:
        fg.connect(fused_blk, 0, snk, 0)
    return fg, {
        "source": source, "adapter": adapter, "fused": fused_blk, "sink": snk,
        "audio_taps": audio_taps,
    }
