"""Flagship model tests — the BASELINE configs as end-to-end flowgraphs
with SNR gates vs scipy references."""

import numpy as np
import pytest
import scipy.signal as sig

from newsched_tpu.blocks import general
from newsched_tpu.models import fir_chain, fm_channelizer, wbfm_receiver
from tests.test_ops_fir import snr_db


def _fm_modulate(msg: np.ndarray, dev_per_fs: float) -> np.ndarray:
    phase = np.cumsum(2 * np.pi * dev_per_fs * msg)
    return np.exp(1j * phase).astype(np.complex64)


def test_config0_fir_chain_snr_10M():
    """Config #0's gate AS WRITTEN in BASELINE.md: 10M samples through
    sig_source -> 128-tap FIR -> head, SNR-gated vs scipy.lfilter float64
    (round-4 VERDICT item #6 — the previous test asserted finiteness only,
    at 100k samples)."""
    n = 10_000_000
    fg, parts = fir_chain(n_samples=n, batch_size=1 << 20, sink="vector")
    fg.run()
    y = parts["sink"].data()
    assert y.shape == (n,)
    # Golden: float64 tone at the source's EXACT fxpt-NCO frequency (the
    # uint32 phase accumulator quantizes freq to a 2^-32 turn fraction;
    # the ideal-real-frequency tone drifts ~0.007 rad by sample 10M) +
    # scipy.lfilter float64.
    from newsched_tpu.ops import nco

    fs, freq = 1e6, 123_456.0
    dphase = np.uint64(nco.freq_to_dphase(freq, fs))
    acc = (np.arange(n, dtype=np.uint64) * dphase) & np.uint64(0xFFFFFFFF)
    x = np.exp(2j * np.pi * (acc.astype(np.float64) / 2.0 ** 32))
    ref = sig.lfilter(np.asarray(parts["taps"], np.float64), 1.0, x)
    assert snr_db(ref, y.astype(np.complex128)) > 60


def test_config0_fir_chain_runs_small():
    """Fast smoke variant of config #0 (kept for quick iteration)."""
    fg, parts = fir_chain(n_samples=100_000, batch_size=16384, sink="vector")
    fg.run()
    y = parts["sink"].data()
    assert y.shape == (100_000,)
    assert np.all(np.isfinite(y.view(np.float32)))


def test_config1_wbfm_receiver_snr():
    """FM-modulate a tone at a 200 kHz offset carrier; receive; gate SNR.

    The audio chain is 1 MS/s -> decim 4 -> 250 kS/s quad -> resample 1/5
    -> 50 kS/s audio.
    """
    fs = 1_000_000.0
    n = 1 << 19
    t = np.arange(n) / fs
    f_audio = 2000.0
    msg = np.sin(2 * np.pi * f_audio * t).astype(np.float32)
    deviation = 75_000.0
    base = _fm_modulate(msg, deviation / fs)
    # shift to +200 kHz carrier
    x = (base * np.exp(2j * np.pi * 200e3 * t)).astype(np.complex64)

    src = general.vector_source(x)
    fg, parts = wbfm_receiver(fs=fs, center_freq=200e3, quad_rate_decim=4,
                              audio_decim=(1, 5), deviation=deviation,
                              source=src, batch_size=32768)
    fg.run()
    audio = parts["sink"].data()
    audio_fs = fs / 4 / 5
    # reference: the original tone at the audio rate
    ta = np.arange(len(audio)) / audio_fs
    ref = np.sin(2 * np.pi * f_audio * ta)
    # trim filter transients; fit amplitude+phase of the tone (the chain's
    # group delay is a non-integer number of audio samples, so integer-lag
    # alignment would understate SNR)
    skip = 2000
    a = audio[skip:-skip].astype(np.float64)
    tt = ta[skip:-skip]
    s = np.sin(2 * np.pi * f_audio * tt)
    c = np.cos(2 * np.pi * f_audio * tt)
    gs = np.dot(a, s) / np.dot(s, s)
    gc = np.dot(a, c) / np.dot(c, c)
    fit = gs * s + gc * c
    best = snr_db(fit, a)
    amp = float(np.hypot(gs, gc))
    assert abs(amp - 1.0) < 0.05, f"recovered amplitude {amp:.3f}"
    assert best > 50, f"audio SNR {best:.1f} dB"


def test_config2_channelizer_model_runs():
    fg, parts = fm_channelizer(nchans=16, fs=16e6, taps_per_arm=8, audio_decim=4,
                               n_samples=2048, batch_size=65536, sink="vector")
    fg.run()
    audio = parts["sink"].data()
    assert audio.shape == (2048, 16)
    assert np.all(np.isfinite(audio))


def test_noise_planes_source_method_selection_cpu():
    """The default threefry stream has the requested amplitude; the
    position-pure stream needs whole 64-row groups; unknown methods are
    refused."""
    from newsched_tpu.blocks import general, vector_dsp
    from newsched_tpu.runtime.graph import Flowgraph

    src = vector_dsp.noise_planes_source(16, amplitude=2.0, seed=1)
    hd = general.head(1024, dtype="rf32", vlen=(32,))
    snk = general.vector_sink(dtype="rf32", vlen=(32,))
    fg = Flowgraph(batch_size=256)
    fg.connect(src, 0, hd, 0)
    fg.connect(hd, 0, snk, 0)
    fg.run()
    r = snk.data()
    assert r.shape == (1024, 32)
    assert abs(r.std() - 2.0) < 0.05

    with pytest.raises(ValueError, match="threefry/pure"):
        vector_dsp.noise_planes_source(16, method="pallas")
    with pytest.raises(ValueError, match="multiples of"):
        bad = vector_dsp.noise_planes_source(16, method="pure")
        bad.init_state(0, 100)  # not a GROUP_ROWS multiple


def test_fir_chain_live_matches_staged_and_shards():
    """Config #0 as one live source block (fir_tone_source: NCO tone
    generated per batch, its FIR lookback regenerated from the phase).
    Live == staged graph to f32 accuracy; sharded == unsharded; batch
    size does not change the stream; golden float64 gate on the fxpt
    tone ladder."""
    from newsched_tpu.ops import nco
    from newsched_tpu.parallel import make_mesh

    fs, freq, ntaps = 1e6, 123_456.0, 128
    n = 8192 * 4

    def run(src_kind, mesh=None, batch=8192):
        fg, b = fir_chain(n_samples=n, fs=fs, ntaps=ntaps,
                                 frequency=freq, batch_size=batch,
                                 sink="vector", source=src_kind)
        fg.run(mesh=mesh)
        return np.asarray(b["sink"].data()), b["taps"]

    y_live, taps = run("live")
    y_staged, _ = run(None)
    dp = int(nco.freq_to_dphase(freq, fs))
    idx = np.arange(n, dtype=np.uint64)
    ph = 2 * np.pi * (((idx * np.uint64(dp)) & np.uint64(0xFFFFFFFF)
                       ).astype(np.float64) / 2.0 ** 32)
    ref = sig.lfilter(np.asarray(taps, np.float64), [1.0], np.exp(1j * ph))

    def snr(a, b):
        a = np.asarray(a, np.complex128)
        e = a - np.asarray(b, np.complex128)
        p = np.mean(np.abs(a) ** 2)
        m = np.mean(np.abs(e) ** 2)
        return np.inf if m == 0 else 10 * np.log10(p / m)

    assert snr(ref, y_live) > 100
    assert snr(y_staged, y_live) > 100
    y_mesh, _ = run("live", mesh=make_mesh(8))
    assert snr(y_live, y_mesh) > 100
    # batch-split invariance: two 4096-sample batches == one 8192 batch
    y_small, _ = run("live", batch=4096)
    assert np.array_equal(y_live, y_small)
