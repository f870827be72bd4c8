"""The one-block wbfm receive chain (ops/wbfm_chain.py): the chain vs a
float64 staged-semantics golden, the flowgraph twin test vs the staged
blocks, the sharded graph path on the CPU sim mesh, and the
recompile-fence retune. Compiled GPU runs are in tests_gpu/."""

import numpy as np
import pytest
import scipy.signal as sig

import jax
import jax.numpy as jnp

from newsched_tpu import models
from newsched_tpu.blocks import general
from newsched_tpu.ops import firdes, nco


def golden_chain(x, c, dphase, D, rt, Rd, gain):
    """Float64 staged-semantics golden: fxpt-NCO rotate -> lfilter decim ->
    quadrature demod (zero-pinned) -> lfilter decim."""
    idx = np.arange(len(x), dtype=np.uint64)
    acc = (idx * np.uint64(dphase)) & np.uint64(0xFFFFFFFF)
    ph = 2 * np.pi * (acc.astype(np.float64) / 2.0 ** 32)
    xr = x.astype(np.complex128) * np.exp(-1j * ph)
    u = sig.lfilter(np.asarray(c, np.complex128), 1.0, xr)[::D]
    up = np.concatenate([[0.0], u[:-1]])
    p = np.conj(up) * u
    d = np.where((up == 0) | (u == 0), 0.0, np.angle(p)) * gain
    return sig.lfilter(np.asarray(rt, np.float64), 1.0, d)[::Rd]


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64).ravel()
    err = ref - np.asarray(test, np.float64).ravel()
    e = np.mean(err ** 2)
    return np.inf if e == 0 else 10 * np.log10(np.mean(ref ** 2) / e)


def _small_cfg():
    ntaps, A, D, Rd = 25, 15, 4, 5
    c = sig.firwin(ntaps, 0.2)
    rt = sig.firwin(A, 0.15)
    dphase = int(round(0.21 * 2 ** 32)) & 0xFFFFFFFF
    return c, rt, dphase, D, Rd, 0.7


def _stream(x, plan, split):
    """Run wbfm_chain over x in batches of the given sizes, carrying the
    input history between them."""
    from newsched_tpu.ops.wbfm_chain import wbfm_chain

    hist = jnp.zeros((plan.history,), jnp.complex64)
    outs, pos = [], 0
    for k in split:
        ext = jnp.concatenate([hist, jnp.asarray(x[pos:pos + k])])
        outs.append(np.asarray(wbfm_chain(ext, plan)))
        hist = ext[-plan.history:]
        pos += k
    return np.concatenate(outs)


def test_wbfm_kernel_streaming_matches_golden_interpret():
    """3 streamed batches through the chain (history-only state) match
    the infinite-stream float64 golden everywhere."""
    from newsched_tpu.ops.wbfm_chain import WbfmChainPlan

    c, rt, dphase, D, Rd, gain = _small_cfg()
    plan = WbfmChainPlan(c, dphase, D, rt, Rd, gain)
    rng = np.random.default_rng(0)
    n = 64 * 160
    x = (rng.standard_normal(3 * n)
         + 1j * rng.standard_normal(3 * n)).astype(np.complex64)
    ref = golden_chain(x, c, dphase, D, rt, Rd, gain)
    got = _stream(x, plan, [n] * 3)
    assert got.shape == ref.shape
    assert snr_db(ref, got) > 100


def test_wbfm_fused_model_matches_staged_graph():
    """models.wbfm_receiver(fused=True) through the flowgraph matches the
    staged 3-block graph on an FM signal (config #1 parameters)."""
    fs = 1e6
    n = 2 * 40960  # two batches; R=640 >= B8=568 for the real taps
    t = np.arange(n) / fs
    msg = np.sin(2 * np.pi * 2000.0 * t)
    ph = np.cumsum(2 * np.pi * (75e3 / fs) * msg)
    x = (np.exp(1j * ph) * np.exp(2j * np.pi * 200e3 * t)).astype(np.complex64)

    def run(fused):
        src = general.vector_source(x)
        fg, parts = models.wbfm_receiver(
            fs=fs, center_freq=200e3, quad_rate_decim=4, audio_decim=(1, 5),
            deviation=75e3, source=src, batch_size=40960, fused=fused)
        fg.run()
        return parts["sink"].data()

    a, b = run(False), run(True)
    assert a.shape == b.shape
    assert snr_db(a, b) > 100


def test_wbfm_fused_sharded_graph_matches_unsharded():
    """fg.run(mesh=...) shards the one-block wbfm chain through XLA's SPMD
    partitioner (its state is raw input samples, like any FIR) and
    matches the unsharded run."""
    from newsched_tpu.blocks import analog
    from newsched_tpu.parallel.mesh import make_mesh
    from newsched_tpu.runtime.graph import Flowgraph

    if len(jax.devices()) < 4:
        pytest.skip("needs the simulated multi-device CPU mesh")
    c, rt, dphase, D, Rd, gain = _small_cfg()
    nd = 4
    n = nd * 64 * 160
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(n)
         + 1j * rng.standard_normal(n)).astype(np.complex64)

    def run(mesh):
        src = general.vector_source(x)
        blk = analog.wbfm_rcv_fused(
            c, center_freq=0.21 * 1e6, fs=1e6, decim=D, deviation=75e3,
            resamp_decim=Rd, resamp_taps=rt)
        hd = general.head(n // (D * Rd), dtype="rf32")
        snk = general.vector_sink(dtype="rf32")
        fg = Flowgraph(batch_size=n)
        fg.connect(src, 0, blk, 0)
        fg.connect(hd, 0, snk, 0)
        fg.connect(blk, 0, hd, 0)
        fg.run(mesh=mesh)
        return snk.data()

    a = run(None)
    b = run(make_mesh(n_devices=nd))
    assert a.shape == b.shape
    assert snr_db(a, b) > 120


def test_wbfm_fused_rejects_bad_configs():
    from newsched_tpu.blocks import analog

    with pytest.raises(NotImplementedError, match="resamp_interp=1"):
        analog.wbfm_rcv_fused(np.ones(9), 0.0, 1e6, resamp_interp=2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wbfm_fused_batch_split_property(seed):
    """The chain's state is its input history, so random batch partitions
    of the same stream produce the same audio."""
    from newsched_tpu.ops.wbfm_chain import WbfmChainPlan

    c, rt, dphase, D, Rd, gain = _small_cfg()
    plan = WbfmChainPlan(c, dphase, D, rt, Rd, gain)
    rng = np.random.default_rng(100 + seed)
    unit = D * Rd * 16
    n_units = 12
    x = (rng.standard_normal(n_units * unit)
         + 1j * rng.standard_normal(n_units * unit)).astype(np.complex64)
    split = []
    left = n_units
    while left:
        k = int(rng.integers(1, min(left, 5) + 1))
        split.append(k * unit)
        left -= k
    a = _stream(x, plan, [n_units * unit])
    b = _stream(x, plan, split)
    # the same arithmetic on differently-sized batches: float32 resolution
    np.testing.assert_allclose(a, b, atol=2e-6, rtol=0), split
    assert snr_db(a, b) > 110


def test_wbfm_live_source_matches_golden_interpret():
    """The one-block LIVE wbfm source (fxpt-NCO tone generated per batch,
    its history regenerated from the phase) matches the float64
    staged-semantics golden across streamed batches."""
    from newsched_tpu.blocks import analog
    from newsched_tpu.runtime.graph import Flowgraph

    c, rt, dphase_c, D, Rd, gain = _small_cfg()
    fs = 1e6
    center = 0.21 * fs
    tone = center + 0.02 * fs  # inside the passband, nonzero audio
    n = 3 * 64 * 160
    src = analog.wbfm_live_source(c, center, fs, decim=D, deviation=75e3,
                                  resamp_decim=Rd, resamp_taps=rt,
                                  frequency=tone, amplitude=0.8)
    hd = general.head(n // (D * Rd), dtype="rf32")
    snk = general.vector_sink(dtype="rf32")
    fg = Flowgraph(batch_size=64 * 160 // (D * Rd))
    fg.connect(src, 0, hd, 0)
    fg.connect(hd, 0, snk, 0)
    fg.run()
    a = snk.data()

    # golden: the same fxpt tone through the staged float64 chain
    dphase_t = np.uint64(nco.freq_to_dphase(tone, fs))
    acc = (np.arange(n, dtype=np.uint64) * dphase_t) & np.uint64(0xFFFFFFFF)
    ph = 2 * np.pi * (acc.astype(np.float64) / 2.0 ** 32)
    x = 0.8 * np.exp(1j * ph)
    gain_real = (fs / D) / (2 * np.pi * 75e3)
    ref = golden_chain(x, c, int(nco.freq_to_dphase(center, fs)), D, rt, Rd,
                       gain_real)
    assert a.shape == ref[: len(a)].shape
    assert snr_db(ref[: len(a)], a) > 100


def _fm_tone(n, fs, f):
    t = np.arange(n) / fs
    return np.exp(2j * np.pi * f * t).astype(np.complex64)


def test_wbfm_fused_recompile_fence_retune_local():
    """VERDICT r4 item #5: center_freq is a RECOMPILE-FENCE parameter —
    set_param on a RUNNING fused wbfm rebuilds the rotated-taps plan and
    the runner retraces at a batch boundary; the output re-locks to the
    new tuning (junction state is raw input rows, so no glitch machinery
    is needed)."""
    import time

    fs, dev = 1e6, 75e3
    f_tone = 231_250.0
    batch = 61440
    n_batches = 16
    n = batch * n_batches
    x = _fm_tone(batch * 4, fs, f_tone)

    from newsched_tpu.blocks import analog
    from newsched_tpu.runtime.graph import Flowgraph

    src = general.vector_source(x, repeat=True)
    thr = general.throttle(n / 1.2)  # ~1.2 s run: time to poke it
    blk = analog.wbfm_rcv_fused(
        firdes.low_pass(1.0, fs, 100e3, 30e3), center_freq=200e3, fs=fs,
        decim=4, deviation=dev, resamp_decim=5)
    hd = general.head(n // 20, dtype="rf32")
    snk = general.vector_sink(dtype="rf32")
    fg = Flowgraph(batch_size=batch)
    fg.connect(src, 0, thr, 0)
    fg.connect(thr, 0, blk, 0)
    fg.connect(blk, 0, hd, 0)
    fg.connect(hd, 0, snk, 0)
    fg.validate()
    runner = fg.start(collect_stats=True)
    # trigger on actual stream progress, not wall time (first-batch
    # compile time would otherwise eat the whole throttle budget)
    t0 = time.monotonic()
    while runner.stats["batches"] < n_batches // 3:
        time.sleep(0.01)
        assert time.monotonic() - t0 < 60
    blk.set_param("center_freq", 250e3)
    fg.wait()
    got = np.asarray(snk.data())
    a1 = (f_tone - 200e3) / dev   # 0.4167 audio constant before retune
    a2 = (f_tone - 250e3) / dev   # -0.25 after
    near1 = np.abs(got - a1) < 5e-3
    near2 = np.abs(got - a2) < 5e-3
    # both tunings present, settled, with one clean switch: everything
    # before the first a2-lock is a1 (modulo the short filter settle)
    assert near1.sum() > len(got) // 10, near1.sum()
    assert near2.sum() > len(got) // 10, near2.sum()
    sw = np.argmax(near2)
    assert sw > 512, sw             # a real pre-retune region exists
    assert near1[256: sw - 64].all()  # pre-switch solidly at a1 (skip
    assert near2[sw:].all()           # the stream-start filter settle)


def test_wbfm_fused_retune_over_control_socket():
    """The same retune END-TO-END over the round-4 control plane: a
    RuntimeClient sets center_freq on a fused wbfm running in another
    partition; the stream re-locks (SURVEY §4.4 RPC path + §8 fence)."""
    import time

    from newsched_tpu.runtime.control import RuntimeClient
    from newsched_tpu.runtime.distributed import (Runtime,
                                                  partition_flowgraph)
    from newsched_tpu.runtime.graph import Flowgraph

    fs, dev = 1e6, 75e3
    f_tone = 231_250.0
    batch = 61440
    n = batch * 16
    x = _fm_tone(batch * 4, fs, f_tone)
    from newsched_tpu.blocks import analog

    fg = Flowgraph(batch_size=batch)
    src = general.vector_source(x, repeat=True)
    thr = general.throttle(n / 1.2)
    blk = analog.wbfm_rcv_fused(
        firdes.low_pass(1.0, fs, 100e3, 30e3), center_freq=200e3, fs=fs,
        decim=4, deviation=dev, resamp_decim=5)
    snk = general.vector_sink(dtype="rf32")
    hd = general.head(n // 20, dtype="rf32")
    fg.connect(src, 0, thr, 0)
    fg.connect(thr, 0, blk, 0)
    fg.connect(blk, 0, hd, 0)
    fg.connect(hd, 0, snk, 0)
    pieces = partition_flowgraph(fg, {"dsp": [src, thr, blk, hd],
                                      "collect": [snk]})
    addr = "ipc:///tmp/nst_wbfm_retune.ipc"
    rt = Runtime(pieces, total_items={"dsp": n, "collect": n // 20},
                 control_addresses={"dsp": addr})
    rt.start()
    ctl = RuntimeClient(addr)
    ctl.ping()
    time.sleep(1.0)  # past first-batch compile + a few throttled batches
    assert float(ctl.get_param(blk.name, "center_freq")) == 200e3
    ctl.set_param(blk.name, "center_freq", 250e3)
    rt.wait()
    ctl.close()
    got = np.asarray(snk.data())
    a1 = (f_tone - 200e3) / dev
    a2 = (f_tone - 250e3) / dev
    near1 = np.abs(got - a1) < 5e-3
    near2 = np.abs(got - a2) < 5e-3
    assert near1.sum() > len(got) // 20, near1.sum()
    assert near2.sum() > len(got) // 20, near2.sum()
    sw = np.argmax(near2)
    assert sw > 512, sw
    assert near1[256: sw - 64].all() and near2[sw:].all()


@pytest.mark.parametrize("center", [0.0, 0.21e6, -0.3e6])
def test_wbfm_chain_tunes_like_staged_rotator(center):
    """The rotated taps and the constant demod rotation stand in exactly
    for the staged fxpt-NCO rotator, at zero, positive and negative
    center frequencies."""
    from newsched_tpu.ops.wbfm_chain import WbfmChainPlan

    c, rt, _, D, Rd, gain = _small_cfg()
    dphase = int(nco.freq_to_dphase(center, 1e6))
    plan = WbfmChainPlan(c, dphase, D, rt, Rd, gain)
    rng = np.random.default_rng(3)
    n = 2 * 64 * D * Rd
    x = (rng.standard_normal(n)
         + 1j * rng.standard_normal(n)).astype(np.complex64)
    ref = golden_chain(x, c, dphase, D, rt, Rd, gain)
    got = _stream(x, plan, [n // 2, n // 2])
    assert snr_db(ref, got) > 100
