"""Graph-level multi-device execution (reference: graph_utils::partition +
multi-scheduler, SURVEY.md §3.6 rows 3-4): the SAME flowgraph runs unmodified
on a device mesh via fg.run(mesh=...) — the compiler pins edges to a
time-sharded layout and XLA inserts the halo exchange every tail-stateful
kernel (FIR/PFB/demod history) needs.

Decisive checks, on the simulated 8-device CPU mesh:
  - flagship fm_channelizer matches the single-device run to >100 dB over
    multiple batches (carried state exact across shard boundaries);
  - rate-changing chains (decimating FIR, rational resampler) match;
  - stream tags survive sharded execution with exact offsets (BASELINE
    config #3's gate).
"""

import numpy as np
import pytest

from newsched_tpu import models
from newsched_tpu.blocks import filter as filt, general
from newsched_tpu.ops import firdes
from newsched_tpu.parallel import make_mesh
from newsched_tpu.runtime.graph import Flowgraph
from tests.test_ops_fir import _rand_complex, snr_db


def _run_channelizer(mesh, x, nchans, n_out_items, batch_size):
    src = general.vector_source(x)
    fg, blk = models.fm_channelizer(
        nchans=nchans, taps_per_arm=4, audio_decim=2, n_samples=n_out_items,
        source=src, batch_size=batch_size, sink="vector")
    fg.run(mesh=mesh)
    return blk["sink"].data()


@pytest.mark.parametrize("n_dev", [4, 8])
def test_fm_channelizer_graph_mesh_matches_single(n_dev):
    """VERDICT r1 item 1: models.fm_channelizer() runs unmodified on the
    mesh and matches the single-device run across >= 3 batches."""
    M = 16
    batch = 2048  # 3.5+ batches of the source below
    n_out = (batch // (M * 2)) * 3 + 7  # >3 batches, non-multiple tail
    x = _rand_complex(4 * batch, seed=5)
    ref = _run_channelizer(None, x, M, n_out, batch)
    got = _run_channelizer(make_mesh(n_dev), x, M, n_out, batch)
    assert got.shape == ref.shape
    assert snr_db(ref, got) > 100


def test_fir_chain_graph_mesh(  ):
    """Config #0 chain, decimating FIR variant, sharded vs not."""
    taps = firdes.low_pass(1.0, 1.0, 0.2, 0.05, ntaps=64)
    x = _rand_complex(8192, seed=7)

    def run(mesh):
        fg = Flowgraph(batch_size=2048)
        src = general.vector_source(x)
        fir = filt.fir_filter(taps, decim=4)
        snk = general.vector_sink()
        fg.connect(src, 0, fir, 0)
        fg.connect(fir, 0, snk, 0)
        fg.run(mesh=mesh)
        return snk.data()

    ref = run(None)
    got = run(make_mesh(8))
    assert got.shape == ref.shape
    assert snr_db(ref, got) > 120


def test_wbfm_receiver_graph_mesh():
    """Config #1 (xlate -> quad demod -> rational resampler) under a mesh:
    the resampler's polyphase state and the demod history cross shard
    boundaries exactly."""
    x = _rand_complex(16384, seed=11)

    def run(mesh):
        src = general.vector_source(x)
        fg, blk = models.wbfm_receiver(source=src, n_samples=700,
                                       batch_size=4096)
        fg.run(mesh=mesh)
        return blk["sink"].data()

    ref = run(None)
    got = run(make_mesh(8))
    assert got.shape == ref.shape
    assert snr_db(ref, got) > 100


def test_tags_preserved_under_mesh():
    """BASELINE config #3 gate: stream tags preserved across shard
    boundaries — fft_filter chain with tagged source, sharded run returns
    the identical tag list (exact offsets through the rate change)."""
    taps = firdes.low_pass(1.0, 1.0, 0.2, 0.1, ntaps=33)
    x = _rand_complex(4096, seed=13)
    tag_list = [(0, "start", 1.0), (1000, "burst", 2.5), (3500, "end", 0.0)]

    def run(mesh):
        fg = Flowgraph(batch_size=1024)
        src = general.vector_source(x, tags=tag_list)
        f = filt.fft_filter(taps, decim=2)
        snk = general.vector_sink()
        fg.connect(src, 0, f, 0)
        fg.connect(f, 0, snk, 0)
        fg.run(mesh=mesh)
        return snk.data(), snk.tags()

    ref_d, ref_t = run(None)
    got_d, got_t = run(make_mesh(8))
    assert snr_db(ref_d, got_d) > 120
    assert [(t.offset, t.key) for t in got_t] == [(t.offset, t.key) for t in ref_t]
    assert [(t.offset, t.key) for t in got_t] == [(0, "start"), (500, "burst"),
                                                  (1750, "end")]


def test_mesh_run_is_actually_sharded():
    """Guard against the constraint silently not applying: compile the step
    with an 8-device mesh and check the jitted output sharding is split
    over the time axis."""
    import jax

    from newsched_tpu.runtime.compile import compile_flowgraph
    from newsched_tpu.utils import cplx

    mesh = make_mesh(8)
    fg = Flowgraph(batch_size=1024)
    src = general.vector_source(_rand_complex(4096, seed=3))
    fir = filt.fir_filter(firdes.low_pass(1.0, 1.0, 0.2, 0.1, ntaps=17))
    snk = general.vector_sink()
    fg.connect(src, 0, fir, 0)
    fg.connect(fir, 0, snk, 0)
    cfg = compile_flowgraph(fg, batch_size=1024, mesh=mesh)

    def step_enc(s, p):
        ns, so = cfg.step(cplx.decode(s), cplx.decode(p))
        return cplx.encode(ns), cplx.encode(so)

    states = jax.jit(lambda: cplx.encode(cfg.init_states()))()
    _, sink_out = jax.jit(step_enc)(states, cplx.encode(cfg.init_params()))
    leaf = jax.tree_util.tree_leaves(sink_out)[0]
    # 8 distinct single-device shards along the leading axis
    assert len({s.device for s in leaf.addressable_shards}) == 8
    assert leaf.addressable_shards[0].data.shape[0] == leaf.shape[0] // 8


def _run_fused_graph(mesh, rows, nchans, n_out_items, batch_rows):
    ataps = firdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=17)
    src = general.vector_source(rows, dtype="rf32", vlen=(2 * nchans,))
    fg, blk = models.fm_channelizer(
        nchans=nchans, taps_per_arm=8, audio_decim=4, n_samples=n_out_items,
        source=src, batch_size=batch_rows * nchans, sink="vector",
        fused=True, audio_taps=ataps)
    fg.run(mesh=mesh)
    return blk["sink"].data()


@pytest.mark.parametrize("n_dev", [4, 8])
def test_fused_model_graph_mesh_matches_single(n_dev):
    """The FUSED flagship model compiles sharded THROUGH THE GRAPH
    (compile.py work_sharded hook -> the chain per time shard after a
    ppermute halo of input rows) and matches the single-device fused run
    across multiple batches."""
    from newsched_tpu.parallel.channelizer import planes_rows

    M, decim = 16, 4
    batch_rows = n_dev * 64           # rows per batch (row = M samples)
    n_batches = 3
    x = _rand_complex(batch_rows * M * n_batches, seed=11)
    rows = planes_rows(x, M)
    n_out = batch_rows // decim * n_batches
    ref = _run_fused_graph(None, rows, M, n_out, batch_rows)
    got = _run_fused_graph(make_mesh(n_dev), rows, M, n_out, batch_rows)
    assert got.shape == ref.shape
    assert snr_db(ref, got) > 100


def _run_live_fm(mesh, nchans, decim, nout_items, n_batches):
    fg, blk = models.fm_channelizer(
        nchans=nchans, taps_per_arm=4, audio_decim=decim,
        n_samples=nout_items * n_batches, source="live",
        batch_size=nout_items * decim * nchans, sink="vector", fused=True)
    fg.run(mesh=mesh)
    return blk["sink"].data()


@pytest.mark.parametrize("n_dev", [4, 8])
def test_live_fm_source_graph_mesh_matches_single(n_dev):
    """The LIVE flagship shards: the position-pure noise stream
    (ops/noise.py pure_rows) lets each device generate its own group range
    and regenerate its input history, zero collectives. Sharded must
    equal unsharded across MULTIPLE batches (group counter advance +
    first-batch pre-stream masking both covered)."""
    M, decim = 16, 2
    nout = n_dev * 64  # audio items/batch -> n_loc = 128 rows/device at 8
    ref = _run_live_fm(None, M, decim, nout, 3)
    got = _run_live_fm(make_mesh(n_dev), M, decim, nout, 3)
    assert got.shape == ref.shape
    assert snr_db(ref, got) > 100


def test_live_fm_source_vs_float64_golden_sharded():
    """The sharded live stream isn't just self-consistent: regenerate the
    pure rows host-side and push them through the float64 numpy reference
    chain — the sharded graph output must sit >100 dB against it."""
    import jax.numpy as jnp

    from newsched_tpu.blocks import vector_dsp
    from newsched_tpu.ops import pfb as pfb_ops
    from newsched_tpu.ops.noise import pure_rows
    from scipy import signal as sp_sig

    M, decim, nout = 16, 2, 512
    got = _run_live_fm(make_mesh(8), M, decim, nout, 2)
    # regenerate the stream (position-pure: groups 0..) and run float64 ref
    n_rows = nout * decim * 2
    rows = np.asarray(pure_rows(0, jnp.zeros((), jnp.int32),
                                jnp.zeros((), jnp.int32), n_rows, 2 * M),
                      np.float64) * 0.5
    x = (rows[:, :M] + 1j * rows[:, M:])  # row k = x[kM-(M-1)..kM]
    from newsched_tpu.ops import firdes
    taps = firdes.prototype_channelizer_taps(M, 4)
    arm = np.asarray(pfb_ops.pfb_arm_taps(np.asarray(taps, np.float64), M))
    L = arm.shape[1]
    # channelizer on the skewed-V rows: y[k] = DFT(fold of rows k-L+1..k)
    Vfull = np.concatenate([np.zeros((L - 1, M)), x], axis=0)
    c = arm[::-1, ::-1].T  # (L, M)
    acc = np.zeros((n_rows, M), complex)
    for q in range(L):
        acc += c[q][None, :] * Vfull[q: q + n_rows]
    k = np.arange(M)
    W = np.exp(-2j * np.pi * np.outer(k, k) / M) * np.exp(-2j * np.pi * k / M)[None, :]
    Y = acc @ W
    prev = np.concatenate([np.zeros((1, M)), Y[:-1]], axis=0)
    p = np.conj(prev) * Y
    dev_gain = 1.0 / (2 * np.pi * 0.3)
    aud = np.where((prev == 0) | (Y == 0), 0.0,
                   np.arctan2(p.imag, p.real)) * dev_gain
    ataps = np.asarray(models.fm_channelizer(nchans=M, taps_per_arm=4,
                                             audio_decim=decim,
                                             fused=True,
                                             source="live")[1]["audio_taps"],
                       np.float64)
    ref = np.stack([sp_sig.lfilter(ataps, [1.0], aud[:, ch])[::decim]
                    for ch in range(M)], axis=1)
    assert snr_db(ref[: got.shape[0]], got) > 100


def _run_live_wbfm(mesh, n_samples, batch):
    fg, blk = models.wbfm_receiver(
        fs=1e6, center_freq=0.21e6, quad_rate_decim=4, audio_decim=(1, 5),
        n_samples=n_samples, source="live", batch_size=batch, sink="vector",
        fused=True)
    fg.run(mesh=mesh)
    return blk["sink"].data()


def test_live_wbfm_source_graph_mesh_matches_single():
    """The wbfm twin of the live sharding: every window of the live chain
    is a pure function of the phase counter, so XLA's SPMD partitioner
    splits the generation by time. Sharded == unsharded across 2
    batches."""
    batch = 8 * 64 * 160 * 20
    n_samples = 2 * batch // 20
    ref = _run_live_wbfm(None, n_samples, batch)
    got = _run_live_wbfm(make_mesh(8), n_samples, batch)
    assert got.shape == ref.shape
    assert snr_db(ref, got) > 100


def test_live_fm_source_rejects_unsplittable_mesh():
    """A batch whose noise groups do not split over the mesh raises a
    framework error naming the block, not an XLA error."""
    from newsched_tpu.blocks import vector_dsp

    ataps = firdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=17)
    src = vector_dsp.fm_noise_channelizer_source(
        16, None, ataps, audio_decim=2, taps_per_arm=4)
    snk = general.vector_sink(dtype="rf32", vlen=(16,))
    fg = Flowgraph(batch_size=96)  # 192 rows = 3 groups over 8 devices
    fg.connect(src, 0, snk, 0)
    with pytest.raises(ValueError, match="do not split"):
        fg.run(mesh=make_mesh(8), total_items=96)


def test_live_fm_sharded_geometry_errors():
    """Batches that are not whole noise groups die at compile time with
    an actionable message."""
    from newsched_tpu.blocks import vector_dsp

    ataps = firdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=17)
    src = vector_dsp.fm_noise_channelizer_source(
        16, None, ataps, audio_decim=2, taps_per_arm=4)
    with pytest.raises(ValueError, match="multiple"):
        src.init_state(0, 36)  # 72 rows: not whole 64-row groups


def test_noise_planes_source_pure_batch_invariant_and_shards():
    """noise_planes_source(method='pure') — the position-pure stream:
    batch-size-invariant (unlike threefry key-chaining) and partitions
    cleanly under fg.run(mesh=...)."""
    from newsched_tpu.blocks import vector_dsp

    M = 16

    def run(batch_rows, mesh=None):
        src = vector_dsp.noise_planes_source(M, amplitude=0.5, seed=9,
                                             method="pure")
        hd = general.head(256, dtype="rf32", vlen=(2 * M,))
        snk = general.vector_sink(dtype="rf32", vlen=(2 * M,))
        fg = Flowgraph(batch_size=batch_rows)
        fg.connect(src, 0, hd, 0)
        fg.connect(hd, 0, snk, 0)
        fg.run(mesh=mesh)
        return np.asarray(snk.data())

    a = run(256)
    b = run(64)   # different batch split: SAME stream (position-pure)
    assert np.array_equal(a, b)
    c = run(256, mesh=make_mesh(8))
    assert np.array_equal(a, c)
