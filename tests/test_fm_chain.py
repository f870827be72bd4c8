"""The FM channelizer chain on planes rows (ops/fm_chain.py): the plain
chain against the float64 golden, its history-only streaming state, and
the fused block against the staged blocks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from newsched_tpu.ops import firdes
from newsched_tpu.ops.fm_chain import (fm_chain_rows, history_rows,
                                       planes_dft_matrix)
from newsched_tpu.ops.pfb import pfb_arm_taps


def _snr(ref, got):
    ref = np.asarray(ref, np.float64)
    e = np.mean((ref - np.asarray(got, np.float64)) ** 2)
    return np.inf if e == 0 else 10 * np.log10(np.mean(ref ** 2) / e)


def _flagship(A=65):
    import bench

    taps = firdes.prototype_channelizer_taps(64, 16)
    ataps = firdes.low_pass(1.0, 1.0, 0.4 / 8, 0.1 / 8, ntaps=A)
    arm = pfb_arm_taps(taps.astype(np.float32), 64)
    return bench, taps, ataps, arm[::-1, ::-1].T.copy()


def _rows(n, seed=0, M=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 2 * M)) * 0.5).astype(np.float32)


def _with_history(rows, L, A):
    return jnp.concatenate([jnp.zeros((history_rows(L, A), rows.shape[1])),
                            jnp.asarray(rows)])


@pytest.mark.parametrize("precision", ["split3", jax.lax.Precision.HIGHEST])
def test_fm_chain_rows_matches_float64_golden(precision):
    bench, taps, ataps, c = _flagship()
    rows = _rows(2048)
    ref, bad = bench.rows_reference(rows, taps, ataps, return_risk=True)
    got = np.asarray(fm_chain_rows(_with_history(rows, 16, 65), c, ataps, 8,
                                   bench.DEMOD_GAIN, precision))
    assert got.shape == ref.shape == (256, 64)
    assert _snr(ref[~bad], got[~bad]) > 100


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fm_chain_history_state_is_batch_split_invariant(seed):
    """The chain's only state is its input-row history: random batch
    partitions of one stream give the same audio as one batch."""
    _, _, ataps, c = _flagship()
    rng = np.random.default_rng(seed)
    unit, n_units = 96, 12  # rows; 96 > history_rows(16, 65) = 80
    rows = _rows(unit * n_units, seed)
    h = history_rows(16, 65)
    split, left = [], n_units
    while left:
        k = int(rng.integers(1, min(left, 5) + 1))
        split.append(k * unit)
        left -= k

    def run(sizes):
        carry = jnp.zeros((h, 128), jnp.float32)
        outs, pos = [], 0
        for k in sizes:
            ext = jnp.concatenate([carry, jnp.asarray(rows[pos:pos + k])])
            outs.append(np.asarray(fm_chain_rows(ext, c, ataps, 8, 0.5)))
            carry = ext[-h:]
            pos += k
        return np.concatenate(outs)

    a, b = run([unit * n_units]), run(split)
    np.testing.assert_allclose(a, b, atol=2e-5, rtol=0), split


def test_history_rows_counts_each_stage():
    # fold L-1, demod 1, audio A-1
    assert history_rows(16, 65) == 15 + 1 + 64
    assert history_rows(1, 1) == 1


def test_fm_chain_rejects_partial_audio_batches():
    _, _, ataps, c = _flagship()
    with pytest.raises(ValueError, match="multiple of the audio decimation"):
        fm_chain_rows(_with_history(_rows(100), 16, 65), c, ataps, 8, 0.5)


def test_planes_dft_matrix_is_the_pfb_phase_combine():
    """[ar | ai] @ W2 equals the FFT-with-twiddle combine of ops/pfb.py."""
    from newsched_tpu.ops.pfb import _phase_combine

    M = 16
    rng = np.random.default_rng(4)
    acc = (rng.standard_normal((8, M)) + 1j * rng.standard_normal((8, M))
           ).astype(np.complex64)
    y = np.concatenate([acc.real, acc.imag], axis=1) @ planes_dft_matrix(M)
    ref = np.asarray(_phase_combine(jnp.asarray(acc), M, "fft"))
    np.testing.assert_allclose(y[:, :M] + 1j * y[:, M:], ref, atol=1e-4)


def test_fused_block_in_graph_matches_staged_blocks():
    """cplx_to_planes -> fm_channelizer_fused_planes must match the staged
    pfb -> vector_quad_demod -> vector_fir flowgraph over several
    batches."""
    from newsched_tpu import Flowgraph
    from newsched_tpu.blocks import filter as filt, general, vector_dsp

    M, L, decim = 64, 8, 4
    n_items = 64 * 64
    taps = firdes.prototype_channelizer_taps(M, L)
    ataps = firdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=33)
    rng = np.random.default_rng(9)
    x = (rng.standard_normal(n_items) + 1j * rng.standard_normal(n_items)
         ).astype(np.complex64)

    def staged():
        fg = Flowgraph(batch_size=2048)
        src = general.vector_source(x)
        pfb = filt.pfb_channelizer(M, taps=taps)
        dem = vector_dsp.vector_quad_demod(M, gain=0.9)
        fir = vector_dsp.vector_fir(M, ataps, decim=decim, dtype="rf32")
        snk = general.vector_sink(dtype="rf32", vlen=(M,))
        for a, b in [(src, pfb), (pfb, dem), (dem, fir), (fir, snk)]:
            fg.connect(a, 0, b, 0)
        fg.run()
        return snk.data()

    def fused():
        fg = Flowgraph(batch_size=2048)
        src = general.vector_source(x)
        adapt = vector_dsp.cplx_to_planes(M)
        blk = vector_dsp.fm_channelizer_fused_planes(M, taps, ataps,
                                                     audio_decim=decim,
                                                     gain=0.9)
        snk = general.vector_sink(dtype="rf32", vlen=(M,))
        for a, b in [(src, adapt), (adapt, blk), (blk, snk)]:
            fg.connect(a, 0, b, 0)
        fg.run()
        return snk.data()

    a, b = staged(), fused()
    assert a.shape == b.shape
    # the same math up to the DFT formulation (FFT vs matmul)
    assert np.abs(a - b).max() < 5e-4


def test_fused_block_state_is_the_input_history():
    from newsched_tpu.blocks import vector_dsp

    ataps = firdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=33)
    blk = vector_dsp.fm_channelizer_fused_planes(16, None, ataps,
                                                 audio_decim=4,
                                                 taps_per_arm=8)
    st = blk.init_state(256, 64)
    assert set(st) == {"carry"}
    assert st["carry"].shape == (history_rows(8, 33), 32)
    x = jnp.asarray(_rows(256, 1, M=16))
    st2, out = blk.work(st, {"in": x}, {}, 64)
    assert out["out"].shape == (64, 16)
    np.testing.assert_array_equal(np.asarray(st2["carry"]),
                                  np.asarray(x[-history_rows(8, 33):]))
