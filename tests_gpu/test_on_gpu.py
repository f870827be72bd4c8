"""Compiled-on-the-card checks of what the CPU suite cannot see: the
precision the GPU's matmuls really run at, and the chains' streaming
contracts at realistic widths as XLA compiles them for the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from newsched_tpu.ops import fir as fir_ops, firdes


def _snr(ref, got):
    ref = np.asarray(ref)
    e = np.mean(np.abs(ref - np.asarray(got)) ** 2)
    return np.inf if e == 0 else 10 * np.log10(np.mean(np.abs(ref) ** 2) / e)


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((4096, 128)).astype(np.float32),
            rng.standard_normal((128, 128)).astype(np.float32))


@pytest.mark.parametrize("name,floor", [
    ("split3", 85.0),        # 3-pass bf16: ~2^-16 relative per product
    ("highest", 120.0),      # float32
])
def test_matmul_precision_on_the_card(operands, name, floor):
    """The named precisions hold on the card. A hand-written bf16 hi/lo
    split does not: XLA's GPU compiler removes its f32->bf16->f32 round
    trip and leaves one bf16 pass (about 50 dB)."""
    from newsched_tpu.ops.fm_chain import matmul

    a, b = operands
    prec = "split3" if name == "split3" else jax.lax.Precision.HIGHEST
    got = np.asarray(jax.jit(lambda a, b: matmul(a, b, prec))(a, b))
    ref = a.astype(np.float64) @ b.astype(np.float64)
    assert _snr(ref, got) > floor


def test_fm_chain_history_state_on_the_card():
    """The flagship chain at full width (64 channels, 2^21-sample batch),
    streamed as one batch and as four: the history-only state gives the
    same audio, and it matches the float64 golden."""
    import bench
    from newsched_tpu.ops.fm_chain import fm_chain_rows, history_rows
    from newsched_tpu.ops.pfb import pfb_arm_taps

    taps, ataps = bench._design()
    arm = pfb_arm_taps(taps.astype(np.float32), 64)
    c = arm[::-1, ::-1].T.copy()
    h = history_rows(c.shape[0], len(ataps))
    rows = (np.random.default_rng(1).standard_normal((32768, 128)) * 0.5
            ).astype(np.float32)
    ext = jnp.concatenate([jnp.zeros((h, 128)), jnp.asarray(rows)])
    chain = jax.jit(lambda r: fm_chain_rows(r, c, ataps, 8, bench.DEMOD_GAIN))
    one = np.asarray(chain(ext))
    quarters = np.concatenate([np.asarray(chain(ext[q * 8192:q * 8192 + h + 8192]))
                               for q in range(4)])
    ref, bad = bench.rows_reference(rows, taps, ataps, return_risk=True)
    assert _snr(ref[~bad], one[~bad]) > 90
    assert _snr(one[~bad], quarters[~bad]) > 100


def test_fft_filter_1024_taps_on_the_card():
    """Config #3's filter on cuFFT: a 1024-tap overlap-save FIR over a
    2^21-sample batch matches scipy."""
    import scipy.signal as sig

    rng = np.random.default_rng(2)
    taps = firdes.low_pass(1.0, 1.0, 0.1, 0.02, ntaps=1024).astype(np.float32)
    n = 1 << 21
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    st = fir_ops.fir_init_state(1024, dtype=jnp.complex64)
    _, y = jax.jit(lambda x: fir_ops.fir_filter(taps, st, x, method="fft"))(x)
    ref = sig.lfilter(taps.astype(np.float64), 1.0, x.astype(np.complex128))
    assert _snr(ref, np.asarray(y)) > 100


def test_pure_noise_stream_is_position_pure_on_the_card():
    """The live sources' stream: a span generated in one call equals the
    same span generated as two calls from their absolute groups."""
    from newsched_tpu.ops.noise import GROUP_ROWS, advance_groups, pure_rows

    z = jnp.zeros((), jnp.int32)
    whole = np.asarray(pure_rows(3, z, z, 8 * GROUP_ROWS, 128))
    hi, lo = advance_groups(z, z, 5)
    tail = np.asarray(pure_rows(3, hi, lo, 3 * GROUP_ROWS, 128))
    np.testing.assert_array_equal(whole[5 * GROUP_ROWS:], tail)
    assert abs(whole.std() - 1.0) < 0.02


def test_wbfm_fused_matches_staged_on_the_card():
    """The one-block wbfm chain equals the staged blocks, compiled."""
    from newsched_tpu import models
    from newsched_tpu.blocks import general

    fs, n = 1e6, 4 * 102400
    t = np.arange(n) / fs
    ph = np.cumsum(2 * np.pi * (75e3 / fs) * np.sin(2 * np.pi * 2000.0 * t))
    x = (np.exp(1j * ph) * np.exp(2j * np.pi * 200e3 * t)).astype(np.complex64)

    def run(fused):
        fg, parts = models.wbfm_receiver(
            fs=fs, source=general.vector_source(x), batch_size=102400,
            fused=fused)
        fg.run()
        return parts["sink"].data()

    assert _snr(run(False), run(True)) > 90
