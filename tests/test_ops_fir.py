"""Golden tests for the FIR kernels vs scipy (SURVEY.md §5 pattern:
every numerical kernel checked against a scipy/numpy reference at an SNR
bound), plus the batch-split invariance the streaming contract requires."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sig

from newsched_tpu.ops import fir as fir_ops
from newsched_tpu.ops import firdes


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    ref = np.asarray(ref)
    test = np.asarray(test)
    err = ref - test
    p_sig = np.mean(np.abs(ref) ** 2)
    p_err = np.mean(np.abs(err) ** 2)
    if p_err == 0:
        return np.inf
    return 10 * np.log10(p_sig / p_err)


def _rand_complex(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


TAPS = firdes.low_pass(1.0, 1.0, 0.2, 0.05, ntaps=129)


@pytest.mark.parametrize("method", ["mxu", "conv", "fft"])
@pytest.mark.parametrize("decim", [1, 4])
def test_fir_matches_scipy(method, decim):
    x = _rand_complex(4096)
    state = fir_ops.fir_init_state(len(TAPS), dtype=jnp.complex64)
    _, y = fir_ops.fir_filter(jnp.asarray(TAPS), state, jnp.asarray(x), decim=decim, method=method)
    ref = sig.lfilter(TAPS.astype(np.float64), [1.0], x.astype(np.complex128))[::decim]
    assert snr_db(ref, np.asarray(y)) > 100, f"{method} decim={decim}"


@pytest.mark.parametrize("method", ["mxu", "conv", "fft"])
def test_fir_batch_split_invariance(method):
    """Processing 4 batches of 1024 == 1 batch of 4096, bit-for-bit intent
    (>=120 dB; float assoc differences allowed)."""
    x = _rand_complex(4096, seed=1)
    taps = jnp.asarray(TAPS)
    s = fir_ops.fir_init_state(len(TAPS), dtype=jnp.complex64)
    _, y_once = fir_ops.fir_filter(taps, s, jnp.asarray(x), method=method)

    s = fir_ops.fir_init_state(len(TAPS), dtype=jnp.complex64)
    parts = []
    for i in range(4):
        s, yb = fir_ops.fir_filter(taps, s, jnp.asarray(x[i * 1024 : (i + 1) * 1024]), method=method)
        parts.append(np.asarray(yb))
    y_split = np.concatenate(parts)
    assert snr_db(np.asarray(y_once), y_split) > 120


def test_fir_real_taps_real_signal():
    x = np.random.default_rng(2).standard_normal(2048).astype(np.float32)
    taps = firdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=65)
    s = fir_ops.fir_init_state(len(taps), dtype=jnp.float32)
    _, y = fir_ops.fir_filter(jnp.asarray(taps), s, jnp.asarray(x), method="mxu")
    ref = sig.lfilter(taps.astype(np.float64), [1.0], x.astype(np.float64))
    assert snr_db(ref, np.asarray(y)) > 100


def test_fir_complex_taps():
    x = _rand_complex(2048, seed=3)
    taps = firdes.complex_band_pass(1.0, 1.0, 0.05, 0.2, 0.05, ntaps=64)
    s = fir_ops.fir_init_state(len(taps), dtype=jnp.complex64)
    for method in ("mxu", "conv", "fft"):
        _, y = fir_ops.fir_filter(jnp.asarray(taps), s, jnp.asarray(x), method=method)
        ref = sig.lfilter(taps.astype(np.complex128), [1.0], x.astype(np.complex128))
        assert snr_db(ref, np.asarray(y)) > 90, method


@pytest.mark.parametrize("interp,decim", [(3, 1), (2, 3), (4, 7), (147, 160)])
def test_rational_resampler_matches_upfirdn(interp, decim):
    # Batch size must make B*interp % decim == 0.
    B = 960  # divisible by 3, 7*? 960*4=3840 % 7 != 0 -> use lcm-friendly B
    B = decim * 64
    x = _rand_complex(2 * B, seed=4)
    ntaps = 8 * interp + 1
    taps = firdes.low_pass(interp, 1.0, 0.4 / max(interp, decim), 0.1 / max(interp, decim), ntaps=ntaps)
    s = fir_ops.resampler_init_state(ntaps, interp, dtype=jnp.complex64)
    outs = []
    for b in range(2):
        s, y = fir_ops.fir_interp_filter(jnp.asarray(taps), s, jnp.asarray(x[b * B : (b + 1) * B]), interp, decim)
        outs.append(np.asarray(y))
    y = np.concatenate(outs)
    full = sig.upfirdn(taps.astype(np.float64), x.astype(np.complex128), up=interp, down=decim)
    ref = full[: len(y)]
    assert snr_db(ref, y) > 90, (interp, decim)


def test_streaming_equals_offline_long():
    """Config #0 shape: 128-tap low-pass over a long stream in batches."""
    n = 1 << 16
    x = _rand_complex(n, seed=5)
    s = fir_ops.fir_init_state(len(TAPS), dtype=jnp.complex64)
    B = 8192
    out = []
    for i in range(n // B):
        s, y = fir_ops.fir_filter(jnp.asarray(TAPS), s, jnp.asarray(x[i * B : (i + 1) * B]))
        out.append(np.asarray(y))
    y = np.concatenate(out)
    ref = sig.lfilter(TAPS.astype(np.float64), [1.0], x.astype(np.complex128))
    assert snr_db(ref, y) > 100


def test_fft_filter_1024_taps_matches_scipy():
    """Config #3's shape: a 1024-tap overlap-save FIR streamed over three
    batches equals scipy on the whole stream."""
    rng = np.random.default_rng(3)
    ntaps = 1024
    taps = np.asarray(firdes.low_pass(1.0, 1.0, 0.1, 0.03, ntaps=ntaps),
                      np.float32)
    n = 3 * 20480
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    B = n // 3
    s = fir_ops.fir_init_state(ntaps, dtype=jnp.complex64)
    out = []
    for i in range(3):
        s, y = fir_ops.fir_filter(taps, s, jnp.asarray(x[i * B:(i + 1) * B]),
                                  method="fft")
        out.append(np.asarray(y))
    y = np.concatenate(out)
    ref = sig.lfilter(taps.astype(np.float64), [1.0], x.astype(np.complex128))
    assert snr_db(ref, y) > 100


def test_fft_filter_decim_complex_and_real_streams():
    rng = np.random.default_rng(4)
    taps = np.asarray(firdes.low_pass(1.0, 1.0, 0.05, 0.02, ntaps=513),
                      np.float32)
    n = 40960
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    s = fir_ops.fir_init_state(513, dtype=jnp.complex64)
    _, y = fir_ops.fir_filter(taps, s, jnp.asarray(x), decim=4, method="fft")
    ref = sig.lfilter(taps.astype(np.float64), [1.0],
                      x.astype(np.complex128))[::4]
    assert snr_db(ref, y) > 100
    # a real stream takes the rfft pair
    sr = fir_ops.fir_init_state(513, dtype=jnp.float32)
    _, yr = fir_ops.fir_filter(taps, sr, jnp.asarray(np.real(x)), decim=4,
                               method="fft")
    assert yr.dtype == jnp.float32
    assert snr_db(np.real(ref), yr) > 100


@pytest.mark.parametrize("seed", [0, 1])
def test_fft_filter_streaming_property(seed):
    """Property: random taps/decim/batch splits through the overlap-save
    path equal scipy on the concatenated stream (streaming state carried
    across uneven batch boundaries)."""
    rng = np.random.default_rng(seed + 10)
    ntaps = int(rng.integers(400, 2000))
    decim = int(rng.choice([1, 2, 4]))
    taps = (rng.standard_normal(ntaps) * np.hanning(ntaps)).astype(np.float32)
    splits = [16384, 20480, 18432]
    n = sum(splits)
    pad = (-n) % decim
    splits[-1] += pad
    n += pad
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    s = fir_ops.fir_init_state(ntaps, dtype=jnp.complex64)
    out, i0 = [], 0
    for b in splits:
        s, y = fir_ops.fir_filter(taps, s, jnp.asarray(x[i0:i0 + b]),
                                  decim=decim, method="fft")
        out.append(np.asarray(y))
        i0 += b
    y = np.concatenate(out)
    ref = sig.lfilter(taps.astype(np.float64), [1.0],
                      x.astype(np.complex128))[::decim]
    assert snr_db(ref[: len(y)], y) > 100


@pytest.mark.parametrize("ntaps,n_lin,expect", [
    (1024, 1 << 21, 8192),   # 8x the taps
    (100, 1 << 21, 1024),    # powers of two
    (1024, 3000, 4096),      # capped by the batch's own convolution length
])
def test_fft_size_rule(ntaps, n_lin, expect):
    """The automatic segment is the power of two >= 8x the taps, never
    longer than one batch's linear convolution needs."""
    calls = {}
    orig = fir_ops._frame_with_halo

    def spy(xfull, nseg, step, fft_size):
        calls["fft_size"] = fft_size
        return orig(xfull, nseg, step, fft_size)

    fir_ops._frame_with_halo = spy
    try:
        fir_ops.fft_filter_full(jnp.zeros((n_lin + ntaps - 1,), jnp.complex64),
                                jnp.ones((ntaps,), jnp.float32), n_lin)
    finally:
        fir_ops._frame_with_halo = orig
    assert calls["fft_size"] == expect
