"""Property-based kernel checks: random filter configurations against
scipy across every FIR formulation and random batch splits — the golden
tier (test_ops_fir.py) pins known-good configs; this tier walks the
parameter space (odd tap counts, decim > ntaps, tiny batches) where
windowing/tail arithmetic bugs live.
"""

from fractions import Fraction

import numpy as np
import scipy.signal as sig
from hypothesis import assume, given, settings, strategies as st

import jax.numpy as jnp

from newsched_tpu.ops import fir as fir_ops, iir as iir_ops


def _snr(ref, got):
    ref = np.asarray(ref).ravel()
    err = ref - np.asarray(got).ravel().astype(ref.dtype)
    e = float(np.mean(np.abs(err) ** 2))
    p = float(np.mean(np.abs(ref) ** 2))
    return np.inf if e == 0 else 10 * np.log10(max(p, 1e-300) / e)


@settings(max_examples=25, deadline=None)
@given(
    ntaps=st.integers(1, 96),
    decim=st.integers(1, 12),
    n_batches=st.integers(1, 3),
    method=st.sampled_from(["conv", "mxu", "fft"]),
    seed=st.integers(0, 99),
)
def test_fir_random_config_matches_scipy(ntaps, decim, n_batches, method, seed):
    rng = np.random.default_rng(seed)
    taps = rng.standard_normal(ntaps).astype(np.float32) * 0.3
    B = 256 * decim  # per-batch input, divisible by decim
    x = (rng.standard_normal(B * n_batches)
         + 1j * rng.standard_normal(B * n_batches)).astype(np.complex64)

    st_ = fir_ops.fir_init_state(ntaps, dtype=jnp.complex64)
    outs = []
    for b in range(n_batches):
        st_, y = fir_ops.fir_filter(taps, st_, jnp.asarray(x[b * B:(b + 1) * B]),
                                    decim=decim, method=method)
        outs.append(np.asarray(y))
    got = np.concatenate(outs)

    ref = sig.lfilter(taps.astype(np.float64), [1.0],
                      x.astype(np.complex128))[::decim]
    assert got.shape == ref.shape, (ntaps, decim, method)
    assert _snr(ref, got) > 80, (ntaps, decim, method, _snr(ref, got))


@settings(max_examples=12, deadline=None)
@given(
    npoles=st.integers(1, 4),
    nzeros=st.integers(0, 4),
    n_batches=st.integers(1, 3),
    seed=st.integers(0, 99),
)
def test_iir_random_stable_filter_matches_scipy(npoles, nzeros, n_batches, seed):
    rng = np.random.default_rng(seed)
    # Build a guaranteed-stable filter from random poles inside |z| < 0.95
    # (real or conjugate pairs) and random real zeros.
    poles = []
    while len(poles) < npoles:
        if npoles - len(poles) >= 2 and rng.random() < 0.5:
            r = 0.95 * rng.random()
            th = np.pi * rng.random()
            poles += [r * np.exp(1j * th), r * np.exp(-1j * th)]
        else:
            poles.append(complex(0.95 * (2 * rng.random() - 1)))
    a = np.real(np.poly(poles[:npoles])).astype(np.float64)
    b = np.real(np.poly(1.8 * (rng.random(nzeros) - 0.5))) if nzeros else np.ones(1)
    b = (b * 0.5).astype(np.float64)

    B = 512
    x = rng.standard_normal(B * n_batches).astype(np.float32)
    ff, fb = iir_ops.lfilter_taps(b, a)
    st_ = iir_ops.iir_init_state(len(ff), len(fb))
    outs = []
    for k in range(n_batches):
        st_, y = iir_ops.iir_filter(ff, fb, st_, jnp.asarray(x[k * B:(k + 1) * B]))
        outs.append(np.asarray(y))
    got = np.concatenate(outs)
    ref = sig.lfilter(b, a, x.astype(np.float64))
    # reject ill-conditioned draws where f32 state recursion is hopeless
    assume(np.max(np.abs(ref)) < 1e3)
    assert _snr(ref, got) > 60, (npoles, nzeros, seed, _snr(ref, got))


@settings(max_examples=10, deadline=None)
@given(
    log2_m=st.integers(2, 5),
    taps_per_arm=st.integers(2, 12),
    n_batches=st.integers(1, 3),
    seed=st.integers(0, 99),
)
def test_pfb_random_config_matches_numpy(log2_m, taps_per_arm, n_batches, seed):
    """Random channelizer shapes vs a direct float64 numpy polyphase model,
    streaming state exact across random batch splits."""
    from newsched_tpu.ops import pfb as pfb_ops

    M = 1 << log2_m
    rng = np.random.default_rng(seed)
    proto = rng.standard_normal(M * taps_per_arm).astype(np.float32) * 0.2
    arm = pfb_ops.pfb_arm_taps(proto, M)
    L = arm.shape[1]
    B = 64 * M
    x = (rng.standard_normal(B * n_batches)
         + 1j * rng.standard_normal(B * n_batches)).astype(np.complex64)

    st_ = pfb_ops.pfb_init_state(arm.size, dtype=jnp.complex64)
    outs = []
    for k in range(n_batches):
        st_, Y = pfb_ops.pfb_channelize(jnp.asarray(arm), st_,
                                        jnp.asarray(x[k * B:(k + 1) * B]))
        outs.append(np.asarray(Y))
    got = np.concatenate(outs, axis=0)

    # float64 reference (same derivation as bench.numpy_reference)
    arm64 = pfb_ops.pfb_arm_taps(proto.astype(np.float64), M)
    n_out = len(x) // M
    xfull = np.concatenate([np.zeros(M * L - 1, np.complex128),
                            x.astype(np.complex128)])
    need = L - 1 + n_out
    V = xfull[: need * M].reshape(need, M)[:, ::-1].T
    filt = np.empty((M, n_out), np.complex128)
    for pp in range(M):
        filt[pp] = np.correlate(V[pp], arm64[pp][::-1], mode="valid")[:n_out]
    ref = (M * np.fft.ifft(filt, axis=0)).T
    assert got.shape == ref.shape
    assert _snr(ref, got) > 80, (M, taps_per_arm, _snr(ref, got))
