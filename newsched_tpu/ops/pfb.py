"""Polyphase filterbank kernels: channelizer and decimator.

Rebuild of the reference's kernel/filter/polyphase_filterbank and
blocklib/filter pfb_channelizer. The maximally-decimated M-channel analysis
bank is derived from first principles so every channel k is *mathematically
identical* to ``decimate_M(lowpass(x * exp(-j 2 pi k n / M)))``:

    y_k[m] = sum_t h[t] x[mM - t] e^{+j 2 pi k t / M}
           = sum_{p=0}^{M-1} e^{j 2 pi k p / M} * (g_p (*) u_p)[m]
    with arm taps    g_p[l] = h[lM + p]
    and arm signals  u_p[i] = x[iM - p]

i.e. per-arm streaming FIRs followed by an M-point inverse DFT across arms
(times M). The whole batch computes as L shifted multiply-adds plus one
batched FFT, which XLA fuses; ops/fm_chain.py runs the same fold inside the
fused FM chain.

Streaming state is the last ntaps-1 = M*L-1 raw input samples (identical
contract to the FIR kernel), so batch-split invariance holds exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import functools

import jax
import jax.numpy as jnp
import numpy as np

from newsched_tpu.ops.fir import FirState, fir_init_state


class PfbState(NamedTuple):
    tail: jax.Array  # last M*L-1 input samples


def pfb_arm_taps(taps: np.ndarray, nchans: int) -> np.ndarray:
    """Partition prototype taps into per-arm taps g[p, l] = h[l*M + p].

    Pads the prototype with zeros up to a multiple of nchans (same as the
    reference, which rounds the prototype up to fill all arms).
    """
    taps = np.asarray(taps)
    L = -(-taps.shape[0] // nchans)
    padded = np.zeros(L * nchans, dtype=taps.dtype)
    padded[: taps.shape[0]] = taps
    return padded.reshape(L, nchans).T.copy()  # (M, L)


def pfb_init_state(ntaps_total: int, dtype=jnp.complex64) -> PfbState:
    return PfbState(tail=jnp.zeros((ntaps_total - 1,), dtype=dtype))


def _arm_signals(xfull: jax.Array, nchans: int, L: int, n_out: int) -> jax.Array:
    """U[p, i] = arm p's input stream with L-1 history, shape (M, L-1+n_out).

    xfull has the M*L-1 halo at the front; arm p starts at local index
    M-1-p and strides by M (see derivation in the module docstring).
    """
    M = nchans
    need = L - 1 + n_out
    # One reshape covers all arms: pad front by 0 so index M-1-p + i*M maps to
    # a (need, M) view read backwards along the arm axis.
    # xfull[M-1-p + i*M] = xfull.reshape(-1, M)[i, M-1-p] after aligning.
    usable = xfull[: need * M]
    V = usable.reshape(need, M)  # V[i, q] = xfull[i*M + q]
    return V[:, ::-1].T  # U[p, i] = V[i, M-1-p]


def pfb_channelize(
    arm_taps: jax.Array,
    state: PfbState,
    x: jax.Array,
    combine: str = "auto",
) -> tuple[PfbState, jax.Array]:
    """Channelize one batch.

    Args:
      arm_taps: (M, L) float32 polyphase partition from pfb_arm_taps.
      state: PfbState with M*L-1 tail samples.
      x: (B,) complex64, B % M == 0.
      combine: the across-arms combine, "fft" ("auto") or "matmul".

    Returns (new_state, Y) where Y is (B//M, M) complex64 — item m is the
    M channel outputs at channel-rate sample index m; channel k is centered
    at k/M of the input rate (k > M/2 are negative frequencies).
    """
    M, L = int(arm_taps.shape[0]), int(arm_taps.shape[1])
    B = int(x.shape[0])
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible by nchans {M}")
    n_out = B // M
    ntaps = M * L
    xfull = jnp.concatenate([state.tail, x])
    # Layout-preserving formulation: keep the commutator matrix
    # V[i, q] = xfull[i*M + q] as-is — no
    # transpose, no arm-reversal gather. With q = M-1-p the arm correlation
    # becomes L shifted multiply-adds along axis 0 with coefficients
    # c[s, q] = arm[M-1-q, L-1-s], and the final phase combine
    #   y_k = sum_p v_p e^{j2pi pk/M}
    # turns into a plain FFT along the q axis times the fixed twiddle
    # e^{-j2pi k/M} (index reversal absorbed analytically).
    need = L - 1 + n_out
    V = xfull[: need * M].reshape(need, M)
    arm_np = np.asarray(arm_taps, dtype=np.float32)
    c = arm_np[::-1, ::-1].T  # (L, M): c[s, q] = arm[M-1-q, L-1-s]
    acc = jnp.zeros((n_out, M), jnp.complex64)
    for s in range(L):
        acc = acc + jnp.asarray(c[s])[None, :] * jax.lax.dynamic_slice_in_dim(
            V, s, n_out, 0
        )
    Y = _phase_combine(acc, M, combine)
    new_tail = xfull[-(ntaps - 1):]
    return PfbState(tail=new_tail), Y  # (n_out, M)


def _phase_combine(acc: jax.Array, M: int, combine: str) -> jax.Array:
    """The across-arms combine: y[:, k] = twiddle[k] * FFT_q(acc)[:, k]
    with twiddle = e^{-j 2 pi k / M} (ops/pfb.py derivation).

    combine="fft" ("auto"): XLA FFT + twiddle multiply. combine="matmul":
    one (M, M) complex DFT matrix with the twiddle absorbed, contracted as
    four real float32 matmuls.
    """
    if combine == "auto":
        combine = "fft"
    k = np.arange(M)
    tw = np.exp(-2j * np.pi * k / M)
    if combine == "fft":
        twiddle = jnp.asarray(tw.astype(np.complex64))
        return (jnp.fft.fft(acc, axis=-1) * twiddle[None, :]).astype(jnp.complex64)
    if combine != "matmul":
        raise ValueError(f"unknown pfb combine {combine!r}")
    # W[q, k] = e^{-j 2 pi q k / M} * tw[k]; FFT convention: X_k = sum_q x_q W
    W = np.exp(-2j * np.pi * np.outer(k, k) / M) * tw[None, :]
    Wr = jnp.asarray(W.real.astype(np.float32))
    Wi = jnp.asarray(W.imag.astype(np.float32))
    ar, ai = jnp.real(acc), jnp.imag(acc)
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    return jax.lax.complex(mm(ar, Wr) - mm(ai, Wi), mm(ar, Wi) + mm(ai, Wr))


def pfb_decimate(
    arm_taps: jax.Array,
    state: PfbState,
    x: jax.Array,
    channel: int,
) -> tuple[PfbState, jax.Array]:
    """Single-channel polyphase decimator (reference: pfb_decimator):
    extract channel `channel` of the M-channel bank without computing the
    other M-1 channels — the phase combine for one k is a single weighted
    sum over arms, y[:, k] = acc @ w_k (one matvec instead of an FFT)."""
    M, L = int(arm_taps.shape[0]), int(arm_taps.shape[1])
    B = int(x.shape[0])
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible by nchans {M}")
    n_out = B // M
    ntaps = M * L
    k = int(channel) % M
    xfull = jnp.concatenate([state.tail, x])
    need = L - 1 + n_out
    V = xfull[: need * M].reshape(need, M)
    arm_np = np.asarray(arm_taps, dtype=np.float32)
    c = arm_np[::-1, ::-1].T
    acc = jnp.zeros((n_out, M), jnp.complex64)
    for s in range(L):
        acc = acc + jnp.asarray(c[s])[None, :] * jax.lax.dynamic_slice_in_dim(
            V, s, n_out, 0
        )
    q = np.arange(M)
    wk = (np.exp(-2j * np.pi * q * k / M) * np.exp(-2j * np.pi * k / M)).astype(
        np.complex64
    )
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    ar, ai = jnp.real(acc), jnp.imag(acc)
    y = jax.lax.complex(
        mm(ar, jnp.asarray(wk.real)) - mm(ai, jnp.asarray(wk.imag)),
        mm(ar, jnp.asarray(wk.imag)) + mm(ai, jnp.asarray(wk.real)),
    )
    return PfbState(tail=xfull[-(ntaps - 1):]), y
