"""The FM channelizer chain on the planes-rows stream, in plain jax.numpy.

One function computes the whole per-channel pipeline of configs #2/#4:

    M-channel PFB arm fold -> DFT phase combine -> quadrature demod
    -> decimating audio FIR

Stream format ("planes rows"): a (n, 2M) f32 matrix whose row k is
[re | im] of the wideband samples x[kM-(M-1) .. kM] — the rows of the
commutator matrix V in ops/pfb.py, continued across batches.

**State is the input-row history alone.** Every stage has finite memory
(the fold reads L-1 earlier rows, the demod one earlier channel row, the
audio FIR A-1 earlier demod rows), so the chain's output for a batch is a
pure function of the batch's rows plus the ``history_rows(L, A)`` rows
before it. A streaming block therefore carries nothing but those raw rows
and recomputes its demod and audio-FIR lead-in every batch. That makes a
batch split, a time shard and a kernel tile the same problem: each needs
only the preceding input rows (zeros before the stream starts, which
reproduces the zero-state convention exactly: a zero channel row demods
to 0).

Precision: the fold and the audio FIR are exact float32 multiply-adds.
The DFT is the one matmul on the path. Its default,
``jax.lax.Precision.HIGHEST``, is a full float32 product: on an H100 it
was both faster and more accurate here than ``"split3"``, the 3-pass bf16
hi/lo split (~2^-16 relative; PERF.md).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from newsched_tpu.ops.fir import _mm_split3


def history_rows(L: int, A: int) -> int:
    """Input rows a batch needs before its first row: L-1 for the arm
    fold, one for the demod's previous channel row, A-1 for the audio
    FIR's tail of demod rows."""
    return (L - 1) + 1 + (A - 1)


def planes_taps(c: np.ndarray) -> np.ndarray:
    """(L, M) arm-fold coefficients -> (L, 2M) for the planes layout."""
    c = np.asarray(c, np.float32)
    return np.concatenate([c, c], axis=1)


def planes_dft_matrix(M: int) -> np.ndarray:
    """(2M, 2M) real matrix computing the channelizer phase combine on the
    planes layout: [ar | ai] @ [[Wr, Wi], [-Wi, Wr]] = [yr | yi]."""
    k = np.arange(M)
    W = np.exp(-2j * np.pi * np.outer(k, k) / M) * np.exp(-2j * np.pi * k / M)[None, :]
    Wr, Wi = W.real.astype(np.float32), W.imag.astype(np.float32)
    top = np.concatenate([Wr, Wi], axis=1)
    bot = np.concatenate([-Wi, Wr], axis=1)
    return np.concatenate([top, bot], axis=0)


def matmul(a, b, precision):
    """The signal path's matmul at a named precision: "split3" (3-pass
    bf16 split) or a jax.lax.Precision."""
    if precision == "split3":
        return _mm_split3(a, b)
    return jnp.matmul(a, b, precision=precision,
                      preferred_element_type=jnp.float32)


def fm_demod_planes(yr, yi, pr, pi, gain):
    """gain * arg(conj(prev) * cur) per channel, 0 where either is 0 (the
    zero-history convention shared with the staged demod blocks)."""
    re = pr * yr + pi * yi
    im = pr * yi - pi * yr
    zero = ((pr == 0) & (pi == 0)) | ((yr == 0) & (yi == 0))
    return jnp.where(zero, jnp.float32(0), jnp.arctan2(im, re)) * jnp.float32(gain)


def fm_chain_rows(rows: jax.Array, arm_c: np.ndarray, ataps: np.ndarray,
                  decim: int, gain: float,
                  precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """Audio for one batch from its planes rows and their history.

    Args:
      rows: (h + n, 2M) f32, h = history_rows(L, A): the h rows preceding
        the batch (zeros before the stream starts), then the n batch rows.
      arm_c: (L, M) fold coefficients (``c`` in ops/pfb.py).
      ataps: (A,) audio FIR taps; decim: audio decimation (divides n).
      gain: demod gain. precision: the DFT matmul's precision.

    Returns (n // decim, M) f32 audio: out[o] = sum_t ataps[t] *
    aud[o*decim - t] over the batch's channel rows.
    """
    arm_c = np.asarray(arm_c, np.float32)
    ataps = np.asarray(ataps, np.float32)
    L, M = arm_c.shape
    A = ataps.shape[0]
    h = history_rows(L, A)
    n = int(rows.shape[0]) - h
    if n <= 0 or n % decim:
        raise ValueError(f"batch rows {n} must be a positive multiple of "
                         f"the audio decimation {decim}")
    # channel rows for positions [-A, n): the fold for position p reads
    # rows p-(L-1) .. p, i.e. rows[j .. j+L-1] for j = p + A
    ny = n + A
    c2 = planes_taps(arm_c)
    acc = c2[0][None, :] * rows[0:ny]
    for q in range(1, L):
        acc = acc + c2[q][None, :] * rows[q:q + ny]
    Y = matmul(acc, jnp.asarray(planes_dft_matrix(M)), precision)
    yr, yi = Y[:, :M], Y[:, M:]
    # demod rows for positions [-(A-1), n)
    aud = fm_demod_planes(yr[1:], yi[1:], yr[:-1], yi[:-1], gain)
    # out[o] = sum_t h[t] aud[o*decim - t]; aud index of position p is p+A-1
    n_out = n // decim
    out = ataps[0] * aud[A - 1:A - 1 + n:decim]
    for t in range(1, A):
        s = A - 1 - t
        out = out + ataps[t] * aud[s:s + n:decim]
    return out[:n_out]
