"""Carrier/timing recovery feedback loops.

Reference semantics: digital::costas_loop_cc, digital::clock_recovery_mm_cc
and the shared 2nd-order control_loop they inherit (GNU Radio lineage; the
reference's blocklib/digital carries the constellation/demod pieces these
loops complete, SURVEY.md §3.4).

Unlike the FIR/IIR/AGC kernels, these recurrences are *nonlinear* — each
step's correction passes the previous corrected output through a decision
function — so there is no associative-scan reformulation. The accelerator-native
treatment:

- the recurrence runs as one ``lax.scan`` whose body is pure vector arithmetic
  (no per-sample host dispatch, no dynamic shapes, no gather except one
  ``dynamic_slice`` in the interpolator);
- throughput parallelism comes from ``vmap``-ing the whole loop across
  independent channels (the channelizer's per-channel receivers) — the right
  way for an accelerator to amortize an irreducibly serial loop is many loops at once,
  not a faster single loop;
- state is an explicit pytree so batch splits are exact (N batches ≡ 1 batch,
  bit-for-bit), same invariant the rest of ops/ holds.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# control_loop: shared 2nd-order loop filter coefficient design
# ---------------------------------------------------------------------------

def loop_coeffs(loop_bw: float, damping: float = math.sqrt(2.0) / 2.0):
    """(alpha, beta) for a critically-damped 2nd-order loop — the standard
    control_loop gain design: denom = 1 + 2*d*bw + bw^2."""
    bw = float(loop_bw)
    d = float(damping)
    denom = 1.0 + 2.0 * d * bw + bw * bw
    alpha = 4.0 * d * bw / denom
    beta = 4.0 * bw * bw / denom
    return np.float32(alpha), np.float32(beta)


_TWO_PI = np.float32(2.0 * np.pi)


def _wrap_phase(p):
    """Wrap to (-pi, pi] without data-dependent control flow."""
    return p - _TWO_PI * jnp.round(p / _TWO_PI)


# ---------------------------------------------------------------------------
# Costas loop (carrier phase/frequency recovery)
# ---------------------------------------------------------------------------

class CostasState(NamedTuple):
    phase: jax.Array  # float32 scalar, radians
    freq: jax.Array   # float32 scalar, radians/sample


def costas_init_state(phase: float = 0.0, freq: float = 0.0) -> CostasState:
    return CostasState(phase=jnp.float32(phase), freq=jnp.float32(freq))


def _costas_error(y, order: int):
    re, im = jnp.real(y), jnp.imag(y)
    sre = jnp.where(re >= 0, 1.0, -1.0).astype(jnp.float32)
    sim = jnp.where(im >= 0, 1.0, -1.0).astype(jnp.float32)
    if order == 2:
        return re * im
    if order == 4:
        return sre * im - sim * re
    if order == 8:
        k = np.float32(math.sqrt(2.0) - 1.0)
        return jnp.where(
            jnp.abs(re) >= jnp.abs(im),
            sre * im - sim * re * k,
            sre * im * k - sim * re,
        )
    raise ValueError(f"costas order must be 2, 4, or 8 (got {order})")


def costas_loop(
    state: CostasState,
    x: jax.Array,
    loop_bw,
    order: int = 4,
    max_freq: float = 1.0,
) -> tuple[CostasState, jax.Array]:
    """De-rotate a batch by a decision-directed 2nd-order PLL.

    Per sample: y = x * exp(-j*phase); e = detector(y) clipped to ±1;
    freq += beta*e (clamped to ±max_freq); phase += freq + alpha*e (wrapped).
    ``loop_bw`` may be a python float or a traced scalar (settable param —
    changing it does not recompile).
    """
    if isinstance(loop_bw, (int, float)):
        alpha, beta = loop_coeffs(loop_bw)
    else:
        bw = jnp.float32(loop_bw)
        d = np.float32(math.sqrt(2.0) / 2.0)
        denom = 1.0 + 2.0 * d * bw + bw * bw
        alpha = 4.0 * d * bw / denom
        beta = 4.0 * bw * bw / denom
    maxf = jnp.float32(max_freq)

    def body(carry, xn):
        phase, freq = carry
        nco = jax.lax.complex(jnp.cos(-phase), jnp.sin(-phase))
        y = xn * nco
        e = jnp.clip(_costas_error(y, order), -1.0, 1.0)
        freq = jnp.clip(freq + beta * e, -maxf, maxf)
        phase = _wrap_phase(phase + freq + alpha * e)
        return (phase, freq), y

    (phase, freq), y = jax.lax.scan(body, (state.phase, state.freq), x)
    return CostasState(phase=phase, freq=freq), y.astype(x.dtype)


# ---------------------------------------------------------------------------
# Mueller & Müller clock recovery (symbol timing)
# ---------------------------------------------------------------------------

class MMState(NamedTuple):
    hist: jax.Array     # (H,) complex64 input tail carried across batches
    pos: jax.Array      # int32 — integer read position into [hist | batch]
    mu: jax.Array       # float32 in [0, 1) — fractional sample offset
    omega: jax.Array    # float32 — samples per symbol estimate
    p1: jax.Array       # previous interpolated sample
    p2: jax.Array       # the one before that
    c1: jax.Array       # previous decision
    c2: jax.Array       # decision before that


def mm_history_len(sps: int) -> int:
    """History carried between batches: headroom for the loop to read behind
    the batch boundary while the timing estimate wanders. 16 symbols deep."""
    return 16 * int(sps) + 2


def mm_init_state(sps: int, dtype=jnp.complex64) -> MMState:
    h = mm_history_len(sps)
    z = jnp.zeros((), dtype)
    return MMState(
        hist=jnp.zeros((h,), dtype),
        pos=jnp.asarray(h, jnp.int32),
        mu=jnp.float32(0.5),
        omega=jnp.float32(sps),
        p1=z, p2=z, c1=z, c2=z,
    )


def _slicer(y):
    """Nearest-quadrant decision in {±1 ±1j} (0-degree slicer)."""
    re = jnp.where(jnp.real(y) >= 0, 1.0, -1.0)
    im = jnp.where(jnp.imag(y) >= 0, 1.0, -1.0)
    return jax.lax.complex(re.astype(jnp.float32), im.astype(jnp.float32))


def clock_recovery_mm(
    state: MMState,
    x: jax.Array,
    sps: int,
    gain_omega,
    gain_mu,
    omega_relative_limit: float = 0.005,
) -> tuple[MMState, jax.Array]:
    """Mueller & Müller decision-directed timing recovery.

    Consumes len(x) samples, produces exactly len(x)//sps symbols — the
    static-shape contract the compiler's rate algebra needs. The reference's
    dynamic consume/produce dance becomes a scan-carried read position into
    ``[hist | batch]`` with linear interpolation at the fractional offset;
    sustained clock drift beyond the 16-symbol history headroom saturates the
    position clamp (the receiver analog of losing lock), while fractional
    timing offsets and bounded ppm drift track exactly.

    Timing error (M&M): e = Re{(p0-p2)·conj(c1) - (c0-c2)·conj(p1)} with p the
    interpolated samples and c their decisions; omega (samples/symbol) is
    clamped to sps·(1 ± omega_relative_limit).
    """
    sps = int(sps)
    nout = x.shape[0] // sps
    if nout * sps != x.shape[0]:
        raise ValueError("batch length must be a multiple of sps")
    h = state.hist.shape[0]
    window = jnp.concatenate([state.hist, x.astype(state.hist.dtype)])
    wlen = window.shape[0]
    g_om = jnp.float32(gain_omega)
    g_mu = jnp.float32(gain_mu)
    om_mid = jnp.float32(sps)
    om_lim = om_mid * jnp.float32(omega_relative_limit)

    def body(carry, _):
        pos, mu, omega, p1, p2, c1, c2 = carry
        pair = jax.lax.dynamic_slice(window, (pos,), (2,))
        p0 = pair[0] + (pair[1] - pair[0]) * mu.astype(jnp.float32)
        c0 = _slicer(p0)
        u = (p0 - p2) * jnp.conj(c1) - (c0 - c2) * jnp.conj(p1)
        e = jnp.clip(jnp.real(u).astype(jnp.float32), -1.0, 1.0)
        omega = om_mid + jnp.clip(omega + g_om * e - om_mid, -om_lim, om_lim)
        step = mu + omega + g_mu * e
        ipart = jnp.floor(step)
        mu = step - ipart
        # No explicit bound here: dynamic_slice clamps an out-of-range start
        # itself, and clamping pos would desync the chunked run from the
        # single-batch run at chunk boundaries (N batches must ≡ 1 batch).
        pos = pos + ipart.astype(jnp.int32)
        return (pos, mu, omega, p0, p1, c0, c1), p0

    carry0 = (state.pos, state.mu, state.omega,
              state.p1, state.p2, state.c1, state.c2)
    (pos, mu, omega, p1, p2, c1, c2), y = jax.lax.scan(
        body, carry0, None, length=nout)
    # Rebase for the next batch: its window is [window[-h:] | next_x].
    new_pos = jnp.clip(pos - (wlen - h), 0, 2 * h)
    return (
        MMState(hist=window[-h:], pos=new_pos, mu=mu, omega=omega,
                p1=p1, p2=p2, c1=c1, c2=c2),
        y.astype(x.dtype),
    )
