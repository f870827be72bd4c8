"""Analog-domain kernels: quadrature (FM) demod, frequency translation.

Reference: blocklib/analog quadrature_demod (y[n] = gain * arg(conj(x[n-1]) *
x[n])) and the freq-translating front half of filter/freq_xlating_fir. Both
are elementwise on a batch once the one-sample history is concatenated, so
XLA fuses them into neighboring kernels for free.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from newsched_tpu.ops.nco import nco_advance, nco_cexp


class QuadDemodState(NamedTuple):
    prev: jax.Array  # last input sample, complex64 shape ()


def quad_demod_init_state(dtype=jnp.complex64) -> QuadDemodState:
    return QuadDemodState(prev=jnp.zeros((), dtype=dtype))


def quadrature_demod(
    state: QuadDemodState, x: jax.Array, gain
) -> tuple[QuadDemodState, jax.Array]:
    """FM discriminator over one batch -> float32."""
    xprev = jnp.concatenate([state.prev[None], x[:-1]])
    p = jnp.conj(xprev) * x
    # Zero-history convention: demod against a zero sample emits exactly 0
    # (atan2(+-0, +-0) is a signed-zero lottery no two backends agree on;
    # the same pinning is used in every demod path).
    y = jnp.where((xprev == 0) | (x == 0), jnp.float32(0),
                  jnp.arctan2(jnp.imag(p), jnp.real(p))) * jnp.float32(gain)
    return QuadDemodState(prev=x[-1]), y.astype(jnp.float32)


class RotatorState(NamedTuple):
    phase: jax.Array  # uint32 fixed-point phase accumulator


def rotator_init_state() -> RotatorState:
    return RotatorState(phase=jnp.uint32(0))


def rotate(
    state: RotatorState, x: jax.Array, dphase: jax.Array, conj: bool = False
) -> tuple[RotatorState, jax.Array]:
    """Multiply a batch by exp(+/- j*phase[n]) with an exact fixed-point NCO.

    This is the frequency-translation front end of freq_xlating_fir: the
    rotator stream is generated vectorially (no sequential accumulation) and
    XLA fuses the complex multiply into whatever follows.
    """
    n = x.shape[0]
    rot = nco_cexp(state.phase, dphase, n, conj=conj)
    y = x * rot
    return RotatorState(phase=nco_advance(state.phase, dphase, n)), y
