"""AGC (automatic gain control) as a parallel affine scan.

Reference semantics (kernel/include/gnuradio/kernel/analog/agc.h):
per sample, output = input * gain, then
    gain += rate * (reference - |output|)
which is the affine recurrence
    g[n+1] = g[n] * (1 - rate*|x[n]|) + rate*reference.

A sequential loop is poison on an accelerator; ``lax.associative_scan`` over the affine
coefficient pairs computes every per-sample gain in log depth. State is the
single carried gain scalar, so batch splits are exact.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class AgcState(NamedTuple):
    gain: jax.Array  # float32 scalar


def agc_init_state(initial_gain: float = 1.0) -> AgcState:
    return AgcState(gain=jnp.asarray(initial_gain, dtype=jnp.float32))


def agc(
    state: AgcState,
    x: jax.Array,
    rate: jax.Array,
    reference: jax.Array,
    max_gain: jax.Array | float = 0.0,
) -> tuple[AgcState, jax.Array]:
    """Apply AGC over one batch. max_gain <= 0 disables the clamp.

    Works for complex64 (envelope = |x|) and float32 (envelope = |x|) inputs,
    matching agc_cc / agc_ff in the reference.
    """
    mag = jnp.abs(x).astype(jnp.float32)
    rate = jnp.float32(rate)
    reference = jnp.float32(reference)
    a = 1.0 - rate * mag
    b = jnp.full(mag.shape, rate * reference, dtype=jnp.float32)

    def combine(l, r):
        return (l[0] * r[0], r[0] * l[1] + r[1])

    # Prefix products give g[n] for n >= 1 from g[0]; clamping (max_gain)
    # breaks associativity, so the clamp is applied post hoc — same behavior
    # as the reference in its stable operating region.
    A, B = jax.lax.associative_scan(combine, (a, b))
    g0 = state.gain
    gains_after = A * g0 + B  # g[n+1] for each n
    gains = jnp.concatenate([g0[None], gains_after[:-1]])  # g[n] applied to x[n]
    if not (isinstance(max_gain, (int, float)) and max_gain <= 0):
        gains = jnp.minimum(gains, jnp.float32(max_gain))
    y = x * gains.astype(jnp.float32 if not jnp.issubdtype(x.dtype, jnp.complexfloating) else x.dtype)
    new_gain = gains_after[-1]
    if not (isinstance(max_gain, (int, float)) and max_gain <= 0):
        new_gain = jnp.minimum(new_gain, jnp.float32(max_gain))
    return AgcState(gain=new_gain), y.astype(x.dtype)
