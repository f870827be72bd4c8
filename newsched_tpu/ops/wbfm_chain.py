"""The wideband-FM receive chain as one function (config #1).

freq_xlating_fir -> quadrature_demod -> decimating resampler, computed on
the plain sample layout in one jitted expression for XLA to fuse.

**The output rotator folds through the demod.** The staged
freq_xlating_fir rotates the input by the fxpt-NCO phase e^{-j w n}
(w = 2*pi*dphase/2^32) before filtering. With rotated taps
c_rot[t] = c[t] e^{+j w t} the xlate output is e^{-j w m D} v[m], and the
demod product conj(u[m-1]) u[m] = conj(v[m-1]) v[m] e^{-j w D}: a constant
rotation applied before the angle. The NCO drops out exactly, which makes
center_freq a compile-time constant of the chain.

**State is the input history alone.** The chain has finite memory (ntaps-1
input samples for the xlate FIR, one xlate output for the demod, A-1 demod
outputs for the resampler), so a batch's audio is a pure function of the
batch and the ``plan.history`` input samples before it (zeros before the
stream starts, which reproduces the staged blocks' zero initial state: a
zero xlate output demods to 0).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from newsched_tpu.ops import fir as fir_ops


class WbfmChainPlan:
    """Trace-time constants of one chain configuration: rotated taps, the
    demod rotation, decimations, and the input history a batch needs."""

    def __init__(self, chan_taps, dphase: int, decim: int, resamp_taps,
                 resamp_decim: int, demod_gain: float):
        self.D = int(decim)
        self.Rd = int(resamp_decim)
        self.resamp_taps = np.asarray(resamp_taps, np.float32)
        self.A = int(len(resamp_taps))
        self.gain = float(demod_gain)
        ntaps = int(len(chan_taps))
        w = 2 * np.pi * (int(dphase) % (1 << 32)) / (1 << 32)
        self.rot = complex(np.exp(-1j * w * self.D))
        self.c_rot = (np.asarray(chan_taps, np.float64)
                      * np.exp(1j * w * np.arange(ntaps))).astype(np.complex64)
        # xlate outputs for positions [-A, 0) rebuild the demod's previous
        # sample and the resampler's A-1 tail
        self.history = self.A * self.D + ntaps - 1


def wbfm_chain(x_ext: jax.Array, plan: WbfmChainPlan) -> jax.Array:
    """Audio for one batch.

    Args:
      x_ext: (plan.history + n,) complex64: the history samples, then the
        n batch samples (n a multiple of D * Rd).
      plan: WbfmChainPlan.

    Returns (n // (D * Rd),) float32 audio.
    """
    D, Rd, A = plan.D, plan.Rd, plan.A
    ntaps = len(plan.c_rot)
    n = int(x_ext.shape[0]) - plan.history
    if n <= 0 or n % (D * Rd):
        raise ValueError(f"batch {n} must be a positive multiple of "
                         f"decim * resamp_decim = {D * Rd}")
    # xlate outputs for positions [-A, n/D)
    _, v = fir_ops.fir_filter(
        plan.c_rot, fir_ops.FirState(tail=x_ext[:ntaps - 1]),
        x_ext[ntaps - 1:], decim=D)
    p = jnp.conj(v[:-1]) * v[1:] * jnp.complex64(plan.rot)
    d = jnp.where((v[:-1] == 0) | (v[1:] == 0), jnp.float32(0),
                  jnp.arctan2(jnp.imag(p), jnp.real(p))) * jnp.float32(plan.gain)
    # d covers positions [-(A-1), n/D): the first A-1 are the resampler tail
    _, y = fir_ops.fir_filter(
        plan.resamp_taps, fir_ops.FirState(tail=d[:A - 1]), d[A - 1:],
        decim=Rd)
    return y
