"""Fixed-point numerically-controlled oscillator.

The reference generates sinusoids with a 32-bit fixed-point phase accumulator
(kernel math/fxpt, used by analog::sig_source) so phase stays exact over
unbounded streams. Same design here, accelerator-style: phase indices are computed
*vectorially* as ``phase0 + n * dphase`` in uint32 (wraparound is the modulo),
so a whole batch of phases materializes in one vector op — no sequential
accumulator loop, and bit-exact continuity across batches of any size.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# One turn = 2**32 phase units.
NCO_SCALE = float(2**32)
_PHASE_TO_RAD = np.float32(2.0 * np.pi / NCO_SCALE)


def freq_to_dphase(freq: float, sampling_freq: float) -> np.uint32:
    """Per-sample phase increment for a tone at `freq` (host-side, exact).

    Negative frequencies map to their modulo-1-turn equivalent, which is the
    same sample sequence (uint32 wraparound arithmetic).
    """
    turns = (freq / sampling_freq) % 1.0
    return np.uint32(np.round(turns * NCO_SCALE) % NCO_SCALE)


def nco_phase(phase0: jnp.ndarray, dphase: jnp.ndarray, n: int) -> jnp.ndarray:
    """Phases (radians, float32) for n consecutive samples; wraps exactly.

    phase0/dphase are uint32 scalars (traced); returns shape (n,) float32 in
    [0, 2*pi). The next batch's phase0 is ``phase0 + n * dphase`` (uint32).
    """
    idx = jnp.arange(n, dtype=jnp.uint32)
    acc = phase0.astype(jnp.uint32) + idx * dphase.astype(jnp.uint32)
    return acc.astype(jnp.float32) * _PHASE_TO_RAD


def nco_advance(phase0: jnp.ndarray, dphase: jnp.ndarray, n) -> jnp.ndarray:
    """Phase accumulator after n samples (uint32, exact modulo 2**32)."""
    return (phase0.astype(jnp.uint32) + jnp.uint32(n) * dphase.astype(jnp.uint32)).astype(
        jnp.uint32
    )


def nco_cexp(phase0, dphase, n: int, conj: bool = False) -> jnp.ndarray:
    """exp(+/- j*phase[k]) for k in [0, n) as complex64 (the rotator stream)."""
    ph = nco_phase(phase0, dphase, n)
    c, s = jnp.cos(ph), jnp.sin(ph)
    return jax_complex(c, -s if conj else s)


def jax_complex(re: jnp.ndarray, im: jnp.ndarray) -> jnp.ndarray:
    """complex64 from float32 planes."""
    import jax

    return jax.lax.complex(re.astype(jnp.float32), im.astype(jnp.float32))


def nco_sin(phase0, dphase, n: int, ampl=1.0, offset=0.0) -> jnp.ndarray:
    ph = nco_phase(phase0, dphase, n)
    return jnp.sin(ph) * jnp.float32(ampl) + jnp.float32(offset)


def nco_cos(phase0, dphase, n: int, ampl=1.0, offset=0.0) -> jnp.ndarray:
    ph = nco_phase(phase0, dphase, n)
    return jnp.cos(ph) * jnp.float32(ampl) + jnp.float32(offset)
