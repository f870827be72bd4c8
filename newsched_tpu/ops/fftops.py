"""FFT kernels — analog of the reference's kernel/fft (FFTW wrapper) and the
fft block (blocklib/fft). The FFT is XLA's own (cuFFT on the GPU); these
wrappers add the block semantics: windowing, fftshift, and vectorized
batching."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def fft(
    x: jnp.ndarray,
    forward: bool = True,
    window: np.ndarray | None = None,
    shift: bool = False,
) -> jnp.ndarray:
    """Batched FFT over the last axis. x: (..., fft_size) complex64."""
    if window is not None:
        x = x * jnp.asarray(window, dtype=x.dtype if jnp.issubdtype(x.dtype, jnp.complexfloating) else jnp.float32)
    y = jnp.fft.fft(x, axis=-1) if forward else jnp.fft.ifft(x, axis=-1)
    if shift:
        y = jnp.fft.fftshift(y, axes=-1)
    return y.astype(jnp.complex64)
