"""Streaming IIR filter via parallel (associative) scan.

The reference's kernel/filter/iir_filter.h runs a sequential direct-form
recurrence per sample — unusable on an accelerator. Here the recurrence is split:

  1. the feed-forward (FIR) part runs through the batched FIR kernel;
  2. the autoregressive part  y[n] = v[n] + sum_k fb[k] y[n-k]  is written in
     companion-matrix state-space form  z[n] = A z[n-1] + e0 v[n]  and solved
     exactly for the whole batch with ``lax.associative_scan`` over affine
     maps (M, c) — log-depth, vector/matrix-unit friendly, and bit-reproducible across
     batch splits (state carries the last `order` outputs).

Convention matches the reference (gr::kernel::filter::iir_filter):
  y[n] = sum_k ff[k] x[n-k] + sum_{k>=1} fb[k] y[n-k]
(scipy.signal.lfilter(b, a): ff = b/a[0], fb[k] = -a[k]/a[0].)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from newsched_tpu.ops.fir import FirState, fir_filter, fir_init_state


class IirState(NamedTuple):
    fir: FirState  # input history for the feed-forward taps
    y_hist: jax.Array  # last `order` outputs, y_hist[0] = y[n-1]


def iir_init_state(ff_ntaps: int, fb_order: int, dtype=jnp.float32) -> IirState:
    return IirState(
        fir=fir_init_state(ff_ntaps, dtype=dtype),
        y_hist=jnp.zeros((fb_order,), dtype=dtype),
    )


def _ar_scan(v: jax.Array, fb: jax.Array, y_hist: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Solve y[n] = v[n] + sum_k fb[k] y[n-k] for a batch, given history."""
    order = fb.shape[0]
    if order == 1:
        # Scalar affine recurrence: y[n] = fb0 * y[n-1] + v[n].
        a = jnp.full(v.shape, fb[0], dtype=v.dtype)

        def combine(l, r):
            return (l[0] * r[0], r[0] * l[1] + r[1])

        A, Bc = jax.lax.associative_scan(combine, (a, v))
        y = A * y_hist[0] + Bc
        return y, y[-1:][::-1]
    # Companion matrix A: first row = fb, subdiagonal identity.
    A = jnp.zeros((order, order), dtype=v.dtype).at[0, :].set(fb)
    A = A.at[jnp.arange(1, order), jnp.arange(0, order - 1)].set(1)
    n = v.shape[0]
    Ms = jnp.broadcast_to(A, (n, order, order))
    cs = jnp.zeros((n, order), dtype=v.dtype).at[:, 0].set(v)

    # HIGHEST precision is load-bearing: a default-precision (bf16/TF32)
    # matmul collapses the long companion-matrix product chain.
    hp = jax.lax.Precision.HIGHEST

    def combine(l, r):
        Ml, cl = l
        Mr, cr = r
        return (
            jnp.einsum("nij,njk->nik", Mr, Ml, precision=hp),
            jnp.einsum("nij,nj->ni", Mr, cl, precision=hp) + cr,
        )

    Mp, cp = jax.lax.associative_scan(combine, (Ms, cs))
    # z[n] = [y[n], ..., y[n-order+1]]
    z = jnp.einsum("nij,j->ni", Mp, y_hist, precision=hp) + cp
    return z[:, 0], z[-1, :]


def iir_filter(
    ff_taps: jax.Array,
    fb_taps: jax.Array,
    state: IirState,
    x: jax.Array,
) -> tuple[IirState, jax.Array]:
    """Filter one batch. ff_taps: (nff,), fb_taps: (order,) with fb_taps[k]
    multiplying y[n-1-k]. Returns (new_state, y)."""
    ff_taps = jnp.asarray(ff_taps)
    fb_taps = jnp.asarray(fb_taps)
    fir_state, v = fir_filter(ff_taps, state.fir, x, method="conv")
    y, y_hist = _ar_scan(v.astype(x.dtype), fb_taps.astype(x.dtype), state.y_hist)
    return IirState(fir=fir_state, y_hist=y_hist), y


def lfilter_taps(b: np.ndarray, a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Convert scipy (b, a) to (ff, fb) in this module's convention."""
    b = np.asarray(b, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    ff = (b / a[0]).astype(np.float32)
    fb = (-a[1:] / a[0]).astype(np.float32)
    return ff, fb
