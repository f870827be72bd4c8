"""Complex <-> real-planes codec for program boundaries.

Every jit boundary in the framework (step functions, init-state builders,
scan carries entering/leaving programs, sink collections, parameters,
checkpoints) passes complex data as a ComplexParts(re, im) pair of float32
leaves: one real-only representation for everything that crosses between
host and device or is serialized. Complex values exist only inside
compiled programs. encode/decode work both under tracing (jnp) and on host pytrees
(numpy); they are no-ops for real leaves, so non-complex graphs pay
nothing.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class ComplexParts(NamedTuple):
    """A complex array split into real/imag planes (a pytree node)."""

    re: Any
    im: Any


def _is_cparts(x) -> bool:
    return isinstance(x, ComplexParts)


def encode(tree):
    """Split complex leaves into ComplexParts of real dtype. Safe under
    tracing (device) and on host numpy pytrees."""

    def enc(leaf):
        if leaf is None:
            return leaf
        dt = getattr(leaf, "dtype", None)
        if dt is not None and jnp.issubdtype(dt, jnp.complexfloating):
            if isinstance(leaf, np.ndarray) or np.isscalar(leaf):
                return ComplexParts(
                    np.ascontiguousarray(np.real(leaf), dtype=np.float32),
                    np.ascontiguousarray(np.imag(leaf), dtype=np.float32),
                )
            return ComplexParts(
                jnp.real(leaf).astype(jnp.float32), jnp.imag(leaf).astype(jnp.float32)
            )
        if isinstance(leaf, complex):
            return ComplexParts(np.float32(leaf.real), np.float32(leaf.imag))
        return leaf

    return jax.tree_util.tree_map(enc, tree)


def decode(tree):
    """Recombine ComplexParts into complex leaves (jnp under trace, numpy
    on host)."""

    def dec(leaf):
        if _is_cparts(leaf):
            if isinstance(leaf.re, np.ndarray) or np.isscalar(leaf.re):
                return (np.asarray(leaf.re) + 1j * np.asarray(leaf.im)).astype(np.complex64)
            return jax.lax.complex(jnp.asarray(leaf.re, jnp.float32),
                                   jnp.asarray(leaf.im, jnp.float32))
        return leaf

    return jax.tree_util.tree_map(dec, tree, is_leaf=_is_cparts)


def real_boundary(fn):
    """Wrap fn(*pytrees) -> pytree so that all boundaries are real: callers
    pass encoded pytrees and receive encoded results."""

    def wrapped(*enc_args):
        args = [decode(a) for a in enc_args]
        return encode(fn(*args))

    return wrapped
