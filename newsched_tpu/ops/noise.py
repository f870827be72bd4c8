"""Position-pure Gaussian noise: the stream identity of the live sources.

Rows are generated in GROUP_ROWS-row groups, and group g's values depend
only on ``(seed, g)``: ``normal(fold_in(fold_in(key(seed), g_lo), g_hi))``
with jax.random's counter-based threefry generator. Any program that knows
an absolute stream position can therefore (re)produce any row span: a
batch can regenerate the rows before it instead of carrying them, and each
device of a mesh can generate its own time shard with no collectives.
Batch boundaries must fall on whole groups.

The group index is 64-bit, held as two int32 halves (hi, lo): int32 alone
would overflow within minutes at flagship rates.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

GROUP_ROWS = 64  # rows per group: the granularity of batch boundaries


def add_groups_signed(hi, lo, off):
    """64-bit group-counter add of a SIGNED int32 offset (two int32 halves,
    two's-complement semantics): the sharded gen paths step backwards from
    a shard's base group to its warm-up/halo region, which may cross zero
    on the first batch (hi goes negative — the pre-stream region)."""
    off = jnp.int32(off)
    off_hi = jax.lax.shift_right_arithmetic(off, 31)  # sign-extend
    lo2 = lo + off
    # carry out of the unsigned 32-bit add: result < addend (unsigned)
    carry = ((lo2 ^ jnp.int32(-0x80000000)) < (lo ^ jnp.int32(-0x80000000))
             ).astype(jnp.int32)
    return hi + off_hi + carry, lo2


def pure_rows(seed: int, g0_hi, g0_lo, n_rows: int, width: int, *,
              mask_pre: bool = False):
    """(n_rows, width) f32 standard-normal rows starting at absolute group
    (g0_hi, g0_lo). mask_pre=True zeroes groups whose 64-bit index is
    negative (hi < 0): the region before the stream, which a batch's or a
    shard's lead-in may reach back into on the first batch. Row 0 of the
    stream starts group 0, so the boundary is group-aligned and masking
    whole groups is exact."""
    if n_rows % GROUP_ROWS:
        raise ValueError(f"n_rows {n_rows} not a multiple of {GROUP_ROWS}")
    key = jax.random.PRNGKey(int(seed))
    offs = jnp.arange(n_rows // GROUP_ROWS, dtype=jnp.int32)
    glo = g0_lo.astype(jnp.int32) + offs
    wrapped = ((glo ^ jnp.int32(-0x80000000))
               < (g0_lo.astype(jnp.int32) ^ jnp.int32(-0x80000000)))
    ghi = g0_hi.astype(jnp.int32) + wrapped.astype(jnp.int32)

    def one(hi, lo):
        k = jax.random.fold_in(jax.random.fold_in(key, lo.astype(jnp.uint32)),
                               hi.astype(jnp.uint32))
        r = jax.random.normal(k, (GROUP_ROWS, width), jnp.float32)
        return jnp.where(hi < 0, jnp.float32(0.0), r) if mask_pre else r

    return jax.vmap(one)(ghi, glo).reshape(n_rows, width)


def advance_groups(hi, lo, n_groups: int):
    """64-bit group-counter advance as two int32 halves (uint32 wraparound
    semantics) — the source block's per-batch state update."""
    glo = lo + jnp.int32(n_groups)
    wrapped = (glo ^ jnp.int32(-0x80000000)) < (lo ^ jnp.int32(-0x80000000))
    return hi + wrapped.astype(jnp.int32), glo
