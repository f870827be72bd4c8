"""Forward error correction kernels: convolutional encode + Viterbi decode.

The reference tree carries a minimal/uncertain fec module (SURVEY.md §3.4
lists blocklib/fec with low confidence; GNU Radio proper ships gr-fec with
CC encoder/decoder as its core pair). This is the accelerator-native take on that
pair:

- **Encoder**: a rate-1/n feedforward convolutional code is a sliding
  window of GF(2) dot products. Framed as (N, K) bit windows contracted
  against the polynomial bit matrix — integer matmul + parity, which XLA
  maps straight onto the hardware (no per-bit Python, no scan).
- **Viterbi**: classic add-compare-select over 2^(K-1) states, run as one
  ``lax.scan`` over time with the ACS fully vectorized across states
  (static shapes; the trellis transition tables are trace-time numpy
  constants). Soft-decision (LLR) or hard-decision metrics. Decisions are
  collected in the scan and unwound by a second scan for traceback.

Streaming: blocks of bits are decoded independently with explicit
zero-flush termination per block (``conv_encode(..., terminate=True)``),
the standard packetized-CC contract.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# The classic K=7 rate-1/2 code (Voyager / 802.11 / CCSDS), octal 171/133.
CC_K7_POLYS = (0o171, 0o133)


def _poly_bits(polys: tuple[int, ...], K: int) -> np.ndarray:
    """(n_out, K) 0/1 matrix; row r = taps of generator r, MSB = oldest bit
    convention: output_r[t] = parity(poly_r & window(bits[t-K+1 .. t]))."""
    out = np.zeros((len(polys), K), dtype=np.int32)
    for r, p in enumerate(polys):
        for k in range(K):
            out[r, K - 1 - k] = (p >> k) & 1
    return out


def conv_encode(bits: jax.Array, polys: tuple[int, ...] = CC_K7_POLYS,
                K: int = 7, terminate: bool = True) -> jax.Array:
    """Encode hard bits (0/1 int) with a rate-1/n convolutional code.

    Returns interleaved coded bits: [out0[0], out1[0], out0[1], ...] of
    length (len(bits) + (K-1 if terminate else 0)) * n.
    """
    G = _poly_bits(polys, K)  # (n, K)
    n = G.shape[0]
    b = jnp.asarray(bits, jnp.int32)
    pad_tail = K - 1 if terminate else 0
    # K-1 zeros of encoder reset state in front; optional flush tail.
    bp = jnp.pad(b, (K - 1, pad_tail))
    N = int(bp.shape[0]) - (K - 1)
    # windows[t] = bp[t : t+K]  (oldest..newest)
    idx = jnp.arange(N)[:, None] + jnp.arange(K)[None, :]
    W = bp[idx]  # (N, K) int32
    coded = jnp.mod(W @ jnp.asarray(G.T), 2)  # (N, n) GF(2) parity
    return coded.reshape(-1)


def _trellis(polys: tuple[int, ...], K: int):
    """Transition tables for 2^(K-1) states. State = last K-1 input bits,
    newest in the LSB. next_state[s, b], out_bits[s, b] -> (n,) coded."""
    G = _poly_bits(polys, K)
    S = 1 << (K - 1)
    n = G.shape[0]
    nxt = np.zeros((S, 2), dtype=np.int32)
    out = np.zeros((S, 2, n), dtype=np.int32)
    for s in range(S):
        for b in (0, 1):
            # window (oldest..newest) = bits of s (old high) then b
            window = [(s >> (K - 2 - i)) & 1 for i in range(K - 1)] + [b]
            out[s, b] = np.mod(G @ np.array(window), 2)
            nxt[s, b] = ((s << 1) | b) & (S - 1)
    return nxt, out


def viterbi_decode(llr: jax.Array, polys: tuple[int, ...] = CC_K7_POLYS,
                   K: int = 7, terminated: bool = True) -> jax.Array:
    """Maximum-likelihood sequence decode.

    Args:
      llr: (n_steps * n,) soft metrics, positive = bit more likely 1
        (hard bits map via ``2*bit - 1``). n = len(polys).
      terminated: the encoder appended K-1 flush zeros (conv_encode
        default); they are stripped from the returned bits.

    Returns (n_msg,) int32 decoded bits.
    """
    nxt, out = _trellis(polys, K)
    S, n = nxt.shape[0], out.shape[2]
    r = jnp.asarray(llr, jnp.float32).reshape(-1, n)  # (T, n)
    T = int(r.shape[0])
    # Branch metric: correlation of expected +-1 symbols with llr.
    sym = jnp.asarray((2 * out - 1).astype(np.float32))  # (S, 2, n)
    nxt_j = jnp.asarray(nxt)  # (S, 2)

    # Predecessor formulation for vectorized ACS: for each new state s',
    # its two predecessors and the input bit that got there.
    pred = np.zeros((S, 2), dtype=np.int32)
    pbit = np.zeros((S, 2), dtype=np.int32)
    cnt = np.zeros(S, dtype=np.int32)
    for s in range(S):
        for b in (0, 1):
            sp = nxt[s, b]
            pred[sp, cnt[sp]] = s
            pbit[sp, cnt[sp]] = b
            cnt[sp] += 1
    pred_j = jnp.asarray(pred)
    pbit_j = jnp.asarray(pbit)
    psym = jnp.asarray(np.stack(
        [(2 * out[pred[sp], pbit[sp]] - 1).astype(np.float32) for sp in range(S)]
    ))  # (S, 2, n) expected symbols on the two incoming branches of s'

    NEG = jnp.float32(-1e9)
    init = jnp.full((S,), NEG).at[0].set(0.0)  # encoder starts in state 0

    def step(metrics, rt):
        bm = jnp.einsum("sbn,n->sb", psym, rt)      # (S, 2) branch metric
        cand = metrics[pred_j] + bm                  # (S, 2)
        choice = jnp.argmax(cand, axis=1)            # (S,) which predecessor
        new_m = jnp.max(cand, axis=1)
        new_m = new_m - jnp.max(new_m)               # normalize (no overflow)
        return new_m, choice.astype(jnp.int8)

    final, choices = jax.lax.scan(step, init, r)     # choices: (T, S)

    # Traceback: terminated codes end in state 0; otherwise best state.
    end_state = jnp.int32(0) if terminated else jnp.argmax(final).astype(jnp.int32)

    def back(state, ch_t):
        which = ch_t[state].astype(jnp.int32)
        bit = pbit_j[state, which]
        prev = pred_j[state, which]
        return prev, bit

    _, bits_rev = jax.lax.scan(back, end_state, choices, reverse=True)
    bits = bits_rev.astype(jnp.int32)
    if terminated:
        bits = bits[: T - (K - 1)]
    return bits


def hard_to_llr(coded_bits: jax.Array) -> jax.Array:
    """Hard 0/1 coded bits -> +-1 pseudo-LLRs for viterbi_decode."""
    return 2.0 * jnp.asarray(coded_bits, jnp.float32) - 1.0


def block_interleave(x: jax.Array, rows: int) -> jax.Array:
    """Classic block interleaver: write row-wise, read column-wise.
    len(x) must divide by rows."""
    n = int(x.shape[0])
    if n % rows != 0:
        raise ValueError(f"length {n} not divisible by rows {rows}")
    return x.reshape(rows, n // rows).T.reshape(-1)


def block_deinterleave(x: jax.Array, rows: int) -> jax.Array:
    n = int(x.shape[0])
    if n % rows != 0:
        raise ValueError(f"length {n} not divisible by rows {rows}")
    return x.reshape(n // rows, rows).T.reshape(-1)
