"""Streaming FIR filter kernels.

Replacement for the reference's kernel/filter/fir_filter.{h,cc}
(and its CUDA twin in cusp): instead of a per-call dot-product over a ring
buffer, we filter a whole fixed-size time batch at once, carrying the last
``ntaps-1`` input samples between batches as explicit state (the functional
analog of the ring buffer's history region).

Semantics (matches the reference / scipy.signal.lfilter for a causal FIR):

    y[n] = sum_t taps[t] * x[n - t],   x[<0] = 0

Three compute paths, selected by ``method``:

- ``"mxu"``:  frames the output into tiles of 128 and contracts each frame's
  haloed input window against a Toeplitz tap matrix — one big
  (nframes, F+T-1) @ (F+T-1, F) float32 matmul for the matrix units.
  The tap matrix is ~half zeros (2x redundant FLOPs), which matrix units
  absorb more cheaply than the gather a direct sliding window needs.
  ``"mxu3"`` is the same at the 3-pass bf16 precision (``_mm_split3``).
- ``"conv"``: ``lax.conv_general_dilated`` — XLA's native conv covers
  stride (decimation) and lhs dilation (interpolation) exactly; complex
  data is decomposed into real plane convs.
- ``"fft"``:  overlap-save fast convolution (segmented FFT/IFFT), the same
  core the fft_filter block uses (reference blocklib/filter fft_filter).
  Best for large ntaps.

All paths are pure functions of (taps, state, x) and are bit-identical in
streaming: processing one batch of N samples equals processing k batches of
N/k (tested as the N-batches == 1-batch invariance).
"""

from __future__ import annotations

from typing import NamedTuple

import functools

import jax
import jax.numpy as jnp
import numpy as np


class FirState(NamedTuple):
    """Inter-batch FIR state: the last ntaps-1 input samples."""

    tail: jax.Array  # shape (ntaps-1,) in the input dtype


def fir_init_state(ntaps: int, dtype=jnp.complex64) -> FirState:
    return FirState(tail=jnp.zeros((max(ntaps - 1, 0),), dtype=dtype))


# ---------------------------------------------------------------------------
# helpers


def _is_complex(x) -> bool:
    return jnp.issubdtype(jnp.asarray(x).dtype, jnp.complexfloating)


def _real_conv1d(x: jax.Array, k: jax.Array, stride: int = 1, lhs_dilation: int = 1) -> jax.Array:
    """Batched real 1-D correlation. x: (B, L) f32, k: (K,) f32 -> (B, Lout)."""
    out = jax.lax.conv_general_dilated(
        x[:, None, :],
        k[None, None, :],
        window_strides=(stride,),
        padding=[(0, 0)],
        lhs_dilation=(lhs_dilation,),
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[:, 0, :]


def _conv1d(x: jax.Array, kernel_rev: jax.Array, stride: int = 1, lhs_dilation: int = 1):
    """Valid-mode correlation of a 1-D signal with an (already reversed) kernel.

    Handles the four real/complex combinations by decomposing into real-plane
    convs (doing it explicitly keeps control of precision).
    """
    cx, ck = _is_complex(x), _is_complex(kernel_rev)
    if not cx and not ck:
        return _real_conv1d(x[None, :].astype(jnp.float32), kernel_rev.astype(jnp.float32),
                            stride, lhs_dilation)[0]
    if cx and not ck:
        planes = jnp.stack([jnp.real(x), jnp.imag(x)]).astype(jnp.float32)
        out = _real_conv1d(planes, kernel_rev.astype(jnp.float32), stride, lhs_dilation)
        return jax.lax.complex(out[0], out[1])
    if cx and ck:
        xr, xi = jnp.real(x).astype(jnp.float32), jnp.imag(x).astype(jnp.float32)
        kr, ki = jnp.real(kernel_rev).astype(jnp.float32), jnp.imag(kernel_rev).astype(jnp.float32)
        planes = jnp.stack([xr, xi, xr, xi])[None]  # (1, 4, L)
        kerns = jnp.stack([kr, kr, ki, ki])[:, None, :]  # (4, 1, K)
        out = jax.lax.conv_general_dilated(
            planes,
            kerns,
            window_strides=(stride,),
            padding=[(0, 0)],
            lhs_dilation=(lhs_dilation,),
            feature_group_count=4,  # depthwise: [xr*kr, xi*kr, xr*ki, xi*ki]
            precision=jax.lax.Precision.HIGHEST,
        )
        o = out[0]
        return jax.lax.complex(o[0] - o[3], o[1] + o[2])
    # real x, complex k
    xr = x.astype(jnp.float32)[None, :]
    kr = jnp.stack([jnp.real(kernel_rev), jnp.imag(kernel_rev)]).astype(jnp.float32)
    out = jax.lax.conv_general_dilated(
        xr[:, None, :], kr[:, None, :],
        window_strides=(stride,), padding=[(0, 0)], lhs_dilation=(lhs_dilation,),
        precision=jax.lax.Precision.HIGHEST,
    )
    return jax.lax.complex(out[0, 0], out[0, 1])


# ---------------------------------------------------------------------------
# Toeplitz-matmul path

_MXU_FRAME = 128


def _toeplitz_taps(taps_rev: np.ndarray | jax.Array, frame: int, decim: int) -> jax.Array:
    """Tap matrix H[s, j] = taps_rev[s - j*decim] (zero outside range).

    Contracting a haloed input frame Z[i, s] (s over (frame-1)*decim + ntaps)
    against H yields y[i*frame + j] = sum_u taps_rev[u] * Z[i, j*decim + u].
    Built host-side once per (taps, frame, decim) combination.
    """
    t = np.asarray(taps_rev)
    ntaps = t.shape[0]
    srange = (frame - 1) * decim + ntaps
    H = np.zeros((srange, frame), dtype=t.dtype)
    for j in range(frame):
        H[j * decim : j * decim + ntaps, j] = t
    return jnp.asarray(H)


def _frame_with_halo(xfull: jax.Array, nframes: int, stride: int, srange: int) -> jax.Array:
    """Z[i, s] = xfull[i*stride + s] for i < nframes, s < srange, built from
    ceil(srange/stride) shifted reshapes instead of nframes dynamic slices
    (an unrolled per-frame stack put 16k+ slice ops in the graph at large
    batches and blew up trace/compile time)."""
    pieces = []
    for j in range(0, srange, stride):
        seg = jax.lax.dynamic_slice_in_dim(xfull, j, nframes * stride, 0)
        pieces.append(seg.reshape(nframes, stride))
    return jnp.concatenate(pieces, axis=1)[:, :srange] if len(pieces) > 1 \
        else pieces[0][:, :srange]


def _bf16_split(x: jax.Array):
    """(hi, lo) bf16 with hi + lo = x to ~2^-17: hi is x rounded to bf16
    (round to nearest even, done on the bits), lo the rounded remainder.
    Integer rounding instead of a float round trip matters: XLA's GPU
    compiler removes an f32 -> bf16 -> f32 conversion pair, which turns
    lo = x - f32(bf16(x)) into 0 (one bf16 pass)."""
    x = x.astype(jnp.float32)
    u = jax.lax.bitcast_convert_type(x, jnp.uint32)
    u = (u + jnp.uint32(0x7FFF) + ((u >> 16) & jnp.uint32(1))) \
        & jnp.uint32(0xFFFF0000)
    hi = jax.lax.bitcast_convert_type(u, jnp.float32)
    return hi.astype(jnp.bfloat16), (x - hi).astype(jnp.bfloat16)


def _mm_split3(a: jax.Array, b: jax.Array) -> jax.Array:
    """Float32 matmul as three bf16 tensor-core passes with float32
    accumulation, hi*hi + (hi*lo + lo*hi): ~2^-16 relative error on every
    backend. The passes are ordinary bf16 dots, which every backend and
    XLA's SPMD partitioner keep as written."""
    ahi, alo = _bf16_split(a)
    bhi, blo = _bf16_split(b)

    def d(p, q):
        return jnp.matmul(p, q, preferred_element_type=jnp.float32)

    return d(ahi, bhi) + (d(ahi, blo) + d(alo, bhi))


def _mxu_fir(xfull: jax.Array, taps_np: np.ndarray, n_out: int, decim: int,
             split3: bool = False) -> jax.Array:
    """Toeplitz-matmul FIR. xfull includes the ntaps-1 halo at the front.
    taps_np must be a host (static) array — the tap matrix is built at trace
    time. split3 runs the matmuls at the 3-pass bf16 precision
    (method="mxu3")."""
    taps_rev = np.asarray(taps_np)[::-1]
    ntaps = taps_rev.shape[0]
    frame = min(_MXU_FRAME, n_out)
    nframes = -(-n_out // frame)
    srange = (frame - 1) * decim + ntaps
    stride = frame * decim
    # the last reshape piece reads up to (ceil(srange/stride))*stride past
    # the final frame start — pad to cover it
    npieces = -(-srange // stride)
    need = max((nframes - 1) * stride + srange, (npieces - 1) * stride + nframes * stride)
    pad = need - xfull.shape[0]
    if pad > 0:
        xfull = jnp.pad(xfull, (0, pad))
    Z = _frame_with_halo(xfull, nframes, stride, srange)
    H = _toeplitz_taps(taps_rev, frame, decim)
    mm = _mm_split3 if split3 else functools.partial(
        jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    if _is_complex(Z) and not _is_complex(H):
        Hf = H.astype(jnp.float32)
        yr = mm(jnp.real(Z).astype(jnp.float32), Hf)
        yi = mm(jnp.imag(Z).astype(jnp.float32), Hf)
        y = jax.lax.complex(yr, yi).reshape(-1)
    elif _is_complex(Z) and _is_complex(H):
        zr, zi = jnp.real(Z).astype(jnp.float32), jnp.imag(Z).astype(jnp.float32)
        hr, hi = jnp.real(H).astype(jnp.float32), jnp.imag(H).astype(jnp.float32)
        yr = mm(zr, hr) - mm(zi, hi)
        yi = mm(zr, hi) + mm(zi, hr)
        y = jax.lax.complex(yr, yi).reshape(-1)
    else:
        # HIGHEST: a default-precision float32 matmul may run in bf16 or
        # TF32, too coarse for the chains' 60 dB gates
        y = mm(Z.astype(jnp.float32), H.astype(jnp.float32)).reshape(-1)
    return y[:n_out]


# ---------------------------------------------------------------------------
# FFT overlap-save path


def _pow2_at_least(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def fft_filter_full(xfull: jax.Array, taps: jax.Array, n_out: int, decim: int = 1,
                    fft_size: int | None = None) -> jax.Array:
    """Overlap-save convolution: y[k] = sum_t taps[t] xfull[ntaps-1+k-t].

    xfull carries the ntaps-1 halo at the front; returns n_out samples
    (post-decimation if decim > 1). Segments the batch into FFT blocks of
    `fft_size` with ntaps-1 overlap, batched FFT over segments (XLA's
    float32 FFT pair).
    """
    ntaps = taps.shape[0]
    n_lin = n_out * decim  # linear-convolution outputs needed before decimation
    complex_stream = _is_complex(xfull) or _is_complex(taps)
    if fft_size is None:
        # 8x the taps keeps 7/8 of each segment useful; on an H100 it was
        # the fastest segment for 1024 taps on a 2^21-sample batch (PERF.md)
        fft_size = min(_pow2_at_least(8 * ntaps),
                       _pow2_at_least(n_lin + ntaps - 1))
    step = fft_size - (ntaps - 1)
    nseg = -(-n_lin // step)
    npieces = -(-fft_size // step)
    need = max((nseg - 1) * step + fft_size, (npieces - 1) * step + nseg * step)
    pad = need - xfull.shape[0]
    if pad > 0:
        xfull = jnp.pad(xfull, (0, pad))
    segs = _frame_with_halo(xfull, nseg, step, fft_size)
    # Under a graph mesh, re-pin the segment matrix: without this, XLA's
    # CPU backend assigns the partitioned FFT operand a layout its fft
    # thunk rejects (LayoutUtil::IsMonotonicWithDim0Major RET_CHECK).
    from newsched_tpu.runtime import meshctx

    segs = meshctx.pin_leading(segs)
    complex_in = complex_stream
    if complex_in:
        H = jnp.fft.fft(taps.astype(jnp.complex64), fft_size)
        Y = jnp.fft.ifft(jnp.fft.fft(segs.astype(jnp.complex64), axis=-1) * H, axis=-1)
        y = Y[:, ntaps - 1 :].reshape(-1)[:n_lin]
        y = y.astype(jnp.complex64)
    else:
        H = jnp.fft.rfft(taps.astype(jnp.float32), fft_size)
        Y = jnp.fft.irfft(jnp.fft.rfft(segs.astype(jnp.float32), axis=-1) * H, n=fft_size, axis=-1)
        y = Y[:, ntaps - 1 :].reshape(-1)[:n_lin].astype(jnp.float32)
    if decim > 1:
        y = y[::decim]
    return y


# ---------------------------------------------------------------------------
# public entry point


def fir_filter(
    taps: jax.Array,
    state: FirState,
    x: jax.Array,
    decim: int = 1,
    method: str = "auto",
    fft_size: int | None = None,
) -> tuple[FirState, jax.Array]:
    """Filter one batch, threading streaming state.

    Args:
      taps: (ntaps,) float32 or complex64 coefficients (h[0] first).
      state: FirState carrying the previous batch's tail.
      x: (B,) input batch; B must be a multiple of decim.
      decim: keep every decim-th output (decimating FIR).
      method: "auto" | "mxu" | "conv" | "fft".

    Returns (new_state, y) with y of length B // decim.
    """
    # "Static" taps (host numpy/list) allow building the Toeplitz tap matrix
    # at trace time. Device jax Arrays are NOT treated as static even when
    # concrete: pulling them back mid-trace would be a host transfer.
    taps_static = not isinstance(taps, jax.Array)
    taps_np = np.asarray(taps) if taps_static else None
    taps = jnp.asarray(taps)
    ntaps = int(taps.shape[0])
    B = int(x.shape[0])
    if B % decim != 0:
        raise ValueError(f"batch size {B} not divisible by decimation {decim}")
    n_out = B // decim
    xfull = jnp.concatenate([state.tail, x]) if ntaps > 1 else x
    if method == "auto":
        # The Toeplitz matmul turns the filter into matrix-unit work; guard
        # against extreme decimation, where the tap matrix goes nearly
        # empty and the haloed frames re-read the input decim-fold.
        if ntaps > 384:
            method = "fft"
        elif taps_static and decim <= max(4, ntaps // 8):
            method = "mxu"
        else:
            method = "conv"
    if method in ("mxu", "mxu3") and not taps_static:
        method = "conv"  # traced taps: tap matrix can't be built at trace time
    if method in ("mxu", "mxu3"):
        y = _mxu_fir(xfull, taps_np, n_out, decim, split3=(method == "mxu3"))
    elif method == "conv":
        y = _conv1d(xfull, taps[::-1], stride=decim)
        y = y[:n_out]
    elif method == "fft":
        y = fft_filter_full(xfull, taps, n_out, decim, fft_size=fft_size)
    else:
        raise ValueError(f"unknown FIR method {method!r}")
    new_tail = xfull[-(ntaps - 1) :] if ntaps > 1 else state.tail
    return FirState(tail=new_tail), y


def fir_interp_filter(
    taps: jax.Array, state: FirState, x: jax.Array, interp: int, decim: int = 1,
) -> tuple[FirState, jax.Array]:
    """Polyphase rational resampling FIR: upsample by `interp`, filter, keep
    every `decim`-th output (scipy.signal.upfirdn semantics, streaming).

    y[m] = sum_t taps[t] * xu[m*decim - t] where xu is the zero-stuffed input.
    State carries ceil((ntaps-1)/interp) raw input samples so that every
    upsampled history sample the kernel can reach is available.
    Output length = B * interp // decim (requires B*interp % decim == 0).
    """
    if interp == 1:
        # upfirdn with no upsampling IS a decimating FIR, and the state
        # contract (ntaps-1 raw samples) coincides exactly.
        return fir_filter(taps, state, x, decim=decim, method="auto")
    taps = jnp.asarray(taps)
    ntaps = int(taps.shape[0])
    B = int(x.shape[0])
    if (B * interp) % decim != 0:
        raise ValueError(f"B*interp ({B}*{interp}) not divisible by decim {decim}")
    n_out = B * interp // decim
    hist = int(state.tail.shape[0])  # raw-domain history samples
    xfull = jnp.concatenate([state.tail, x])
    # Polyphase decomposition (the reference's actual rational_resampler
    # algorithm): output
    # phase r = m mod interp uses tap subset h_p[l] = taps[l*interp + p]
    # with p = (r*decim) % interp, as a plain decimate-by-`decim`
    # correlation over the RAW input ending at
    #   k_m = hist + (m*decim - p) / interp.
    # Derivation: y[m] = sum_t taps[t] xu[hist*interp + m*decim - t] over
    # the zero-stuffed xu; nonzero terms need t = l*interp + p.
    L = -(-ntaps // interp)  # taps per phase (zero-padded)
    tpad = jnp.pad(taps, (0, L * interp - ntaps))
    nmax = -(-n_out // interp)  # outputs per phase (last may be trimmed)
    phases = []
    for r in range(interp):
        p = (r * decim) % interp
        h = tpad[p::interp]  # (L,) phase taps, h[l] = taps[l*interp + p]
        o_r = hist + (r * decim - p) // interp
        # correlation window for outputs j=0..nmax-1 ends at o_r + j*decim:
        # rows xfull[o_r + j*decim - (L-1) .. o_r + j*decim]
        start = o_r - (L - 1)
        stop = o_r + (nmax - 1) * decim + 1
        pad = max(0, stop - int(xfull.shape[0]))
        seg_src = jnp.pad(xfull, (0, pad)) if pad else xfull
        seg = jax.lax.dynamic_slice_in_dim(seg_src, start, stop - start, 0)
        y_r = _conv1d(seg, h[::-1], stride=decim)[:nmax]
        phases.append(y_r)
    y = jnp.stack(phases, axis=1).reshape(-1)[:n_out]
    new_tail = xfull[-hist:] if hist > 0 else state.tail
    return FirState(tail=new_tail), y


def resampler_init_state(ntaps: int, interp: int, dtype=jnp.complex64) -> FirState:
    """History length: ceil((ntaps-1)/interp) raw samples."""
    hist = -(-(ntaps - 1) // interp) if ntaps > 1 else 0
    return FirState(tail=jnp.zeros((hist,), dtype=dtype))
