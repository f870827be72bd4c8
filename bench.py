"""Benchmark of the three flagship chains on one GPU.

Every cell runs a model of ``newsched_tpu.models`` through its normal path
(Flowgraph -> compile_flowgraph -> the compiled per-batch step) at the
widths of the BASELINE.json configurations, and every cell is gated first:
several batches through ``fg.run()`` must match a float64 golden at >= 60 dB
SNR, so state carried across batches is checked too.

  fm_replay   config #2: 64-channel channelizer, fused chain, planes rows
              replayed from device memory (the headline cell)
  fm_live     config #2, noise generated per batch (ops/noise.py)
  fm_staged   config #2 as the staged graph: pfb_channelizer ->
              vector_quad_demod -> vector_fir, complex samples replayed
  wbfm_*      config #1 wideband FM receiver: staged, fused, live
  fir_*       config #0 128-tap FIR chain: staged, live

The rate is input samples per second: the host clock around K dependent
steps (one jitted lax.scan, the program Runner._run_scan runs) ending in
block_until_ready, after a warm-up call, best of REPS. One JSON line per
cell goes to stdout, then a summary line; every line names the device.
A cell that fails its gate or raises fails the run (exit code 1).

Run: ``python bench.py`` on a machine with a CUDA GPU (it refuses to run
anywhere else). ``--breakdown`` also traces 10 steps of each cell and
prints the device's busy share and its costliest ops (traces under
``<checkout>/.traces``).
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import Callable

import numpy as np

NCHANS = 64
TAPS_PER_ARM = 16
AUDIO_DECIM = 8
AUDIO_NTAPS = 65
DEMOD_GAIN = 0.5
BATCH = 1 << 21  # wideband samples per step
GATE_BATCHES = 3  # batches each correctness gate streams
GATE_DB = 60.0
K = 100  # steps per timed call
REPS = 5


def log(*a):
    print(*a, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Cell:
    name: str
    precision: str  # the signal path's matmul precision, in words
    samples_per_step: int
    gate: Callable[[], float]  # SNR (dB) of GATE_BATCHES batches vs golden
    run_k: Callable[[int], object]  # K compiled steps -> per-step checksums


def _design():
    from newsched_tpu.ops import firdes

    taps = firdes.prototype_channelizer_taps(NCHANS, TAPS_PER_ARM)
    audio_taps = firdes.low_pass(1.0, 1.0, 0.4 / AUDIO_DECIM, 0.1 / AUDIO_DECIM,
                                 ntaps=AUDIO_NTAPS)
    return taps, audio_taps


def rows_reference(rows: np.ndarray, taps, audio_taps,
                   return_risk: bool = False):
    """Float64 golden model of the chain over PLANES ROWS (the fused
    chain's native stream format; zero pre-stream history and state),
    mirroring ops/pfb.py + demod + per-channel audio FIR exactly.

    return_risk additionally returns a boolean audio-sample mask of
    BRANCH-CUT-AMBIGUOUS outputs: demodulating pure noise occasionally
    lands within the compute error floor of the atan2 +-pi cut (or in a
    deep |conj(prev)*Y| null), where golden and chain legitimately
    disagree by ~2*pi — an inherent ambiguity of FM-demodulating noise,
    not a chain error (any two backends disagree there). The mask covers
    the audio FIR footprint of each risky channel sample; the gate logs
    its count."""
    import scipy.signal as sig

    from newsched_tpu.ops.pfb import pfb_arm_taps

    M = NCHANS
    arm = pfb_arm_taps(taps.astype(np.float64), M)  # (M, L)
    L = arm.shape[1]
    C = rows[:, :M].astype(np.float64) + 1j * rows[:, M:].astype(np.float64)
    n_out = C.shape[0]
    V = np.concatenate([np.zeros((L - 1, M), np.complex128), C],
                       axis=0)[:, ::-1].T  # U[p, i]
    filt = np.empty((M, n_out), np.complex128)
    for p in range(M):
        filt[p] = np.correlate(V[p], arm[p][::-1], mode="valid")[:n_out]
    Y = (M * np.fft.ifft(filt, axis=0)).T  # (n_out, M)
    prev = np.vstack([np.zeros((1, M), np.complex128), Y[:-1]])
    P = np.conj(prev) * Y
    # Convention: demod against zero history emits exactly 0 (otherwise the
    # result is a signed-zero artifact — atan2(+-0, +-0) lands anywhere in
    # {0, +-pi} depending on bit signs, which no two backends agree on).
    aud = np.where((prev == 0) | (Y == 0), 0.0, np.angle(P)) * DEMOD_GAIN
    out = np.empty((n_out // AUDIO_DECIM, M), np.float64)
    for c in range(M):
        out[:, c] = sig.lfilter(audio_taps.astype(np.float64), [1.0], aud[:, c])[::AUDIO_DECIM]
    if not return_risk:
        return out
    med = np.median(np.abs(P))
    risk = ((np.abs(P.imag) < 3e-4 * np.maximum(np.abs(P.real), med * 1e-2))
            & (P.real < 0)) | (np.abs(P) < 1e-3 * med)
    A = len(audio_taps)
    spread = sig.lfilter(np.ones(A), [1.0], risk.astype(np.float64), axis=0)
    bad = (spread > 0)[::AUDIO_DECIM][: out.shape[0]]
    return out, bad


def snr_db(ref, test):
    ref = np.asarray(ref)
    test = np.asarray(test)
    dt = np.complex128 if np.iscomplexobj(ref) or np.iscomplexobj(test) \
        else np.float64
    ref = ref.astype(dt)
    err = ref - test.astype(dt)
    p = np.mean(np.abs(ref) ** 2)
    e = np.mean(np.abs(err) ** 2)
    return np.inf if e == 0 else 10 * np.log10(p / e)


def _masked_snr(label, rows, got, taps, audio_taps):
    ref, bad = rows_reference(rows, taps, audio_taps, return_risk=True)
    got = np.asarray(got)[: ref.shape[0]]
    log(f"{label}: {int(bad.sum())} of {bad.size} audio samples masked as "
        f"atan2-branch-cut-ambiguous")
    return snr_db(ref[~bad], got[~bad])


def _runner(fg, batch_items: int):
    """run_k for a flowgraph: K compiled steps under one jitted lax.scan,
    returning the per-step sink checksums."""
    import functools

    import jax

    from newsched_tpu.runtime.compile import compile_flowgraph
    from newsched_tpu.utils import cplx

    fg.validate()
    cfg = compile_flowgraph(fg, batch_size=batch_items)
    step = cfg.step
    params_enc = cplx.encode(cfg.init_params())

    @functools.partial(jax.jit, static_argnames=("k_steps",))
    def run_k(params_enc, k_steps):
        params = cplx.decode(params_enc)

        def body(states, _):
            ns, sink_out = step(states, params)
            (chk,) = list(sink_out.values())
            return ns, chk

        _, sums = jax.lax.scan(body, cfg.init_states(), xs=None,
                               length=k_steps)
        return sums

    return lambda k: run_k(params_enc, k)


def fm_cells(batch: int = BATCH) -> list[Cell]:
    """Config #2 three ways: fused replay, fused live, staged replay."""
    from newsched_tpu import models
    from newsched_tpu.blocks import general
    from newsched_tpu.parallel.channelizer import planes_rows

    taps, audio_taps = _design()
    M = NCHANS
    B = max(batch // (M * AUDIO_DECIM), 1) * M * AUDIO_DECIM
    rng = np.random.default_rng(0)
    xc = (rng.standard_normal(B) + 1j * rng.standard_normal(B)).astype(np.complex64) * 0.5
    rows = planes_rows(xc, M)  # (B//M, 2M) f32
    n_aud = B // M // AUDIO_DECIM
    kw = dict(nchans=M, taps_per_arm=TAPS_PER_ARM, audio_decim=AUDIO_DECIM,
              deviation_frac=1.0 / (2 * np.pi * DEMOD_GAIN),
              audio_taps=audio_taps)

    def replay_graph(sink, n_samples=None):
        src = general.vector_source(rows, repeat=True, dtype="rf32",
                                    vlen=(2 * M,))
        return models.fm_channelizer(source=src, batch_size=B, sink=sink,
                                     n_samples=n_samples, fused=True, **kw)

    def replay_gate():
        fg, b = replay_graph("vector", GATE_BATCHES * n_aud)
        fg.run()
        return _masked_snr("fm_replay", np.tile(rows, (GATE_BATCHES, 1)),
                           b["sink"].data(), taps, audio_taps)

    def live_graph(sink, n_samples=None):
        return models.fm_channelizer(source="live", batch_size=B, sink=sink,
                                     n_samples=n_samples, fused=True, **kw)

    def live_gate():
        import jax
        import jax.numpy as jnp

        from newsched_tpu.ops.noise import pure_rows

        fg, b = live_graph("vector", GATE_BATCHES * n_aud)
        fg.run()
        z = jnp.zeros((), jnp.int32)
        # the live source's stream: seed 0, amplitude 0.5 (models defaults)
        gold_rows = 0.5 * np.asarray(jax.device_get(
            pure_rows(0, z, z, GATE_BATCHES * B // M, 2 * M)))
        return _masked_snr("fm_live", gold_rows, b["sink"].data(), taps,
                           audio_taps)

    def staged_graph(sink, n_samples=None):
        src = general.vector_source(xc, repeat=True)
        return models.fm_channelizer(source=src, batch_size=B, sink=sink,
                                     n_samples=n_samples, fused=False, **kw)

    def staged_gate():
        fg, b = staged_graph("vector", GATE_BATCHES * n_aud)
        fg.run()
        return _masked_snr("fm_staged",
                           planes_rows(np.tile(xc, GATE_BATCHES), M),
                           b["sink"].data(), taps, audio_taps)

    fused_prec = "DFT HIGHEST (float32); fold, demod, audio FIR float32 FMAs"
    return [
        Cell("fm_replay", fused_prec, B, replay_gate,
             _runner(replay_graph("null")[0], B // M)),
        Cell("fm_live", fused_prec, B, live_gate,
             _runner(live_graph("null")[0], B // (M * AUDIO_DECIM))),
        Cell("fm_staged", "PFB fold float32 + XLA FFT; audio FIR Toeplitz "
             "matmul HIGHEST (float32)", B, staged_gate,
             _runner(staged_graph("null")[0], B)),
    ]


def _fxpt_tone(n: int, dphase: int) -> np.ndarray:
    """The fxpt NCO's tone in float64: phase k*dphase mod 2^32."""
    idx = np.arange(n, dtype=np.uint64)
    ph = 2 * np.pi * (((idx * np.uint64(dphase)) & np.uint64(0xFFFFFFFF)
                       ).astype(np.float64) / 2.0 ** 32)
    return np.exp(1j * ph)


def wbfm_cells(batch: int = BATCH) -> list[Cell]:
    """Config #1: the staged, fused and live receivers. The test tone is a
    nonzero-frequency fxpt NCO whose phase advances every step, so XLA
    cannot hoist the source out of the scan."""
    import scipy.signal as sig

    from newsched_tpu import models
    from newsched_tpu.blocks import analog
    from newsched_tpu.ops import firdes, nco

    fs, fc, D, Rd, dev = 1e6, 200e3, 4, 5, 75e3
    tone = 231_250.0  # 31.25 kHz into the 100 kHz channel: nonzero audio
    B = max(batch // (D * Rd), 1) * D * Rd
    chan_taps = firdes.low_pass(1.0, fs, 100e3, 30e3)
    rt = firdes.low_pass(1.0, 1.0, 0.45 / Rd, 0.1 / Rd)
    gain = (fs / D) / (2 * np.pi * dev)
    dp_tone = int(nco.freq_to_dphase(tone, fs))
    dp_fc = int(nco.freq_to_dphase(fc, fs))

    def graph(kind, sink, n_samples=None):
        src = ("live" if kind == "live"
               else analog.sig_source(fs, "complex", frequency=tone))
        fg, blks = models.wbfm_receiver(
            fs=fs, center_freq=fc, quad_rate_decim=D, audio_decim=(1, Rd),
            deviation=dev, source=src, batch_size=B, sink=sink,
            n_samples=n_samples, fused=(kind != "staged"))
        if kind == "live":
            blks["source"].set_param("dphase", np.uint32(dp_tone))
        return fg, blks

    def gate(kind):
        n = GATE_BATCHES * B
        fg, blks = graph(kind, "vector", n // (D * Rd))
        fg.run()
        got = np.asarray(blks["sink"].data())
        acc = (np.arange(n, dtype=np.uint64) * np.uint64(dp_fc)) & np.uint64(0xFFFFFFFF)
        rot = np.exp(-2j * np.pi * (acc.astype(np.float64) / 2.0 ** 32))
        u = sig.lfilter(np.asarray(chan_taps, np.complex128), 1.0,
                        _fxpt_tone(n, dp_tone) * rot)[::D]
        up = np.concatenate([[0.0], u[:-1]])
        p = np.conj(up) * u
        d = np.where((up == 0) | (u == 0), 0.0, np.angle(p)) * gain
        ref = sig.lfilter(np.asarray(rt, np.float64), 1.0, d)[::Rd]
        return snr_db(ref[: len(got)], got)

    prec = "FIRs as Toeplitz matmuls at HIGHEST (float32)"
    return [Cell(f"wbfm_{kind}", prec, B, (lambda k=kind: gate(k)),
                 _runner(graph(kind, "null")[0],
                         B // (D * Rd) if kind == "live" else B))
            for kind in ("staged", "fused", "live")]


def fir_cells(batch: int = BATCH) -> list[Cell]:
    """Config #0: sig_source -> 128-tap FIR as the staged graph, and the
    one-block live source (fir_tone_source)."""
    import scipy.signal as sig

    from newsched_tpu import models
    from newsched_tpu.ops import firdes, nco

    fs, freq, ntaps = 1e6, 123_456.0, 128
    B = batch
    taps = firdes.low_pass(1.0, fs, 0.2 * fs, 0.05 * fs, ntaps=ntaps)

    def graph(kind, sink, n_samples):
        return models.fir_chain(n_samples=n_samples, fs=fs, ntaps=ntaps,
                                frequency=freq, batch_size=B, sink=sink,
                                source=kind)

    def gate(kind):
        n = GATE_BATCHES * B
        fg, b = graph(kind, "vector", n)
        fg.run()
        got = np.asarray(b["sink"].data())
        ref = sig.lfilter(np.asarray(taps, np.float64), [1.0],
                          _fxpt_tone(n, int(nco.freq_to_dphase(freq, fs))))
        return snr_db(ref[: len(got)], got)

    prec = "FIR Toeplitz matmul split3 (3 bf16 passes on a bit-level hi/lo split)"
    return [Cell(f"fir_{name}", prec, B, (lambda k=kind: gate(k)),
                 _runner(graph(kind, "null", B * 1000)[0], B))
            for name, kind in (("staged", None), ("live", "live"))]


def all_cells(batch: int = BATCH) -> list[Cell]:
    return fm_cells(batch) + wbfm_cells(batch) + fir_cells(batch)


def steady_rate(cell: Cell, k: int = K, reps: int = REPS) -> float:
    """Input samples/s: best of `reps` timed calls of k steps each, after
    a warm-up call that compiles."""
    import jax

    sums = cell.run_k(k)
    jax.block_until_ready(sums)
    if not np.all(np.isfinite(np.asarray(sums))):
        raise FloatingPointError(f"{cell.name}: non-finite checksums")
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(cell.run_k(k))
        best = min(best, time.perf_counter() - t0)
    return cell.samples_per_step * k / best


def device_breakdown(cell: Cell, trace_dir: str, k: int = 10):
    """Device time of one traced call of k steps (compiled beforehand):
    returns (window_s, busy_s, [(op name, seconds), ...] by time). Busy is
    the union of the device's op intervals; the window runs from the
    first op's start to the last op's end."""
    import glob
    import os

    import jax

    jax.block_until_ready(cell.run_k(k))
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(cell.run_k(k))
    path = max(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                         recursive=True), key=os.path.getmtime)
    data = jax.profiler.ProfileData.from_file(path)
    spans, per_op = [], {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU:0"):
            continue
        for line in plane.lines:
            # the stream lines hold the kernels; skip XLA's op/module
            # summary lines, which repeat the same time
            if "Stream" not in line.name:
                continue
            for ev in line.events:
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                per_op[ev.name] = per_op.get(ev.name, 0) + ev.duration_ns
    if not spans:
        raise RuntimeError(f"{cell.name}: no device ops in the trace")
    spans.sort()
    busy, end = 0, spans[0][0]
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = spans[-1][1] - spans[0][0]
    ops = sorted(((n, t * 1e-9) for n, t in per_op.items()),
                 key=lambda x: -x[1])
    return window * 1e-9, busy * 1e-9, ops


def device_info() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def main(argv=None):
    import argparse
    import os

    from newsched_tpu.utils.platform import enable_compile_cache, require_gpu

    ap = argparse.ArgumentParser(description="SNR-gated benchmark cells")
    ap.add_argument("--breakdown", action="store_true",
                    help="trace each cell and print its device time by op")
    args = ap.parse_args(argv)
    enable_compile_cache()
    require_gpu()
    dev = device_info()
    rates = {}
    for cell in all_cells():
        g = cell.gate()
        log(f"{cell.name}: SNR vs float64 golden = {g:.1f} dB over "
            f"{GATE_BATCHES} batches (gate >= {GATE_DB:.0f})")
        if not g >= GATE_DB:
            raise SystemExit(f"{cell.name}: SNR gate failed ({g:.1f} dB)")
        rates[cell.name] = steady_rate(cell)
        print(json.dumps({"cell": cell.name,
                          "value": rates[cell.name] / 1e6,
                          "unit": "Msamples/s", "snr_db": g,
                          "precision": cell.precision, "device": dev}),
              flush=True)
        if args.breakdown:
            win, busy, ops = device_breakdown(cell, os.path.join(
                os.path.dirname(os.path.abspath(__file__)), ".traces",
                cell.name))
            log(f"{cell.name}: 10-step window {win * 1e6:.1f} us, device "
                f"busy {100 * busy / win:.1f}%; per step:")
            for name, t in ops[:6]:
                log(f"    {t / 10 * 1e6:8.1f} us  {name[:100]}")
    print(json.dumps({"metric": "fm_channelizer_64ch_flowgraph_throughput",
                      "value": rates["fm_replay"] / 1e6,
                      "unit": "Msamples/s",
                      "cells": {k: v / 1e6 for k, v in rates.items()},
                      "device": dev}))


if __name__ == "__main__":
    main()
