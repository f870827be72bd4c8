"""Smoke run of the flowgraph runtime on NVIDIA GPUs.

    python chip_smoke.py          # one card: the three flagship chains
    python chip_smoke.py --four   # four cards: the sharded paths only

One card: every cell of bench.py — the 64-channel FM channelizer (fused
replay, live, staged), the wideband FM receiver (staged, fused, live) and
the 128-tap FIR chain (staged, live) — runs at full width through
Flowgraph -> compile_flowgraph -> the compiled step. Each first streams
several batches through fg.run() against its float64 golden (>= 60 dB),
then reports its steady rate. A last phase runs the on-card test tier
(tests_gpu/) in this process.

--four: fg.run(mesh=make_mesh(4)) of the fused and live FM channelizer,
the fused and live wbfm receiver and the live FIR chain, and the
256-channel ShardedFMChannelizer (ppermute halo + all_to_all corner turn),
each against the same chain on one card (> 100 dB).

The first line is the card's name and power limit, the last a JSON object
with the device JAX reports. Any failed phase makes the exit code 1; with
no GPU the script exits 2 before printing a result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback


def card_line() -> str:
    """nvidia-smi's name and power limit, read by a child process that
    does not touch the card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()[:200]}"


def one_card_phases(card: str):
    """(name, fn) pairs; each fn prints its result and raises on failure."""
    import bench

    def cell_phase(cell):
        def run():
            g = cell.gate()
            ok = g >= bench.GATE_DB
            rate = bench.steady_rate(cell) / 1e6 if ok else float("nan")
            print(f"{cell.name}: SNR {g:.1f} dB vs float64 golden over "
                  f"{bench.GATE_BATCHES} batches (gate >= {bench.GATE_DB:.0f})"
                  f"; precision: {cell.precision}; steady {rate:.1f} "
                  f"Msamples/s on {card}", flush=True)
            if not ok:
                raise AssertionError(f"{cell.name}: SNR gate failed")
        return run

    def dispatch():
        import jax
        import jax.numpy as jnp
        import numpy as np

        f = jax.jit(lambda v: v + 1.0)
        v = jnp.zeros((), jnp.float32)
        f(v).block_until_ready()
        ts = []
        for _ in range(200):
            t0 = time.perf_counter()
            f(v).block_until_ready()
            ts.append(time.perf_counter() - t0)
        print(f"dispatch: a trivial jitted call with block_until_ready takes "
              f"{np.median(ts) * 1e6:.1f} us (median of 200) on {card}",
              flush=True)

    def gpu_tier():
        import pytest

        rc = pytest.main(["-q", "-p", "no:cacheprovider", "tests_gpu"])
        print(f"tests_gpu: pytest exit code {int(rc)}", flush=True)
        if rc != 0:
            raise AssertionError(f"tests_gpu failed (exit code {int(rc)})")

    return ([(c.name, cell_phase(c)) for c in bench.all_cells()]
            + [("dispatch", dispatch), ("tests_gpu", gpu_tier)])


def four_card_phases(n_dev: int = 4, batch: int = 1 << 21):
    """The sharded paths, each against its one-card run. `batch` is in
    wideband samples; tests rehearse this at small sizes on virtual CPU
    devices."""
    import numpy as np

    import bench
    from newsched_tpu import models
    from newsched_tpu.blocks import general
    from newsched_tpu.ops import firdes
    from newsched_tpu.parallel import ShardedFMChannelizer, make_mesh
    from newsched_tpu.parallel.channelizer import planes_rows

    mesh = make_mesh(n_dev)
    rng = np.random.default_rng(0)
    M, decim = 64, 8
    ataps = firdes.low_pass(1.0, 1.0, 0.4 / decim, 0.1 / decim, ntaps=65)

    def compare(name, run, noise_rows=None):
        """noise_rows: the FM input rows, whose branch-cut-ambiguous audio
        samples (bench.rows_reference) are left out: there two float32
        evaluations of the same noise may demod 2*pi apart."""
        def phase():
            a = np.asarray(run(None))
            b = np.asarray(run(mesh))
            if a.shape != b.shape:
                raise AssertionError(f"{name}: shapes {a.shape} vs {b.shape}")
            note = ""
            if noise_rows is not None:
                _, bad = bench.rows_reference(noise_rows(), bench._design()[0],
                                              ataps, return_risk=True)
                a, b = a[~bad], b[~bad]
                note = f", {int(bad.sum())} branch-cut samples masked"
            s = bench.snr_db(a, b)
            print(f"{name}: {n_dev}-card mesh vs one card over 2 batches "
                  f"{a.shape}{note}: {s:.1f} dB (gate > 100)", flush=True)
            if not s > 100:
                raise AssertionError(f"{name}: {s:.1f} dB")
        return name, phase

    x = (rng.standard_normal(2 * batch)
         + 1j * rng.standard_normal(2 * batch)).astype(np.complex64) * 0.5
    rows = planes_rows(x, M)

    def fm_fused(m):
        src = general.vector_source(rows, dtype="rf32", vlen=(2 * M,))
        fg, b = models.fm_channelizer(
            nchans=M, audio_decim=decim, n_samples=2 * batch // (M * decim),
            source=src, batch_size=batch, sink="vector", fused=True,
            audio_taps=ataps)
        fg.run(mesh=m)
        return b["sink"].data()

    def fm_live(m):
        fg, b = models.fm_channelizer(
            nchans=M, audio_decim=decim, n_samples=2 * batch // (M * decim),
            source="live", batch_size=batch, sink="vector", fused=True,
            audio_taps=ataps)
        fg.run(mesh=m)
        return b["sink"].data()

    wb = batch // (20 * n_dev) * 20 * n_dev  # whole audio items per card

    def wbfm(live):
        def run(m):
            src = "live" if live else general.vector_source(x[:2 * wb])
            fg, b = models.wbfm_receiver(
                fs=1e6, center_freq=0.21e6, n_samples=2 * wb // 20,
                source=src, batch_size=wb, sink="vector", fused=True)
            if live:
                b["source"].set_frequency(0.23e6)
            fg.run(mesh=m)
            return b["sink"].data()
        return run

    def fir_live(m):
        fg, b = models.fir_chain(n_samples=2 * batch, batch_size=batch,
                                 sink="vector", source="live")
        fg.run(mesh=m)
        return b["sink"].data()

    def sharded_256():
        M4, L4, d4 = 256, 4, 4
        taps = firdes.prototype_channelizer_taps(M4, L4)
        at = firdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=17)
        B = max(batch // (n_dev * M4 * d4), 1) * n_dev * M4 * d4
        xs = x[:2 * B]

        def run(m):
            import jax
            import jax.numpy as jnp

            ch = ShardedFMChannelizer(m, M4, taps, at, audio_decim=d4,
                                      demod_gain=0.7)
            st = ch.init_state()
            step = jax.jit(ch.step)
            outs = []
            for i in range(2):
                xb = jax.device_put(jnp.asarray(xs[i * B:(i + 1) * B]),
                                    ch.input_sharding())
                aud, st = step(xb, st)
                outs.append(np.asarray(aud))
            return np.concatenate(outs)

        a, b = run(make_mesh(1)), run(mesh)
        s = bench.snr_db(a, b)
        print(f"ShardedFMChannelizer 256 ch (ppermute halo + all_to_all "
              f"corner turn) on {n_dev} cards vs one card over 2 batches "
              f"{a.shape}: {s:.1f} dB (gate > 100)", flush=True)
        if not (a.shape == b.shape and s > 100):
            raise AssertionError(f"ShardedFMChannelizer 256 ch: {s:.1f} dB")

    def live_rows():
        import jax
        import jax.numpy as jnp

        from newsched_tpu.ops.noise import pure_rows

        z = jnp.zeros((), jnp.int32)
        # the live source's stream: seed 0, amplitude 0.5
        return 0.5 * np.asarray(jax.device_get(
            pure_rows(0, z, z, 2 * batch // M, 2 * M)))

    return [compare("fm_fused", fm_fused, lambda: rows),
            compare("fm_live", fm_live, live_rows),
            compare("wbfm_fused", wbfm(False)),
            compare("wbfm_live", wbfm(True)),
            compare("fir_live", fir_live),
            ("sharded_256ch", sharded_256)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run the sharded paths on four cards, and nothing else")
    args = p.parse_args(argv)
    card = card_line()
    print(card, flush=True)

    import jax

    from newsched_tpu.utils.platform import enable_compile_cache, require_gpu

    enable_compile_cache()
    try:
        require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    n_need = 4 if args.four else 1
    if len(jax.devices()) < n_need:
        print(f"chip_smoke: needs {n_need} GPUs, JAX sees "
              f"{len(jax.devices())}", file=sys.stderr)
        return 2
    phases = four_card_phases() if args.four else one_card_phases(card)
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
        print(f"[{name}: {time.perf_counter() - t0:.1f} s]", file=sys.stderr,
              flush=True)
    if failed:
        print(f"chip_smoke: FAILED phases: {failed}", file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
