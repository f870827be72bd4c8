"""Multi-device flagship (BASELINE config #4): the fused FM-channelizer
chain running PER TIME SHARD on a device mesh, with one input-rows
``ppermute`` halo per batch and the chain's lead-in recomputed from it
instead of cross-shard state — audio stays time-sharded, no corner turn.

Needs 8 devices: on a machine with fewer accelerators run it on the
simulated CPU mesh (``JAX_PLATFORMS=cpu python
examples/sharded_channelizer.py``; the flag below gives the CPU backend 8
devices). Checks sharded output against the unsharded staged reference to
> 100 dB.
"""

import os

if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from newsched_tpu.ops import firdes  # noqa: E402
from newsched_tpu.parallel import ShardedFMChannelizer, make_mesh  # noqa: E402
from newsched_tpu.parallel.channelizer import planes_rows  # noqa: E402

from newsched_tpu.utils.platform import enable_compile_cache  # noqa: E402

M, DECIM, N_DEV = 32, 4, 8


def main():
    enable_compile_cache()
    if len(jax.devices()) < N_DEV:
        raise SystemExit(f"needs {N_DEV} devices, JAX sees "
                         f"{len(jax.devices())}: run with JAX_PLATFORMS=cpu")
    taps = firdes.prototype_channelizer_taps(M, taps_per_arm=8)
    audio_taps = firdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=33)
    mesh = make_mesh(N_DEV)
    ch = ShardedFMChannelizer(mesh, M, taps, audio_taps, audio_decim=DECIM,
                              demod_gain=0.8)

    n_rows = N_DEV * 256          # planes rows per batch (= rows of M samples)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(2 * n_rows * M)
         + 1j * rng.standard_normal(2 * n_rows * M)).astype(np.complex64) * 0.5
    rows = planes_rows(x, M)

    state = ch.init_state_planes(n_rows)
    step = jax.jit(ch.step_planes)
    outs = []
    for b in range(2):
        xb = jax.device_put(jnp.asarray(rows[b * n_rows:(b + 1) * n_rows]),
                            ch.planes_input_sharding())
        audio, state = step(xb, state)
        outs.append(np.asarray(audio))
    audio = np.concatenate(outs, axis=0)

    # unsharded staged reference (1-device mesh, ordinary complex API)
    ref_ch = ShardedFMChannelizer(make_mesh(1), M, taps, audio_taps,
                                  audio_decim=DECIM, demod_gain=0.8)
    rstate = ref_ch.init_state()
    rstep = jax.jit(ref_ch.step)
    refs = []
    B = n_rows * M
    for b in range(2):
        raud, rstate = rstep(jnp.asarray(x[b * B:(b + 1) * B]), rstate)
        refs.append(np.asarray(raud))
    ref = np.concatenate(refs, axis=0)

    err = np.asarray(audio, np.float64) - np.asarray(ref, np.float64)
    snr = 10 * np.log10(np.mean(ref.astype(np.float64) ** 2)
                        / max(np.mean(err ** 2), 1e-300))
    print(f"sharded fused-chain audio {audio.shape} over {N_DEV} devices; "
          f"SNR vs unsharded staged reference: {snr:.1f} dB")
    assert snr > 100, snr


if __name__ == "__main__":
    main()
