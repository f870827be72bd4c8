"""Multi-HOST validation (SURVEY.md §6 distributed-comm row, §5
distributed tier): two real processes form one global JAX mesh via
``jax.distributed.initialize`` (the control plane that replaces the
reference's runtime_proxy), and the config-#4 sharded fused-chain
channelizer runs across it — each process feeds its process-local input
shard and owns its process-local audio shard; the assembled result must
match the single-process unsharded reference.

This is the multi-host code path executed for real: on a multi-host GPU
cluster the SAME worker runs with no code change (local processes + gloo
on CPU stand in for hosts and their interconnect, exactly as the
reference tested its distributed runtime with localhost ZMQ).
"""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

WORKER = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1]); outdir = sys.argv[2]; port = sys.argv[3]
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=2, process_id=pid)
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from newsched_tpu.ops import firdes
from newsched_tpu.parallel.channelizer import ShardedFMChannelizer, planes_rows

M, decim, n_dev = 16, 4, 8
taps = firdes.prototype_channelizer_taps(M, 8)
audio_taps = firdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=33)
mesh = Mesh(np.array(jax.devices()), ("t",))
ch = ShardedFMChannelizer(mesh, M, taps, audio_taps, audio_decim=decim,
                          demod_gain=1.1)
n_rows = n_dev * 128
rng = np.random.default_rng(33)  # same stream in both processes
x = (rng.standard_normal(2 * n_rows * M)
     + 1j * rng.standard_normal(2 * n_rows * M)).astype(np.complex64)
rows_all = planes_rows(x, M)

hr = ch._history()
sh_rows = NamedSharding(mesh, P("t", None))
from newsched_tpu.parallel.channelizer import PlanesFMState
state = PlanesFMState(carry=jax.make_array_from_process_local_data(
    sh_rows, np.zeros((n_dev * hr // 2, 2 * M), np.float32)))
step = jax.jit(ch.step_planes)
outs = []
half = n_rows // 2
for b in range(2):
    batch = rows_all[b * n_rows:(b + 1) * n_rows]
    local = batch[pid * half:(pid + 1) * half]   # this process's time shard
    xb = jax.make_array_from_process_local_data(sh_rows, local)
    audio, state = step(xb, state)
    local_aud = np.concatenate(
        [np.asarray(s.data) for s in
         sorted(audio.addressable_shards, key=lambda s: s.index[0].start)])
    outs.append(local_aud)
np.save(os.path.join(outdir, f"audio_{pid}.npy"), np.concatenate(outs))
print(f"proc {pid}: OK {outs[0].shape} x2", flush=True)
'''


def test_two_process_global_mesh_channelizer(tmp_path):
    port = "52739"
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    ps = [subprocess.Popen([sys.executable, "-c", WORKER, str(i),
                            str(tmp_path), port],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True, env=env)
          for i in range(2)]
    outs = []
    for i, p in enumerate(ps):
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in ps:
                q.kill()
            raise
        outs.append(out)
        assert p.returncode == 0, f"proc {i}:\n{out[-1500:]}"

    # assemble: per batch, proc 0 owns the first half of audio rows
    M, decim, n_dev = 16, 4, 8
    n_rows = n_dev * 128
    rows_aud = n_rows // decim
    a0 = np.load(tmp_path / "audio_0.npy")  # (2 * rows_aud/2, M)
    a1 = np.load(tmp_path / "audio_1.npy")
    h = rows_aud // 2
    got = np.concatenate([a0[:h], a1[:h], a0[h:], a1[h:]], axis=0)

    # unsharded single-process reference
    from newsched_tpu.ops import firdes
    from newsched_tpu.parallel import make_mesh
    from newsched_tpu.parallel.channelizer import ShardedFMChannelizer

    import jax
    import jax.numpy as jnp

    taps = firdes.prototype_channelizer_taps(M, 8)
    audio_taps = firdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=33)
    rng = np.random.default_rng(33)
    x = (rng.standard_normal(2 * n_rows * M)
         + 1j * rng.standard_normal(2 * n_rows * M)).astype(np.complex64)
    ch = ShardedFMChannelizer(make_mesh(1), M, taps, audio_taps,
                              audio_decim=decim, demod_gain=1.1)
    st = ch.init_state()
    stepf = jax.jit(ch.step)
    refs = []
    B = n_rows * M
    for b in range(2):
        aud, st = stepf(jnp.asarray(x[b * B:(b + 1) * B]), st)
        refs.append(np.asarray(aud))
    ref = np.concatenate(refs, axis=0)
    assert got.shape == ref.shape
    err = got.astype(np.float64) - ref.astype(np.float64)
    snr = 10 * np.log10(np.mean(ref.astype(np.float64) ** 2)
                        / max(np.mean(err**2), 1e-300))
    assert snr > 100, snr


LIVE_WORKER = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1]); outdir = sys.argv[2]; port = sys.argv[3]
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=2, process_id=pid)
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from newsched_tpu.blocks import vector_dsp
from newsched_tpu.ops import firdes

M, decim, n_dev = 16, 2, 8
ataps = firdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=17)
src = vector_dsp.fm_noise_channelizer_source(
    M, None, ataps, audio_decim=decim, taps_per_arm=4, seed=5)
mesh = Mesh(np.array(jax.devices()), ("t",))
nout = n_dev * 64  # audio items/global batch -> 128 rows/device
state = src.init_state(0, nout)
params = {k: jnp.asarray(v) for k, v in src.param_leaves().items()}

@jax.jit
def step(state, params):
    return src.work_sharded(state, {}, params, nout, mesh=mesh, axis="t")

outs = []
for b in range(2):
    state, out = step(state, params)
    aud = out["out"]
    local = np.concatenate(
        [np.asarray(s.data) for s in
         sorted(aud.addressable_shards, key=lambda s: s.index[0].start)])
    outs.append(local)
np.save(os.path.join(outdir, f"live_{pid}.npy"), np.concatenate(outs))
print(f"proc {pid}: OK", flush=True)
'''


def test_two_process_global_mesh_live_source(tmp_path):
    """Round 5: the LIVE gen-fused sharded source across a REAL process
    boundary — each process's devices generate their own absolute group
    ranges of the position-pure stream with ZERO collectives; the
    assembled global audio equals the single-device block's stream."""
    port = "52741"
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    ps = [subprocess.Popen([sys.executable, "-c", LIVE_WORKER, str(i),
                            str(tmp_path), port],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True, env=env)
          for i in range(2)]
    for i, p in enumerate(ps):
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in ps:
                q.kill()
            raise
        assert p.returncode == 0, f"proc {i}:\n{out[-1500:]}"

    M, decim, n_dev = 16, 2, 8
    nout = n_dev * 64
    a0 = np.load(tmp_path / "live_0.npy")
    a1 = np.load(tmp_path / "live_1.npy")
    h = nout // 2
    got = np.concatenate([a0[:h], a1[:h], a0[h:], a1[h:]], axis=0)

    # single-device unsharded reference (pure generator, carried state)
    import jax
    import jax.numpy as jnp

    from newsched_tpu.blocks import vector_dsp
    from newsched_tpu.ops import firdes

    ataps = firdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=17)
    src = vector_dsp.fm_noise_channelizer_source(
        M, None, ataps, audio_decim=decim, taps_per_arm=4, seed=5)
    state = src.init_state(0, nout)
    refs = []
    for b in range(2):
        state, out = src.work(state, {}, {k: jnp.asarray(v) for k, v in
                                          src.param_leaves().items()}, nout)
        refs.append(np.asarray(out["out"]))
    ref = np.concatenate(refs, axis=0)
    err = ref.astype(np.float64) - got.astype(np.float64)
    p = float(np.mean(ref.astype(np.float64) ** 2))
    snr = np.inf if err.max() == err.min() == 0 else \
        10 * np.log10(p / float(np.mean(err ** 2)))
    assert snr > 100, snr
