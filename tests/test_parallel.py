"""Sharded pipeline tests on the simulated 8-device CPU mesh (SURVEY.md §5:
the analog of the reference's localhost multi-process distributed tests).

The decisive check: the time-sharded + corner-turned channelizer+demod
pipeline produces the SAME samples as the single-device flowgraph, across
multiple batches (i.e. halo exchange and carried state are exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from newsched_tpu.ops import fir as fir_ops, firdes, pfb as pfb_ops
from newsched_tpu.parallel import ShardedFMChannelizer, make_mesh
from tests.test_ops_fir import snr_db, _rand_complex


def _reference_chain(x, nchans, taps, audio_taps, audio_decim, gain, batches):
    """Unsharded streaming reference built from the same ops kernels."""
    arm = jnp.asarray(pfb_ops.pfb_arm_taps(taps, nchans))
    pfb_st = pfb_ops.pfb_init_state(arm.size, dtype=jnp.complex64)
    prev = jnp.zeros((nchans,), jnp.complex64)
    tails = jnp.zeros((nchans, len(audio_taps) - 1), jnp.float32)
    outs = []
    B = len(x) // batches
    for b in range(batches):
        xb = jnp.asarray(x[b * B : (b + 1) * B])
        pfb_st, Y = pfb_ops.pfb_channelize(arm, pfb_st, xb)
        xprev = jnp.concatenate([prev[None], Y[:-1]], axis=0)
        p = jnp.conj(xprev) * Y
        # zero-history convention: demod emits exactly 0 (matches
        # parallel/channelizer.py and ops/fm_chain.py)
        aud = jnp.where((xprev == 0) | (Y == 0), jnp.float32(0),
                        jnp.arctan2(jnp.imag(p), jnp.real(p))) * gain
        prev = Y[-1]

        def one(tail, ch):
            st, y = fir_ops.fir_filter(jnp.asarray(audio_taps), fir_ops.FirState(tail=tail),
                                       ch, decim=audio_decim, method="conv")
            return st.tail, y

        tails, ys = jax.vmap(one)(tails, aud.T)
        outs.append(np.asarray(ys.T))
    return np.concatenate(outs, axis=0)


@pytest.mark.parametrize("n_dev", [1, 4, 8])
def test_sharded_channelizer_matches_unsharded(n_dev):
    M, L, decim = 16, 8, 4
    taps = firdes.prototype_channelizer_taps(M, L)
    audio_taps = firdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=33)
    mesh = make_mesh(n_dev)
    ch = ShardedFMChannelizer(mesh, M, taps, audio_taps, audio_decim=decim,
                              demod_gain=1.3)
    B = ch.batch_multiple() * 4  # several segments per device
    x = _rand_complex(B * 3, seed=21)  # 3 batches
    state = ch.init_state()
    step = jax.jit(ch.step)
    outs = []
    for b in range(3):
        xb = jax.device_put(jnp.asarray(x[b * B : (b + 1) * B]), ch.input_sharding())
        audio, state = step(xb, state)
        outs.append(np.asarray(audio))
    got = np.concatenate(outs, axis=0)
    ref = _reference_chain(x, M, taps, audio_taps, decim, 1.3, batches=3)
    assert got.shape == ref.shape
    assert snr_db(ref, got) > 100


def test_sharded_batch_count_invariance():
    """2 batches through the sharded pipeline == 1 double batch."""
    M, L, decim = 8, 6, 2
    taps = firdes.prototype_channelizer_taps(M, L)
    audio_taps = firdes.low_pass(1.0, 1.0, 0.2, 0.1, ntaps=17)
    mesh = make_mesh(4)
    ch = ShardedFMChannelizer(mesh, M, taps, audio_taps, audio_decim=decim)
    B = max(ch.min_batch(), ch.batch_multiple() * 2)
    x = _rand_complex(2 * B, seed=22)
    step = jax.jit(ch.step)

    st = ch.init_state()
    parts = []
    for b in range(2):
        xb = jax.device_put(jnp.asarray(x[b * B : (b + 1) * B]), ch.input_sharding())
        audio, st = step(xb, st)
        parts.append(np.asarray(audio))
    split = np.concatenate(parts, axis=0)

    st = ch.init_state()
    audio, _ = jax.jit(ch.step)(jax.device_put(jnp.asarray(x), ch.input_sharding()), st)
    assert snr_db(np.asarray(audio), split) > 120


def test_output_is_channel_sharded():
    mesh = make_mesh(8)
    M = 16
    taps = firdes.prototype_channelizer_taps(M, 8)
    ataps = firdes.low_pass(1.0, 1.0, 0.2, 0.1, ntaps=9)
    ch = ShardedFMChannelizer(mesh, M, taps, ataps, audio_decim=2)
    x = jax.device_put(jnp.zeros(ch.min_batch(), jnp.complex64), ch.input_sharding())
    audio, _ = jax.jit(ch.step)(x, ch.init_state())
    spec = audio.sharding.spec
    assert spec[1] == "t" or (isinstance(spec[1], tuple) and "t" in spec[1])


def test_sharded_fft_filter_tags_preserved():
    """BASELINE config #3: overlap-save filter, time-sharded, tags intact."""
    import jax.numpy as jnp
    from newsched_tpu.parallel.sharded_fir import ShardedFirFilter
    from newsched_tpu.runtime import tags as tags_mod
    import scipy.signal as sig

    taps = firdes.low_pass(1.0, 1.0, 0.1, 0.02, ntaps=129)
    mesh = make_mesh(8)
    decim = 2
    f = ShardedFirFilter(mesh, taps, decim=decim, method="fft")
    B = max(f.min_batch(), 8 * 512)
    x = _rand_complex(2 * B, seed=40)

    # tags at known batch-relative offsets (batch 0 and batch 1)
    def mk_tags(offsets):
        k = len(offsets)
        return tags_mod.TagBatch(
            offsets=jnp.asarray(offsets, jnp.int32),
            keys=jnp.zeros((k,), jnp.int32),
            values=jnp.zeros((k, tags_mod.VALUE_DIM), jnp.float32),
            valid=jnp.ones((k,), bool),
        )

    st = f.init_state()
    step = jax.jit(f.step)
    outs, out_tag_offsets = [], []
    per_batch_tags = [mk_tags([7, B - 3]), mk_tags([11])]
    for b in range(2):
        xb = jax.device_put(jnp.asarray(x[b * B : (b + 1) * B]), f.input_sharding())
        y, otags, st = step(xb, per_batch_tags[b], st)
        outs.append(np.asarray(y))
        out_tag_offsets.append(np.asarray(otags.offsets))
    y = np.concatenate(outs)
    ref = sig.lfilter(taps.astype(np.float64), [1.0], x.astype(np.complex128))[::decim]
    assert snr_db(ref, y) > 90
    # tag offsets remapped by 1/decim, still batch-relative
    assert out_tag_offsets[0].tolist() == [7 // decim, (B - 3) // decim]
    assert out_tag_offsets[1].tolist() == [11 // decim]


def test_sharded_channelizer_256ch_config4():
    """BASELINE config #4 shape: 256-channel channelizer + per-channel FM
    demod, channels corner-turned across an 8-device mesh (the 2-host
    slice stands in as 8 sim devices; the code path is mesh-size
    agnostic). Exactness vs the unsharded reference chain."""
    M, L, decim = 256, 4, 4
    taps = firdes.prototype_channelizer_taps(M, L)
    audio_taps = firdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=17)
    mesh = make_mesh(8)
    ch = ShardedFMChannelizer(mesh, M, taps, audio_taps, audio_decim=decim,
                              demod_gain=0.7)
    B = max(ch.min_batch(), ch.batch_multiple())
    x = _rand_complex(B * 2, seed=44)
    state = ch.init_state()
    step = jax.jit(ch.step)
    outs = []
    for b in range(2):
        xb = jax.device_put(jnp.asarray(x[b * B : (b + 1) * B]),
                            ch.input_sharding())
        audio, state = step(xb, state)
        outs.append(np.asarray(audio))
    got = np.concatenate(outs, axis=0)
    ref = _reference_chain(x, M, taps, audio_taps, decim, 0.7, batches=2)
    assert got.shape == ref.shape
    assert got.shape[1] == 256
    assert snr_db(ref, got) > 100


# ---- planes-rows chain sharding -----------------------------------------

def _planes_ref(x, M, taps, audio_taps, decim, gain, batches):
    return _reference_chain(x, M, taps, audio_taps, decim, gain, batches)


@pytest.mark.parametrize("n_dev", [1, 4, 8])
def test_planes_megakernel_sharded_matches_unsharded(n_dev):
    """The fused chain per time shard (input-rows ppermute halo, lead-in
    recomputed from it): exact vs the unsharded staged reference across
    batches, for any mesh size."""
    from newsched_tpu.parallel.channelizer import planes_rows

    M, L, decim, A = 16, 8, 4, 33
    taps = firdes.prototype_channelizer_taps(M, L)
    audio_taps = firdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=A)
    mesh = make_mesh(n_dev)
    ch = ShardedFMChannelizer(mesh, M, taps, audio_taps, audio_decim=decim,
                              demod_gain=1.1)
    n_rows = n_dev * 128
    B = n_rows * M
    batches = 3
    x = _rand_complex(B * batches, seed=33)
    rows_all = planes_rows(x, M)
    state = ch.init_state_planes(n_rows)
    step = jax.jit(ch.step_planes)
    outs = []
    for b in range(batches):
        xb = jax.device_put(jnp.asarray(rows_all[b * n_rows:(b + 1) * n_rows]),
                            ch.planes_input_sharding())
        audio, state = step(xb, state)
        outs.append(np.asarray(audio))
    got = np.concatenate(outs, axis=0)
    ref = _planes_ref(x, M, taps, audio_taps, decim, 1.1, batches)
    assert got.shape == ref.shape
    assert snr_db(ref, got) > 100


def test_planes_rejects_batches_shorter_than_the_history():
    """One halo exchange covers one neighbor: per-device rows below the
    chain's history are refused with a framework error."""
    M, L = 16, 8
    taps = firdes.prototype_channelizer_taps(M, L)
    audio_taps = firdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=33)
    ch = ShardedFMChannelizer(make_mesh(4), M, taps, audio_taps,
                              audio_decim=4)
    with pytest.raises(ValueError, match="history"):
        ch.init_state_planes(4 * 16)  # 16 rows/device < 8-1+1+32 = 40
    with pytest.raises(ValueError, match="multiple"):
        ch.init_state_planes(4 * 64 + 4)


def test_planes_megakernel_output_time_sharded():
    from newsched_tpu.parallel.channelizer import planes_rows

    M, L, decim = 16, 8, 4
    taps = firdes.prototype_channelizer_taps(M, L)
    audio_taps = firdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=33)
    mesh = make_mesh(8)
    ch = ShardedFMChannelizer(mesh, M, taps, audio_taps, audio_decim=decim)
    n_rows = 8 * 128
    x = _rand_complex(n_rows * M, seed=5)
    xb = jax.device_put(jnp.asarray(planes_rows(x, M)),
                        ch.planes_input_sharding())
    audio, state = jax.jit(ch.step_planes)(xb, ch.init_state_planes(n_rows))
    # audio rows stay time-sharded: no corner turn in the fused path
    assert audio.sharding.spec == jax.sharding.PartitionSpec("t", None)
    assert audio.shape == (n_rows // decim, M)


def test_planes_megakernel_256ch_config4():
    """BASELINE config #4 at 256 channels through the fused chain on the
    8-device sim mesh."""
    from newsched_tpu.parallel.channelizer import planes_rows

    M, L, decim, A = 256, 4, 4, 17
    taps = firdes.prototype_channelizer_taps(M, L)
    audio_taps = firdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=A)
    mesh = make_mesh(8)
    ch = ShardedFMChannelizer(mesh, M, taps, audio_taps, audio_decim=decim,
                              demod_gain=0.7)
    n_rows = 8 * 64
    B = n_rows * M
    x = _rand_complex(B * 2, seed=44)
    rows_all = planes_rows(x, M)
    state = ch.init_state_planes(n_rows)
    step = jax.jit(ch.step_planes)
    outs = []
    for b in range(2):
        xb = jax.device_put(jnp.asarray(rows_all[b * n_rows:(b + 1) * n_rows]),
                            ch.planes_input_sharding())
        audio, state = step(xb, state)
        outs.append(np.asarray(audio))
    got = np.concatenate(outs, axis=0)
    ref = _planes_ref(x, M, taps, audio_taps, decim, 0.7, batches=2)
    assert got.shape == ref.shape and got.shape[1] == 256
    assert snr_db(ref, got) > 100
