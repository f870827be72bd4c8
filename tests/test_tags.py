"""Stream-tag tests (reference: test/qa_tags.py-style integration tests +
config #3's tag-preservation gate)."""

import numpy as np
import scipy.signal as sig

from newsched_tpu import Flowgraph
from newsched_tpu.blocks import filter as filt, general, math as gmath
from newsched_tpu.ops import firdes
from tests.test_ops_fir import snr_db, _rand_complex


def test_tags_passthrough_sync_chain():
    data = _rand_complex(1024)
    tag_list = [(0, "start", 1.0), (100, "a", 2.5), (999, "end", 3.0)]
    fg = Flowgraph(batch_size=256)
    src = general.vector_source(data, tags=tag_list)
    c = general.copy()
    snk = general.vector_sink()
    fg.connect(src, 0, c, 0)
    fg.connect(c, 0, snk, 0)
    fg.run()
    got = [(t.offset, t.key, t.value[0]) for t in snk.tags()]
    assert got == [(0, "start", 1.0), (100, "a", 2.5), (999, "end", 3.0)]


def test_tags_remap_through_decimator():
    data = _rand_complex(4096)
    taps = firdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=33)
    tag_list = [(0, "t0"), (400, "t1"), (401, "t2"), (4000, "t3")]
    fg = Flowgraph(batch_size=1024)
    src = general.vector_source(data, tags=tag_list)
    fir = filt.fir_filter(taps, decim=4)
    snk = general.vector_sink()
    fg.connect(src, 0, fir, 0)
    fg.connect(fir, 0, snk, 0)
    fg.run()
    offs = [(t.offset, t.key) for t in snk.tags()]
    assert offs == [(0, "t0"), (100, "t1"), (100, "t2"), (1000, "t3")]


def test_tags_through_fft_filter_with_data_check():
    """Config #3 shape: overlap-save fft_filter, tags intact, data golden."""
    data = _rand_complex(8192, seed=33)
    taps = firdes.low_pass(1.0, 1.0, 0.2, 0.02)  # auto length (big-ish)
    tag_list = [(10, "sync", 7.0), (5000, "pkt", 1.0, 2.0)]
    fg = Flowgraph(batch_size=2048)
    src = general.vector_source(data, tags=tag_list)
    ff = filt.fft_filter(taps)
    snk = general.vector_sink()
    fg.connect(src, 0, ff, 0)
    fg.connect(ff, 0, snk, 0)
    fg.run()
    ref = sig.lfilter(taps.astype(np.float64), [1.0], data.astype(np.complex128))
    assert snr_db(ref, snk.data()) > 90
    got = [(t.offset, t.key, t.value) for t in snk.tags()]
    assert got == [(10, "sync", (7.0, 0.0)), (5000, "pkt", (1.0, 2.0))]


def test_tags_merge_multi_input():
    a = _rand_complex(512, seed=1)
    b = _rand_complex(512, seed=2)
    fg = Flowgraph(batch_size=128)
    sa = general.vector_source(a, tags=[(5, "from_a")])
    sb = general.vector_source(b, tags=[(200, "from_b")])
    adder = gmath.add(2)
    snk = general.vector_sink()
    fg.connect(sa, 0, adder, 0)
    fg.connect(sb, 0, adder, 1)
    fg.connect(adder, 0, snk, 0)
    fg.run()
    got = sorted((t.offset, t.key) for t in snk.tags())
    assert got == [(5, "from_a"), (200, "from_b")]


def test_untagged_graph_has_no_tags():
    fg = Flowgraph(batch_size=128)
    src = general.vector_source(_rand_complex(256))
    snk = general.vector_sink()
    fg.connect(src, 0, snk, 0)
    fg.run()
    assert snk.tags() == []


def test_tag_policy_one_to_one():
    """Reference TPP_ONE_TO_ONE: tags from input port i appear only on
    output port i (not merged across ports)."""
    from newsched_tpu.runtime.block import SyncBlock

    class two_lane(SyncBlock):
        tag_policy = "one_to_one"

        def __init__(self, name=None):
            super().__init__(name)
            self.add_input("in0", "cf32")
            self.add_input("in1", "cf32")
            self.add_output("out0", "cf32")
            self.add_output("out1", "cf32")

        def work(self, state, ins, params, nout):
            return state, {"out0": ins["in0"] * 2, "out1": ins["in1"] * 3}

    a = _rand_complex(512, seed=1)
    b = _rand_complex(512, seed=2)
    fg = Flowgraph(batch_size=128)
    sa = general.vector_source(a, tags=[(5, "from_a")])
    sb = general.vector_source(b, tags=[(200, "from_b")])
    blk = two_lane()
    s0 = general.vector_sink()
    s1 = general.vector_sink()
    fg.connect(sa, 0, blk, 0)
    fg.connect(sb, 0, blk, 1)
    fg.connect(blk, 0, s0, 0)
    fg.connect(blk, "out1", s1, 0)
    fg.run()
    assert [(t.offset, t.key) for t in s0.tags()] == [(5, "from_a")]
    assert [(t.offset, t.key) for t in s1.tags()] == [(200, "from_b")]
    np.testing.assert_allclose(s0.data(), a * 2, rtol=1e-6)
    np.testing.assert_allclose(s1.data(), b * 3, rtol=1e-6)


def test_tag_policy_one_to_one_arity_error():
    """ONE_TO_ONE with mismatched port counts is rejected at compile time
    (the reference raises at runtime)."""
    import pytest

    from newsched_tpu.runtime.block import SyncBlock

    class bad(SyncBlock):
        tag_policy = "one_to_one"

        def __init__(self, name=None):
            super().__init__(name)
            self.add_input("in0", "cf32")
            self.add_input("in1", "cf32")
            self.add_output("out", "cf32")

        def work(self, state, ins, params, nout):
            return state, {"out": ins["in0"] + ins["in1"]}

    fg = Flowgraph(batch_size=128)
    sa = general.vector_source(_rand_complex(256), tags=[(0, "t")])
    sb = general.vector_source(_rand_complex(256))
    blk = bad()
    snk = general.vector_sink()
    fg.connect(sa, 0, blk, 0)
    fg.connect(sb, 0, blk, 1)
    fg.connect(blk, 0, snk, 0)
    with pytest.raises(ValueError, match="one_to_one"):
        fg.run()


def test_rich_tag_payloads():
    """pmtf-map analog: arbitrary Python payloads ride the host-side
    registry, keyed by the int handle in the device tag plane."""
    data = _rand_complex(1024)
    meta = {"freq": 92.5e6, "label": "station"}
    fg = Flowgraph(batch_size=256)
    src = general.vector_source(
        data, tags=[(3, "numeric", 1.5), (700, "rich", meta)])
    snk = general.vector_sink()
    fg.connect(src, 0, snk, 0)
    fg.run()
    got = {t.key: t for t in snk.tags()}
    assert got["numeric"].value[0] == 1.5 and got["numeric"].payload is None
    assert got["rich"].offset == 700
    assert got["rich"].payload == meta


def test_tag_capacity_limit_no_drops():
    """Compaction bounds capacity snowballing; tags that fit still arrive."""
    a = _rand_complex(512, seed=1)
    b = _rand_complex(512, seed=2)
    fg = Flowgraph(batch_size=128)
    sa = general.vector_source(a, tags=[(5, "a0"), (300, "a1")])
    sb = general.vector_source(b, tags=[(200, "b0"), (430, "b1")])
    adder = gmath.add(2)
    snk = general.vector_sink()
    fg.connect(sa, 0, adder, 0)
    fg.connect(sb, 0, adder, 1)
    fg.connect(adder, 0, snk, 0)
    runner = fg.run(tag_capacity_limit=2)  # merged cap would be 4
    # At most 2 tags are valid in any one batch here, so nothing drops.
    got = sorted((t.offset, t.key) for t in snk.tags())
    assert got == [(5, "a0"), (200, "b0"), (300, "a1"), (430, "b1")]
    assert runner.stats.get("tag_drops", 0) == 0


def test_tag_capacity_limit_drops_counted():
    a = _rand_complex(256, seed=3)
    b = _rand_complex(256, seed=4)
    fg = Flowgraph(batch_size=256)
    sa = general.vector_source(a, tags=[(5, "a0"), (6, "a1")])
    sb = general.vector_source(b, tags=[(7, "b0"), (8, "b1")])
    adder = gmath.add(2)
    snk = general.vector_sink()
    fg.connect(sa, 0, adder, 0)
    fg.connect(sb, 0, adder, 1)
    fg.connect(adder, 0, snk, 0)
    runner = fg.run(tag_capacity_limit=3)
    # All 4 tags valid in the single batch; one is dropped and counted.
    assert runner.stats.get("tag_drops", 0) == 1
    assert len(snk.tags()) == 3


def test_tags_through_fused_megakernel_graph():
    """Stream tags traverse the fused chain block with the exact
    rational remap (rate 1/(M*decim) through adapter + fused stages) —
    the generic compiler tag plane needs no block cooperation."""
    import numpy as np

    from newsched_tpu import models
    from newsched_tpu.blocks import general

    M, decim = 16, 4
    rng = np.random.default_rng(0)
    B = 8192
    x = (rng.standard_normal(B) + 1j * rng.standard_normal(B)).astype(np.complex64)
    n_aud = B // M // decim
    src = general.vector_source(x, tags=[(0, "start"), (B // 2, "mid", 7.5)])
    fg, bl = models.fm_channelizer(nchans=M, taps_per_arm=8, audio_decim=decim,
                                   n_samples=n_aud, source=src, batch_size=2048,
                                   sink="vector", fused=True)
    fg.run()
    tags = bl["sink"].tags()
    assert [(t.offset, t.key) for t in tags] == \
        [(0, "start"), (B // 2 // M // decim, "mid")]
    assert tags[1].value[0] == 7.5
