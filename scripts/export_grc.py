"""Export GRC 4.0 block metadata for the ENTIRE block library — the
reference's blockbuilder emits a GRC yml per block at build time
(SURVEY.md §3.5); this is the equivalent whole-library pass.

    python scripts/export_grc.py [--out grc/]

Walks every Block subclass in newsched_tpu.blocks, instantiates it with
representative arguments (EXAMPLE_ARGS for blocks whose constructors need
them), renders runtime/blockspec.grc_yaml, and writes
<out>/<module>_<block>.block.yml. Blocks that cannot be instantiated
headlessly (hardware-gated: soapy, alsa) are listed at the end.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODULES = ["general", "math", "analog", "filter", "fft", "streamops",
           "fileio", "digital", "fec", "zmq", "network", "gui", "audio",
           "vector_dsp", "yml_blocks"]

_TAPS = np.ones(8, np.float32) / 8

# Representative constructor arguments for blocks that require them.
EXAMPLE_ARGS: dict[str, tuple] = {
    "head": (1024,),
    "throttle": (1e6,),
    "vector_source": (np.zeros(16, np.complex64),),
    "load": (4,),
    "fanout": (2,),
    "add": (2,),
    "multiply": (2,),
    "add_const": (1.0, "cf32"),
    "multiply_const": (1.0, "cf32"),
    "sig_source": (1e6,),
    "fm_deemph": (48000.0,),
    "fm_preemph": (48000.0,),
    "fir_filter": (_TAPS,),
    "iir_filter": ([1.0, 0.5], [1.0, -0.2]),
    "fft_filter": (_TAPS,),
    "moving_average": (8,),
    "pfb_channelizer": (8,),
    "pfb_decimator": (8,),
    "rational_resampler": (2, 3),
    "freq_xlating_fir": (_TAPS, 1e5, 1e6),
    "fft": (64,),
    "file_source": (os.devnull,),
    "file_sink": (os.devnull,),
    "delay": (4,),
    "skiphead": (4,),
    "keep_one_in_n": (4,),
    "keep_m_in_n": (2, 4),
    "repeat": (2,),
    "interleave": (2,),
    "deinterleave": (2,),
    "stream_to_vector": (8,),
    "vector_to_stream": (8,),
    "streams_to_vector": (2,),
    "vector_to_streams": (2,),
    "chunks_to_symbols": (np.asarray([1 + 0j, -1 + 0j], np.complex64),),
    "constellation_decoder": (np.asarray([1 + 0j, -1 + 0j], np.complex64),),
    "binary_slicer": (),
    "clock_recovery_mm": (4.0,),
    "costas_loop": (0.05,),
    "diff_decoder": (2,),
    "diff_encoder": (2,),
    "interleaver": (64, 8),
    "deinterleaver_blk": (64, 8),
    "push_sink": ("tcp://127.0.0.1:5555",),
    "pull_source": ("tcp://127.0.0.1:5555",),
    "pub_sink": ("tcp://127.0.0.1:5556",),
    "sub_source": ("tcp://127.0.0.1:5556",),
    "udp_source": (5557,),
    "udp_sink": (5557, "127.0.0.1"),
    "tcp_source": (5558,),
    "tcp_sink": (5558, "127.0.0.1"),
    "wav_sink": (os.devnull,),
    "time_sink": (),
    "freq_sink": (),
    "vector_quad_demod": (8,),
    "vector_fir": (8, _TAPS),
    "channel_select": (8, 0),
    "fm_channelizer_fused_planes": (64, None, _TAPS),
    "fm_noise_channelizer_source": (64, None, _TAPS),
    "wbfm_rcv_fused": (_TAPS, 100e3, 1e6),
    "wbfm_live_source": (_TAPS, 100e3, 1e6),
    "fir_tone_source": (1e6, _TAPS),
    "cplx_to_planes": (8,),
    "noise_planes_source": (8,),
    # yml-described blocks with static params
    "keep_one_in_n_y": (None,),  # kwargs below
}
EXAMPLE_KWARGS: dict[str, dict] = {
    "keep_one_in_n_y": {"n": 4},
    "keep_m_in_n_y": {"m": 2, "n": 4},
    "repeat_y": {"n": 2},
    "stream_to_vector_y": {"vlen": 8},
    "vector_to_stream_y": {"vlen": 8},
}
SKIP = {"Block", "SyncBlock", "HierBlock"}


def export(outdir: str) -> tuple[int, list[str]]:
    from newsched_tpu.runtime.block import Block
    from newsched_tpu.runtime.blockspec import grc_yaml

    os.makedirs(outdir, exist_ok=True)
    # wav_source requires a readable WAV: synthesize a tiny one (local
    # copy of the args table — export() stays side-effect free).
    import tempfile

    import scipy.io.wavfile as _wf

    _wav = os.path.join(tempfile.gettempdir(), "_grc_export_probe.wav")
    _wf.write(_wav, 8000, np.zeros(16, np.float32))
    example_args = {**EXAMPLE_ARGS, "wav_source": (_wav,)}
    written, skipped = 0, []
    for modname in MODULES:
        try:
            mod = importlib.import_module(f"newsched_tpu.blocks.{modname}")
        except Exception as e:  # hardware-dep module missing
            skipped.append(f"{modname}.* ({e.__class__.__name__})")
            continue
        for name, cls in sorted(vars(mod).items()):
            if not (inspect.isclass(cls) and issubclass(cls, Block)):
                continue
            if name.startswith("_") or name in SKIP:
                continue
            if cls.__module__ != mod.__name__ and modname != "yml_blocks":
                continue  # re-exported from elsewhere
            args = example_args.get(name, ())
            if len(args) == 1 and args[0] is None:
                args = ()
            kwargs = EXAMPLE_KWARGS.get(name, {})
            try:
                inst = cls(*args, **kwargs)
                doc = grc_yaml(inst, module=modname)
            except Exception as e:
                skipped.append(f"{modname}.{name} ({e.__class__.__name__}: {e})")
                continue
            path = os.path.join(outdir, f"{modname}_{name}.block.yml")
            with open(path, "w") as fh:
                fh.write(doc)
            written += 1
    return written, skipped


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="grc")
    args = ap.parse_args()
    written, skipped = export(args.out)
    print(f"wrote {written} GRC block descriptions to {args.out}/")
    if skipped:
        print(f"skipped {len(skipped)}:")
        for s in skipped:
            print(f"  - {s}")


if __name__ == "__main__":
    main()
