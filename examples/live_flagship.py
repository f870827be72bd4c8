"""The LIVE flagship: the whole 64-channel FM channelizer chain as ONE
source block that generates its own Gaussian input per batch — the
position-pure noise stream of ops/noise.py, no replay buffer
(`models.fm_channelizer(source="live", fused=True)`).

`python examples/live_flagship.py` — prints the audio stats of a short
live run and a rough rate that includes compilation (bench.py measures
the steady rate).
"""

import time

import numpy as np

from newsched_tpu.models import fm_channelizer
from newsched_tpu.utils.platform import enable_compile_cache

NCHANS = 64
N_OUT = 2048  # audio-rate vector samples


def main():
    enable_compile_cache()
    fg, blocks = fm_channelizer(nchans=NCHANS, n_samples=N_OUT,
                                sink="vector", batch_size=1 << 18,
                                source="live", fused=True)
    t0 = time.perf_counter()
    fg.run()
    dt = time.perf_counter() - t0
    audio = blocks["sink"].data()
    assert audio.shape == (N_OUT, NCHANS) and np.isfinite(audio).all()
    wideband = N_OUT * NCHANS * 8  # audio_decim=8
    print(f"live flagship: {audio.shape} audio in {dt:.2f}s "
          f"(~{wideband / dt / 1e6:.0f} Msps incl. compile)")
    print(f"audio rms per channel (first 8): "
          f"{np.sqrt(np.mean(audio**2, axis=0))[:8].round(3)}")


if __name__ == "__main__":
    main()
