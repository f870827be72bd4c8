"""The flagship chain (BASELINE config #2): 64-channel polyphase
channelizer -> per-channel FM demod -> per-channel audio FIR.

`python examples/channelizer.py` runs single-device;
`python examples/channelizer.py --mesh` compiles the SAME flowgraph
sharded over every local device (fg.run(mesh=...): the compiler pins
stream edges time-sharded and XLA inserts the halo exchanges).
"""

import sys

import numpy as np

from newsched_tpu.models import fm_channelizer
from newsched_tpu.utils.platform import enable_compile_cache

NCHANS = 64
N_OUT = 4096  # audio-rate vector samples to produce


def main():
    enable_compile_cache()
    fg, blocks = fm_channelizer(nchans=NCHANS, n_samples=N_OUT,
                                sink="vector", batch_size=1 << 17)
    if "--mesh" in sys.argv[1:]:
        from newsched_tpu.parallel import make_mesh

        mesh = make_mesh()
        print(f"running sharded over {mesh.devices.size} device(s)")
        fg.run(mesh=mesh)
    else:
        fg.run()
    audio = blocks["sink"].data()
    print(f"audio matrix {audio.shape} (time x {NCHANS} channels), "
          f"rms {float(np.sqrt(np.mean(audio**2))):.4f}")
    assert audio.shape == (N_OUT, NCHANS)


if __name__ == "__main__":
    main()
