"""Retune a RUNNING fused wbfm receiver over the authenticated control
socket.

Three features in one graph:
  - the one-block wbfm receive chain (xlate -> demod -> resampler,
    ops/wbfm_chain.py) running as a partition;
  - `center_freq` as a RECOMPILE-FENCE parameter: the remote set_param
    rebuilds the rotated-taps plan and the runner retraces at the next
    batch boundary (runtime/block.py ParamSpec.fence);
  - the cross-process control plane with HMAC-SHA256 frame auth
    (runtime/control.py) — an unkeyed client is rejected BEFORE its
    pickle is ever deserialized.

Runs on any backend: a two-tone input carries
stations at 231.25 kHz and 331.25 kHz; the receiver starts tuned near
the first, then a RuntimeClient retunes near the second mid-stream,
and the audio shows the re-lock.
"""

import os
import time

import numpy as np

from newsched_tpu.blocks import analog, general
from newsched_tpu.ops import firdes
from newsched_tpu.runtime.control import RuntimeClient
from newsched_tpu.runtime.distributed import Runtime, partition_flowgraph
from newsched_tpu.runtime.graph import Flowgraph
from newsched_tpu.utils.platform import enable_compile_cache

FS = 1e6
F1, F2 = 231_250.0, 331_250.0
DEV = 75e3
BATCH = 61_440
N_BATCHES = 16
KEY = b"round5-demo-key"


def main():
    enable_compile_cache()
    n = BATCH * N_BATCHES
    t = np.arange(BATCH * 4) / FS
    x = (np.exp(2j * np.pi * F1 * t)
         + np.exp(2j * np.pi * F2 * t)).astype(np.complex64)

    fg = Flowgraph(batch_size=BATCH)
    src = general.vector_source(x, repeat=True)
    thr = general.throttle(n / 1.0)  # ~1 s stream: time to retune it
    rcv = analog.wbfm_rcv_fused(
        firdes.low_pass(1.0, FS, 100e3, 30e3), center_freq=200e3, fs=FS,
        decim=4, deviation=DEV, resamp_decim=5, name="rcv0")
    hd = general.head(n // 20, dtype="rf32")
    snk = general.vector_sink(dtype="rf32")
    fg.connect(src, 0, thr, 0)
    fg.connect(thr, 0, rcv, 0)
    fg.connect(rcv, 0, hd, 0)
    fg.connect(hd, 0, snk, 0)

    parts = partition_flowgraph(fg, {"radio": [src, thr, rcv, hd],
                                     "audio": [snk]})
    addr = f"ipc:///tmp/nst_retune_demo_{os.getpid()}.ipc"
    rt = Runtime(parts, total_items={"radio": n, "audio": n // 20},
                 control_addresses={"radio": addr}, control_auth_key=KEY)
    rt.start()

    # an unkeyed client is rejected before deserialization
    rogue = RuntimeClient(addr, timeout_ms=2000)
    try:
        rogue.ping()
        raise SystemExit("rogue client should have been rejected")
    except RuntimeError as e:
        print(f"unauthenticated client rejected: {e}")
    rogue.close()

    ctl = RuntimeClient(addr, auth_key=KEY)
    ctl.ping()
    time.sleep(0.45)
    print(f"tuned to {float(ctl.get_param('rcv0', 'center_freq')) / 1e3:.1f}"
          f" kHz; retuning to 290 kHz mid-stream...")
    ctl.set_param("rcv0", "center_freq", 290e3)  # recompile fence
    rt.wait()
    ctl.close()

    audio = np.asarray(snk.data())
    a1 = (F1 - 200e3) / DEV   # audio constant while tuned to 200 kHz
    a2 = (F2 - 290e3) / DEV   # after the retune (0.55, distinct)
    near1 = np.abs(audio - a1) < 2e-2
    near2 = np.abs(audio - a2) < 2e-2
    print(f"audio: {len(audio)} samples; {int(near1.sum())} locked to "
          f"station 1 ({a1:+.3f}), {int(near2.sum())} to station 2 "
          f"({a2:+.3f}) after the fence retrace")
    assert near2[-1] and near2.sum() > len(audio) // 20, "retune failed"
    assert near1.sum() > len(audio) // 20, "no pre-retune region"
    print("OK: running fused receiver retuned over the authed socket")


if __name__ == "__main__":
    main()
