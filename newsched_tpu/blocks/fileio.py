"""File IO blocks — reference blocklib/fileio: file_source, file_sink.

These are host-boundary blocks: file_source stages batches host->device
(memory-mapped read, so the OS page cache is the ring buffer), file_sink
drains device->host. Their presence switches the runner to loop mode with
async dispatch, which overlaps file IO with device compute — the analog
of the reference's double-mapped buffer feeding a worker thread.
"""

from __future__ import annotations

import numpy as np

from newsched_tpu.runtime.block import Block
from newsched_tpu.utils.dtypes import port_dtype


class file_source(Block):
    """Stream items from a raw binary file (reference fileio::file_source).

    With use_native=True (default when the toolchain allows), a C++ pump
    thread streams the file into a double-mapped vmcirc ring
    (io/native/vmcirc_ring.cpp) and host_pull drains it — file IO overlaps
    device compute, the reference's buffer_cpu_vmcirc role. Falls back to
    numpy memmap reads otherwise.
    """

    host_io = True

    def __init__(self, path: str, dtype="cf32", repeat: bool = False,
                 use_native: bool | None = None, ring_bytes: int = 1 << 24,
                 name=None):
        super().__init__(name)
        self.path = path
        self.repeat = repeat
        self.dtype = port_dtype(dtype)
        self.ring_bytes = ring_bytes
        self.use_native = use_native
        self.add_output("out", self.dtype)
        self._mm: np.ndarray | None = None
        self._ring = None
        self._pos = 0

    def start(self):
        from newsched_tpu.io import native_available

        use_native = self.use_native
        if use_native is None:
            use_native = native_available()
        if use_native:
            from newsched_tpu.io import VmcircRing

            self._ring = VmcircRing(self.ring_bytes)
            self._ring.start_file_pump(self.path, loop=self.repeat)
        else:
            self._mm = np.memmap(self.path, dtype=self.dtype.np_dtype, mode="r")
        self._pos = 0

    def stop(self):
        if self._ring is not None:
            self._ring.stop_pump()
            self._ring = None
        self._mm = None

    def finite_items(self, in_bound) -> int | None:
        if self.repeat:
            return None
        n = np.memmap(self.path, dtype=self.dtype.np_dtype, mode="r").shape[0]
        return int(n)

    def host_pull(self, nout: int) -> np.ndarray:
        """Called by the runner per batch (host thread)."""
        if self._ring is not None:
            out = np.empty(nout, dtype=self.dtype.np_dtype)
            self._ring.read_exact(out)
            return out
        assert self._mm is not None, "file_source not started"
        n = len(self._mm)
        out = np.empty(nout, dtype=self.dtype.np_dtype)
        got = 0
        while got < nout:
            take = min(nout - got, n - self._pos)
            if take <= 0:
                if not self.repeat:
                    out[got:] = 0  # zero-pad past EOF; totals already bounded
                    break
                self._pos = 0
                continue
            out[got : got + take] = self._mm[self._pos : self._pos + take]
            self._pos += take
            got += take
        return out

    def work(self, state, ins, params, nout):
        # Device-side work is identity over the staged batch; the runner
        # substitutes the staged array via the "host_in" pseudo input.
        return state, {"out": ins["host_in"]}


class file_sink(Block):
    """Write the stream to a raw binary file (reference fileio::file_sink)."""

    host_io = True

    def __init__(self, path: str, dtype="cf32", name=None):
        super().__init__(name)
        self.path = path
        self.dtype = port_dtype(dtype)
        self.add_input("in", self.dtype)
        self._fh = None

    def start(self):
        self._fh = open(self.path, "wb")

    def stop(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def work(self, state, ins, params, nout):
        return state, ins["in"]

    def finalize(self, collected, total):
        arr = np.asarray(collected)
        if self._fh is None:
            with open(self.path, "wb") as fh:
                arr.tofile(fh)
        else:
            arr.tofile(self._fh)
