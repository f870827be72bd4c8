"""Host IO: the native double-mapped ring buffer and its Python binding.

Reference analog: runtime/buffer_cpu_vmcirc (the default GR buffer) — here
scoped to the one place the design genuinely needs native code: keeping
the host side of the ingest/egress pipe full (SURVEY.md §8 hard part #5).
"""

from newsched_tpu.io.native_ring import StagingBuffer, VmcircRing, native_available  # noqa: F401
