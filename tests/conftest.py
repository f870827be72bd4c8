"""Test configuration.

Tests run on CPU with a simulated 8-device mesh (SURVEY.md §5: distributed
behavior is tested with local stand-ins — the analog of the reference's
localhost-ZMQ multi-process tests). Sharding-semantics tests therefore run
anywhere; performance on the card is measured by bench.py and
chip_smoke.py, and compiled-on-the-card checks live in tests_gpu/.

The CPU is pinned in code before any backend initializes (so XLA_FLAGS
still takes effect), whatever JAX_PLATFORMS says.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
