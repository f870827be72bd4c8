"""On-card test tier: the chains compiled for a CUDA GPU.

Run on a machine with a GPU: ``python -m pytest tests_gpu -q`` (or
through ``python chip_smoke.py``, which runs this tier in its own
process). Every test here carries the ``gpu`` marker and skips, inside a
fixture, when JAX's first device is not a GPU. Unlike tests/, nothing
here forces the CPU backend.
"""

import pytest


def pytest_collection_modifyitems(config, items):
    for item in items:
        item.add_marker(pytest.mark.gpu)


@pytest.fixture(autouse=True)
def _on_gpu():
    import jax

    from newsched_tpu.utils.platform import gpu_backend

    if not gpu_backend():
        pytest.skip(f"needs a CUDA GPU; JAX's backend is "
                    f"{jax.default_backend()!r}")
