"""The block library — rebuild of the reference's blocklib/.

Modules mirror the reference's layout (SURVEY.md §3.4): general stream
blocks ("blocks"), math, analog, filter, fft, streamops, fileio, zmq. Each
block wraps an ops/ kernel (or trivial jnp) in the declarative Block spec;
factories are plain constructors — the reference's YAML-driven codegen
(utils/blockbuilder) is unnecessary when the spec IS Python.
"""

from newsched_tpu.blocks import analog, digital, fec, fft, fileio, filter, general, math, network, streamops  # noqa: F401
