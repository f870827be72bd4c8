"""Define a block with a YAML descriptor at runtime (the reference's
blockbuilder .yml, minus the codegen step) and render its GRC metadata.
"""

import numpy as np

from newsched_tpu import Flowgraph
from newsched_tpu.blocks import general
from newsched_tpu.runtime.blockspec import block_from_yaml, grc_yaml
from newsched_tpu.utils.platform import enable_compile_cache

DESCRIPTOR = """
module: examples
block: db_scale
label: dB Scale
blocktype: sync_block
parameters:
  - id: ref
    label: Reference
    dtype: rf32
    default: 1.0
    settable: true
ports:
  - {domain: stream, id: in, direction: input, type: rf32}
  - {domain: stream, id: out, direction: output, type: rf32}
expr: "20 * jnp.log10(jnp.maximum(jnp.abs(in_), 1e-30) / ref)"
"""


def main():
    enable_compile_cache()
    db_scale = block_from_yaml(DESCRIPTOR)
    x = np.array([1.0, 0.1, 10.0, 0.5] * 64, np.float32)
    fg = Flowgraph(batch_size=64)
    src = general.vector_source(x, dtype="rf32")
    blk = db_scale(ref=1.0)
    snk = general.vector_sink(dtype="rf32")
    fg.connect(src, 0, blk, 0)
    fg.connect(blk, 0, snk, 0)
    fg.run()
    np.testing.assert_allclose(snk.data(), 20 * np.log10(np.abs(x)), atol=1e-4)
    print("block ran; GRC metadata:")
    print(grc_yaml(db_scale))


if __name__ == "__main__":
    main()
