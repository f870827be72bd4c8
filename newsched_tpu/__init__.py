"""newsched_tpu — a streaming DSP dataflow framework for JAX/XLA accelerators.

A ground-up rebuild of the capabilities of mormj/newsched (the GNU Radio 4.0
runtime prototype; see SURVEY.md) designed compile-first:

- Blocks are pure functions ``(state, ins, params) -> (state, outs)`` over
  fixed-size time batches, described by a declarative spec (ports, dtypes,
  rate ratio) — the analog of newsched's ``work(work_io&)`` + YAML descriptor
  (reference: runtime/include/gnuradio/block.h, blocklib/*/*.yml).
- The flowgraph compiles to ONE jitted XLA program per time batch; the NBT
  thread-per-block scheduler, ring buffers, and notification queues of the
  reference (schedulers/nbt/, runtime/buffer*.h) dissolve into static
  dataflow + ``lax.scan`` streaming.
- Inter-batch state (FIR overlap tails, IIR/NCO/AGC/PFB state) is an explicit
  pytree threaded through the scan — replacing newsched's ring-buffer history.
- Scaling is ``jax.sharding.Mesh`` + ``shard_map``: channel-axis sharding for
  filterbanks, time-axis sharding with halo exchange for long filters —
  replacing the reference's multi-scheduler partition + ZMQ distributed
  runtime (runtime/runtime_proxy.h, buffer_net_zmq.h).

Package layout:
  ops/      pure DSP kernels and fused chains (jnp/lax) — reference kernel/ and cusp
  runtime/  graph model, compiler, streaming runner, tags, params, messages
  blocks/   the block library                — reference blocklib/
  models/   prebuilt flagship flowgraphs (FM receiver, channelizers)
  parallel/ mesh / sharding / halo-exchange helpers
  utils/    dtypes, logging, misc
"""

__version__ = "0.1.0"

from newsched_tpu.runtime.block import Block, Port, SyncBlock, param  # noqa: F401
from newsched_tpu.runtime.graph import Flowgraph, Graph, HierBlock  # noqa: F401
