"""Mesh / sharding / collective helpers.

Replacement for the reference's entire distribution story
(SURVEY.md §3.6): graph_utils::partition + multi-scheduler -> mesh
placement; runtime_proxy + buffer_net_zmq ZMQ planes -> XLA collectives
compiled into the program (`ppermute` halos, `all_to_all` corner turns);
flowgraph_monitor-across-processes -> nothing (one SPMD program).
"""

from newsched_tpu.parallel.mesh import make_mesh  # noqa: F401
from newsched_tpu.parallel.halo import time_halo  # noqa: F401
from newsched_tpu.parallel.channelizer import ShardedFMChannelizer  # noqa: F401
from newsched_tpu.parallel.channelizer import (  # noqa: F401
    PlanesFMState,
    planes_rows,
)
