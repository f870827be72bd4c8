"""Distributed flowgraph runtime — reference L7 (runtime.h,
runtime_monitor.h, runtime_proxy.h, graph_utils::partition).

One logical flowgraph is split into per-group subgraphs; every crossing
edge is replaced by a zmq push/pull pair (the buffer_net_zmq analog) over
loopback or real network addresses. Each partition then runs as an
ordinary compiled flowgraph in its own execution context:

- ``Runtime.run()`` drives all partitions in this process on worker
  threads (XLA releases the GIL, so partitions execute concurrently —
  the same-host analog of the reference's multi-scheduler mode);
- for true multi-process/multi-host deployment each process builds its
  own partition (same code, same addresses) and runs it — the control
  plane the reference implements with runtime_proxy messages collapses
  to the in-band EOF framing of the zmq edges plus process exit codes.

On accelerator clusters this layer is NOT the scaling path — jax.distributed +
shard_map is (parallel/); this exists for the reference's cross-process
streaming capability: mixing hosts, piping to non-JAX consumers, etc.
"""

from __future__ import annotations

import socket
import threading

from newsched_tpu.runtime.graph import Flowgraph
from newsched_tpu.utils.logger import get_logger

log = get_logger("distributed")

def _alloc_address() -> str:
    """A loopback address on a port the OS reports free: processes that
    partition graphs at the same time (parallel test workers, several
    runtimes on one host) do not collide on a fixed port sequence."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def partition_flowgraph(fg: Flowgraph, groups: dict[str, list],
                        addresses: dict | None = None) -> dict[str, Flowgraph]:
    """Split fg into one Flowgraph per group (reference:
    graph_utils::partition + buffer_net_zmq insertion).

    groups: group name -> list of blocks. Every block must appear exactly
    once. Crossing edges get a push_sink in the source group and a
    pull_source in the destination group, wired to a fresh loopback
    address (or one supplied via `addresses[(src_name, src_port)]`).
    """
    from newsched_tpu.blocks import zmq as zmq_blocks

    owner: dict[str, str] = {}
    for gname, blocks in groups.items():
        for b in blocks:
            if b.name in owner:
                raise ValueError(f"block {b.name} assigned to two groups")
            owner[b.name] = gname
    for b in fg.blocks:
        if b.name not in owner:
            raise ValueError(f"block {b.name} not assigned to any group")

    out: dict[str, Flowgraph] = {g: Flowgraph(f"{fg.name}:{g}", fg.batch_size)
                                 for g in groups}
    addresses = dict(addresses or {})
    # Tags crossing a process boundary ride the zmq wire (reference:
    # buffer_net_zmq serializes items AND tags, SURVEY.md §3.1): give each
    # crossing-edge receiver a static per-batch capacity bounded by the
    # whole graph's tag emission.
    tag_cap = sum(int(getattr(b, "tag_capacity", 0)) for b in fg.blocks)
    for e in fg.edges:
        sg, dg = owner[e.src.name], owner[e.dst.name]
        if sg == dg:
            out[sg].connect(e.src, e.src_port, e.dst, e.dst_port)
            continue
        key = (e.src.name, e.src_port)
        if key not in addresses:
            addresses[key] = _alloc_address()
        addr = addresses[key]
        sp = e.src.output_port(e.src_port)
        snk = zmq_blocks.push_sink(addr, bind=True, dtype=sp.dtype,
                                   vlen=sp.item_shape,
                                   name=f"xfer_out_{e.src.name}_{e.src_port}")
        srcb = zmq_blocks.pull_source(addr, bind=False, dtype=sp.dtype,
                                      vlen=sp.item_shape, tag_capacity=tag_cap,
                                      name=f"xfer_in_{e.dst.name}_{e.dst_port}")
        out[sg].connect(e.src, e.src_port, snk, 0)
        out[dg].connect(srcb, 0, e.dst, e.dst_port)
    return out


class Runtime:
    """Run several partitions concurrently in this process (reference:
    runtime::initialize + start/wait with one scheduler per partition).

    Control plane (reference: runtime_monitor/proxy mirroring
    DONE/FLUSH/EXIT, SURVEY.md §4.5): when a partition fails, it ships
    abort frames on its outgoing zmq edges (downstream peers fail within
    one batch) and this Runtime stops its sibling partitions immediately;
    ``wait()`` then raises with the first error. ``stop()`` aborts a
    running distributed graph cleanly."""

    def __init__(self, partitions: dict[str, Flowgraph],
                 total_items: dict[str, int] | None = None,
                 control_addresses: dict[str, str] | None = None,
                 control_auth_key: bytes | None = None):
        self.partitions = partitions
        self.total_items = total_items or {}
        self._threads: list[threading.Thread] = []
        self._errors: dict[str, str] = {}
        self._error_order: list[str] = []
        self._runners: dict[str, object] = {}
        # Cross-process control plane (reference: runtime_proxy mirroring
        # param/message actions between processes, SURVEY.md §4.5): one
        # ControlServer per named partition; remote RuntimeClients can
        # set_param/post_msg/stop blocks living here mid-run.
        self._control_servers: list = []
        for name, addr in (control_addresses or {}).items():
            if name not in partitions:
                raise ValueError(f"control address for unknown partition "
                                 f"{name!r}")
            from newsched_tpu.runtime.control import ControlServer

            def _blk(bname, _fg=partitions[name]):
                return next((b for b in _fg.blocks if b.name == bname), None)

            self._control_servers.append(ControlServer(
                addr, lambda _n=name: self._runners.get(_n), _blk,
                auth_key=control_auth_key))

    def start(self) -> None:
        from newsched_tpu.runtime.block import StreamAborted
        from newsched_tpu.runtime.runner import Runner

        def run_one(name: str, fg: Flowgraph):
            runner = None
            try:
                fg.validate()
                runner = Runner(fg, batch_size=fg.batch_size,
                                total_items=self.total_items.get(name))
                self._runners[name] = runner
                runner.run_to_completion()
            except StreamAborted:
                log.info("partition %s aborted cleanly", name)
            except Exception:
                import traceback

                self._errors[name] = traceback.format_exc()
                self._error_order.append(name)
                log.error("partition %s failed:\n%s", name, self._errors[name])
                # Fail fast everywhere: downstream peers get abort frames,
                # sibling partitions in this process are stopped directly.
                if runner is not None:
                    runner.abort_peers()
                self._stop_siblings(name)

        for name, fg in self.partitions.items():
            t = threading.Thread(target=run_one, args=(name, fg), daemon=True,
                                 name=f"partition-{name}")
            self._threads.append(t)
            t.start()

    def _stop_siblings(self, failed: str) -> None:
        for name, runner in list(self._runners.items()):
            if name != failed:
                runner.request_stop()

    def stop(self) -> None:
        """Abort all partitions cleanly (reference: runtime stop broadcast)."""
        for runner in list(self._runners.values()):
            runner.request_stop()

    def wait(self) -> None:
        for t in self._threads:
            t.join()
        for s in self._control_servers:
            s.close()
        self._control_servers.clear()
        if self._errors:
            first = self._error_order[0] if self._error_order else next(iter(self._errors))
            raise RuntimeError(
                f"partition {first!r} failed (all failed: {list(self._errors)})\n"
                + self._errors[first])

    def run(self) -> None:
        self.start()
        self.wait()
