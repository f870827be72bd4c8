"""Block, Port, and parameter machinery.

The compile-time analog of the reference's node/block/port model
(runtime/include/gnuradio/node.h, port.h, block.h) and its YAML parameter
descriptors. A Block here is:

  - a declarative spec: typed stream ports (with per-item shape, the
    reference's vlen), a rational relative rate (out items per in item),
    parameter descriptors, message-port handlers;
  - a pure work function ``work(state, ins, params, nout) -> (state, outs)``
    traced once at compile time and executed over fixed-size time batches.

What the reference implements as scheduler plumbing disappears:
``consume/produce`` bookkeeping is the compile-time rate algebra;
``request_parameter_change`` becomes rebinding a leaf of the params pytree
passed into the jitted step (no recompile, no queues, no locks);
``work_return_code_t`` is unnecessary because batch sizes are static.
"""

from __future__ import annotations

import dataclasses
import itertools
from fractions import Fraction
from typing import Any, Callable

import jax.numpy as jnp
import numpy as np

from newsched_tpu.utils.dtypes import StreamDType, port_dtype
from newsched_tpu.utils.logger import get_logger

IN = "input"
OUT = "output"


class StreamAborted(Exception):
    """Raised by host-IO blocks when the stream is locally aborted (user
    stop / sibling-partition shutdown). The runner treats it as a clean
    early end of stream — unlike a peer's abort FRAME, which raises
    RuntimeError and propagates as a partition failure (the reference's
    runtime_monitor DONE/EXIT vs error distinction, SURVEY.md §3.1)."""


@dataclasses.dataclass(frozen=True)
class Port:
    """A typed stream port. item_shape is the reference's vlen generalized:
    each stream item may itself be an array (e.g. (nchans,) for the
    channelizer output)."""

    name: str
    dtype: StreamDType
    direction: str = IN
    item_shape: tuple[int, ...] = ()

    def compatible_with(self, other: "Port") -> bool:
        return self.dtype.np_dtype == other.dtype.np_dtype and self.item_shape == other.item_shape


@dataclasses.dataclass
class ParamSpec:
    name: str
    default: Any
    dtype: Any = np.float32
    settable: bool = True
    doc: str = ""
    # fence=True marks a RECOMPILE-FENCE parameter (SURVEY.md §8 "recompile
    # fence for shape params"): its value is baked into trace-time constants
    # (e.g. the fused wbfm chain's rotated Toeplitz taps), so setting it
    # mid-run rebuilds the block's derived constants (``on_fence_param``
    # hook) and makes the runner RETRACE the compiled step at the next
    # batch/chunk boundary instead of merely rebinding a params leaf.
    fence: bool = False


def param(default, dtype=np.float32, settable=True, doc="") -> ParamSpec:
    """Declare a runtime-settable block parameter (reference: the YAML
    ``parameters:`` stanza + request_parameter_change machinery)."""
    return ParamSpec(name="", default=default, dtype=dtype, settable=settable, doc=doc)


class _PortRef:
    """(block, port_name) endpoint used by graph.connect."""

    __slots__ = ("block", "port")

    def __init__(self, block: "Block", port: str):
        self.block = block
        self.port = port

    def __repr__(self):
        return f"{self.block.name}.{self.port}"


_instance_counters: dict[str, itertools.count] = {}


class Block:
    """Base class for all blocks.

    Subclasses set, in __init__ (or as class attrs):
      self.inputs / self.outputs: list[Port]
      self.relative_rate: Fraction — out items per in item (sync blocks: 1)
      parameters via self.declare_param(...)
    and implement:
      init_state(self, nin, nout) -> pytree (default: empty tuple)
      work(self, state, ins, params, nout) -> (new_state, outs)

    ``ins``/``outs`` map port name -> Array of shape (n_items, *item_shape).
    ``params`` maps param name -> jnp scalar/array (traced; changing a value
    does NOT recompile). ``nin``/``nout`` are static python ints fixed by the
    compiler's rate algebra.
    """

    relative_rate: Fraction = Fraction(1)
    # Tag propagation policy, mirroring the reference's
    # tag_propagation_policy_t {TPP_DONT, TPP_ALL_TO_ALL, TPP_ONE_TO_ONE}.
    tag_policy: str = "all_to_all"

    def __init__(self, name: str | None = None):
        cls = type(self).__name__
        counter = _instance_counters.setdefault(cls, itertools.count())
        self.name = name or f"{cls.lower()}_{next(counter)}"
        self.inputs: list[Port] = list(getattr(self, "inputs", []))
        self.outputs: list[Port] = list(getattr(self, "outputs", []))
        self._param_specs: dict[str, ParamSpec] = {}
        self._param_values: dict[str, Any] = {}
        self._msg_handlers: dict[str, Callable[[Any], None]] = {}
        self._msg_subscribers: dict[str, list[tuple["Block", str]]] = {}
        self._runtime = None  # set by the runner while the graph is running
        self.log = get_logger(self.name)

    # -- ports ----------------------------------------------------------
    def add_input(self, name: str, dtype, item_shape: tuple[int, ...] = ()) -> Port:
        p = Port(name, port_dtype(dtype), IN, tuple(item_shape))
        self.inputs.append(p)
        return p

    def add_output(self, name: str, dtype, item_shape: tuple[int, ...] = ()) -> Port:
        p = Port(name, port_dtype(dtype), OUT, tuple(item_shape))
        self.outputs.append(p)
        return p

    def input_port(self, key: str | int) -> Port:
        return self._find(self.inputs, key)

    def output_port(self, key: str | int) -> Port:
        return self._find(self.outputs, key)

    @staticmethod
    def _find(ports: list[Port], key) -> Port:
        if isinstance(key, int):
            return ports[key]
        for p in ports:
            if p.name == key:
                return p
        raise KeyError(f"no port {key!r}; have {[p.name for p in ports]}")

    def o(self, port: str | int = 0) -> _PortRef:
        """Output endpoint for graph.connect (pythonic sugar)."""
        return _PortRef(self, self.output_port(port).name)

    def i(self, port: str | int = 0) -> _PortRef:
        return _PortRef(self, self.input_port(port).name)

    # -- parameters -----------------------------------------------------
    def declare_param(self, name: str, default, dtype=np.float32, settable=True,
                      doc="", fence=False) -> None:
        self._param_specs[name] = ParamSpec(name, default, dtype, settable,
                                            doc, fence)
        self._param_values[name] = default

    def set_param(self, name: str, value) -> None:
        """Set a parameter. While running, takes effect on the next batch —
        the runner rebinds the params pytree leaf (the analog of the
        reference's queued param_change_action, minus the queue). A FENCE
        parameter (ParamSpec.fence) additionally calls the block's
        ``on_fence_param(name, value)`` hook to rebuild trace-time
        constants and asks the runner to retrace the compiled step at the
        next batch/chunk boundary (scan-mode bounded runs compile the
        whole stream as one program, so fences there apply only when set
        before run())."""
        spec = self._param_specs[name]
        if not spec.settable:
            raise ValueError(f"parameter {name} of {self.name} is not settable")
        self._param_values[name] = value
        if spec.fence:
            hook = getattr(self, "on_fence_param", None)
            if hook is not None:
                hook(name, value)
        if self._runtime is not None:
            if spec.fence and hasattr(self._runtime, "invalidate_fence"):
                self._runtime.invalidate_fence(self)
            else:
                self._runtime.invalidate_params(self)

    def get_param(self, name: str):
        return self._param_values[name]

    def param_leaves(self) -> dict[str, np.ndarray]:
        """Current values as HOST numpy leaves for the compiled step's
        params pytree. Host-side on purpose: complex values cross program
        boundaries only as real planes (utils/cplx.py), and numpy leaves
        are free to pass as jit arguments."""
        out = {}
        for name, spec in self._param_specs.items():
            v = self._param_values[name]
            if spec.dtype is None:
                out[name] = v
            else:
                out[name] = np.asarray(v, dtype=spec.dtype)
        return out

    # -- messages (host-side control plane) -----------------------------
    def add_msg_port_in(self, name: str, handler: Callable[[Any], None]) -> None:
        """Register an async message handler (reference: message_port +
        register handler). Handlers run on the host between batches."""
        self._msg_handlers[name] = handler

    def add_msg_port_out(self, name: str) -> None:
        self._msg_subscribers.setdefault(name, [])

    def post_msg(self, port: str, msg: Any) -> None:
        """Publish a message to subscribers of an output message port."""
        for blk, in_port in self._msg_subscribers.get(port, []):
            if blk._runtime is not None:
                blk._runtime.enqueue_msg(blk, in_port, msg)
            else:
                blk._msg_handlers[in_port](msg)

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        """Host-side start hook (open files, sockets...). Reference:
        block::start()."""

    def stop(self) -> None:
        """Host-side stop hook. Reference: block::stop()."""

    # -- the work interface --------------------------------------------
    def init_state(self, nin: int, nout: int):
        return ()

    def work(self, state, ins: dict[str, jnp.ndarray], params: dict[str, Any], nout: int):
        raise NotImplementedError

    def __repr__(self):
        return f"<{type(self).__name__} {self.name}>"


class SyncBlock(Block):
    """1:1 rate convenience base (reference: sync_block.h)."""

    relative_rate = Fraction(1)
