"""Cross-process control plane for distributed flowgraphs (round 4).

The reference's runtime_proxy mirrors scheduler messages — including
param_change actions and msgport_message — between processes over its
custom zmq protocol (SURVEY.md §4.5, §3.1 scheduler-messages row), so a
block living in another process stays reachable mid-run. Here the same
capability is one REP socket per partition:

    process B (runs partition "tail"):
        rt = Runtime(parts,
                     control_addresses={"tail": "tcp://127.0.0.1:5701"})
        rt.run()                # control server thread starts with it

    process A (anyone holding the address):
        ctl = RuntimeClient("tcp://127.0.0.1:5701")
        ctl.set_param("mc0", "k", 3.0)      # applied before the next batch
        ctl.post_msg("fwd0", "in", {"cmd": "retune"})
        ctl.stop()

Every request is acknowledged; set_param/post_msg resolve the block BY
NAME inside the partition and go through the ordinary control plane
(Block.set_param -> runner param rebind between batches; runner message
queue -> handler drain), so remote and local control have identical
batch-boundary semantics.

**SECURITY — read before binding anything but loopback.** Values ride as
pickle, and unpickling attacker-controlled bytes is REMOTE CODE
EXECUTION: anyone who can reach the port owns the process. This matches
the reference's runtime_proxy trust model (it executes whatever its
peer runtimes send), but it must be deployed accordingly: bind loopback
(``tcp://127.0.0.1:...``) or ``ipc://`` endpoints, or a private
cluster interface — never ``tcp://*``. For links that cross a machine
boundary, pass a shared ``auth_key`` to BOTH ends: every frame is then
prefixed with an HMAC-SHA256 tag that the server verifies BEFORE any
pickle.loads (unauthenticated frames are dropped with an error reply
and never deserialized). The HMAC authenticates but does not encrypt —
use a private network or an SSH/WireGuard tunnel for confidentiality.
Binding a non-loopback tcp address without an auth_key logs a warning.

**get_param semantics (pending value):** the server reads the HOST-side
parameter value. In scan/chunked execution the device program rebinds
params at batch/chunk granularity, so a get_param immediately after a
set_param reports the new (PENDING) value — possibly one batch before
the device program computes with it. It answers "what was last
requested", not "what did the last batch use".
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import pickle
import threading
import time
from typing import Any

from newsched_tpu.utils.logger import get_logger
from newsched_tpu.utils.optional import require

log = get_logger("control")

_TAG_LEN = 32  # HMAC-SHA256


def _seal(payload: bytes, key: bytes | None) -> bytes:
    if key is None:
        return payload
    return hmac_mod.new(key, payload, hashlib.sha256).digest() + payload


def _unseal(frame: bytes, key: bytes | None) -> bytes | None:
    """Payload if authentic, None otherwise. MUST run before any
    deserialization — pickle.loads on an unauthenticated frame is RCE."""
    if key is None:
        return frame
    if len(frame) < _TAG_LEN:
        return None
    tag, payload = frame[:_TAG_LEN], frame[_TAG_LEN:]
    good = hmac_mod.new(key, payload, hashlib.sha256).digest()
    return payload if hmac_mod.compare_digest(tag, good) else None


def _warn_if_exposed(address: str, key: bytes | None) -> None:
    a = address.lower()
    if key is None and a.startswith("tcp://") and not (
            "127.0.0.1" in a or "localhost" in a or "[::1]" in a):
        log.warning(
            "control plane bound to %s WITHOUT auth_key: the wire format "
            "is pickle (= remote code execution for any peer that can "
            "connect). Bind loopback/ipc, or pass a shared auth_key.",
            address)


class ControlServer:
    """REP socket serving set_param/post_msg/stop/ping for one partition.

    Runs on its own thread; requests mutate host-side block/runner state,
    which the runner consumes at its existing batch/chunk boundaries."""

    def __init__(self, address: str, resolve_runner, resolve_block,
                 auth_key: bytes | None = None):
        """resolve_runner() -> Runner | None (None while starting up);
        resolve_block(name) -> Block | None. auth_key: shared HMAC key —
        frames failing verification are rejected before deserialization
        (module docstring security note)."""
        zmq = require("zmq", "pyzmq", "the control plane")

        self.address = address
        self._resolve_runner = resolve_runner
        self._resolve_block = resolve_block
        self._key = auth_key
        _warn_if_exposed(address, auth_key)
        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.REP)
        self._sock.bind(address)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name=f"control-{address}")
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._sock.close(0)

    def _serve(self) -> None:
        zmq = require("zmq", "pyzmq", "the control plane")

        poller = zmq.Poller()
        poller.register(self._sock, zmq.POLLIN)
        while not self._stop.is_set():
            if not dict(poller.poll(100)):
                continue
            authed = False
            try:
                payload = _unseal(self._sock.recv(), self._key)
                if payload is None:
                    log.warning("control frame failed HMAC auth — dropped "
                                "without deserializing")
                    rep = {"ok": False, "error": "auth failed"}
                else:
                    authed = True
                    req = pickle.loads(payload)
                    rep = self._handle(req)
            except Exception as e:  # malformed frame / handler error
                rep = {"ok": False, "error": repr(e)}
            try:
                # auth-failure replies go UNSEALED so the rejected peer
                # can read the error (the reply carries no secrets; a
                # keyed reply would be unparseable garbage to it)
                self._sock.send(_seal(pickle.dumps(rep),
                                      self._key if authed else None))
            except Exception:
                log.exception("control reply failed")

    def _wait_runner(self, timeout: float = 10.0):
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            r = self._resolve_runner()
            if r is not None:
                return r
            time.sleep(0.01)
        return None

    def _handle(self, req: dict) -> dict:
        op = req.get("op")
        if op == "ping":
            return {"ok": True}
        if op == "stop":
            r = self._wait_runner()
            if r is None:
                return {"ok": False, "error": "no runner"}
            r.request_stop()
            return {"ok": True}
        blk = self._resolve_block(req.get("block", ""))
        if blk is None:
            return {"ok": False,
                    "error": f"no block named {req.get('block')!r} here"}
        if op == "set_param":
            blk.set_param(req["param"], req["value"])
            return {"ok": True}
        if op == "get_param":
            return {"ok": True, "value": blk.get_param(req["param"])}
        if op == "post_msg":
            r = self._wait_runner()
            if r is None:
                return {"ok": False, "error": "no runner"}
            r.enqueue_msg(blk, req["port"], req["msg"])
            return {"ok": True}
        return {"ok": False, "error": f"unknown op {op!r}"}


class RuntimeClient:
    """REQ-side handle to a remote partition's ControlServer."""

    def __init__(self, address: str, timeout_ms: int = 5000,
                 auth_key: bytes | None = None):
        zmq = require("zmq", "pyzmq", "the control plane")

        self._ctx = zmq.Context.instance()
        self._key = auth_key
        self._sock = self._ctx.socket(zmq.REQ)
        self._sock.setsockopt(zmq.RCVTIMEO, timeout_ms)
        self._sock.setsockopt(zmq.SNDTIMEO, timeout_ms)
        self._sock.setsockopt(zmq.LINGER, 0)
        self._sock.connect(address)

    def _call(self, **req) -> Any:
        self._sock.send(_seal(pickle.dumps(req), self._key))
        payload = _unseal(self._sock.recv(), self._key)
        if payload is None:
            raise RuntimeError("remote control reply failed HMAC auth")
        rep = pickle.loads(payload)
        if not rep.get("ok"):
            raise RuntimeError(f"remote control failed: {rep.get('error')}")
        return rep.get("value")

    def ping(self) -> None:
        self._call(op="ping")

    def set_param(self, block: str, param: str, value) -> None:
        """Set a runtime parameter on a block in the remote partition;
        applied by its runner before the next batch (same semantics as a
        local Block.set_param mid-run)."""
        self._call(op="set_param", block=block, param=param, value=value)

    def get_param(self, block: str, param: str):
        return self._call(op="get_param", block=block, param=param)

    def post_msg(self, block: str, port: str, msg) -> None:
        """Deliver a message to a remote block's input message port
        (drained by its runner between batches, like local enqueue_msg)."""
        self._call(op="post_msg", block=block, port=port, msg=msg)

    def stop(self) -> None:
        self._call(op="stop")

    def close(self) -> None:
        self._sock.close(0)
