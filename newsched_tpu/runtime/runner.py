"""Execution engine: runs a compiled flowgraph to completion.

The runtime successor of the reference's scheduler start/wait machinery and
flowgraph_monitor (SURVEY.md §3.2): where nbt spun one thread per block
group and coordinated DONE/FLUSH/EXIT messages, this runner executes the
single compiled step function in one of two modes:

- **scan mode** (default when every block is device-pure): a bounded
  stream runs as one ``lax.scan`` on device — zero host round trips, XLA
  pipelines everything. An unbounded device-pure stream under start()
  runs as repeated scan chunks until stop() (run() on an unbounded graph
  raises — it could never return).
- **loop mode** (host IO / throttle / live control): a Python loop calls the
  jitted step per batch with donated state, dispatching asynchronously so
  host work overlaps device compute; between batches it drains the message
  queue and rebinds changed parameters (the analog of the reference's
  per-thread concurrent_queue draining).

Shutdown protocol: the reference's DONE -> FLUSH -> EXIT dance collapses to
arithmetic — the compiler knows each sink's exact total, the runner runs
exactly ``n_batches`` steps and trims each sink's final partial batch.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any

import jax
import numpy as np

from newsched_tpu.runtime.block import StreamAborted
from newsched_tpu.runtime.compile import compile_flowgraph
from newsched_tpu.utils import cplx
from newsched_tpu.utils.logger import get_logger
from newsched_tpu.utils.optional import require

log = get_logger("runner")


class Runner:
    """All jit boundaries are complex-encoded (utils/cplx.py): states enter
    and leave programs as real planes, complex parameters and sink
    collections likewise."""

    def __init__(self, fg, batch_size: int | None = None, mesh=None,
                 total_items: int | None = None, resume_from: str | None = None,
                 checkpoint_path: str | None = None, checkpoint_every: int = 0,
                 collect_stats: bool = False, profile_dir: str | None = None,
                 tag_capacity_limit: int | None = None):
        self.fg = fg
        self.mesh = mesh
        self.resume_from = resume_from
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.collect_stats = collect_stats
        # SURVEY.md §6: the reference has no built-in tracer (external
        # gr-bench + perf); here device-level tracing is one flag away.
        self.profile_dir = profile_dir
        self.stats: dict = {"batches": 0, "items": 0, "batch_seconds": []}
        self.cfg = compile_flowgraph(fg, batch_size=batch_size, total_items=total_items,
                                     mesh=mesh,
                                     tag_capacity_limit=tag_capacity_limit)
        self._msg_queue: collections.deque = collections.deque()
        self._dirty_params: set[str] = set()
        self._fence_dirty = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._has_host_io = any(getattr(b, "host_io", False) for b in self.cfg.order)
        self._has_pacing = any(getattr(b, "pacing", None) for b in self.cfg.order)
        self._jit_step = self._make_jit_step()

    def _make_jit_step(self):
        """A FRESH closure each call: jax.jit caches by function identity,
        so rebuilding after a fence-parameter change forces a retrace that
        picks up the block's new trace-time constants (recompile fence,
        runtime/block.py ParamSpec.fence)."""
        step = self.cfg.step

        def step_enc(states_enc, params_enc, host_ins_enc):
            ns, so = step(cplx.decode(states_enc), cplx.decode(params_enc),
                          cplx.decode(host_ins_enc))
            return cplx.encode(ns), cplx.encode(so)

        return jax.jit(step_enc, donate_argnums=(0,))

    def _init_states_enc(self):
        """Build initial states ON DEVICE inside one program, returning
        encoded leaves."""
        return jax.jit(lambda: cplx.encode(self.cfg.init_states()))()

    def _params_enc(self):
        return cplx.encode(self.cfg.init_params())

    # -- control plane ---------------------------------------------------
    def invalidate_params(self, block) -> None:
        self._dirty_params.add(block.name)

    def invalidate_fence(self, block) -> None:
        """A recompile-fence parameter changed: rebind the params leaf AND
        retrace the compiled step at the next batch/chunk boundary (the
        block already rebuilt its trace-time constants in set_param)."""
        self._dirty_params.add(block.name)
        self._fence_dirty = True

    def enqueue_msg(self, block, port: str, msg: Any) -> None:
        self._msg_queue.append((block, port, msg))

    def _drain_msgs(self) -> None:
        while self._msg_queue:
            block, port, msg = self._msg_queue.popleft()
            block._msg_handlers[port](msg)

    def request_stop(self) -> None:
        self._stop.set()
        # Unblock any host-IO block stuck on a socket so the stop takes
        # effect within one poll interval, not one receive timeout.
        for b in self.cfg.order:
            if hasattr(b, "request_abort"):
                b.request_abort()

    def abort_peers(self) -> None:
        """This partition failed: ship abort frames downstream so peers
        fail within one batch (reference: runtime_monitor mirroring EXIT
        across runtime_proxy, SURVEY.md §4.5)."""
        for b in self.cfg.order:
            if hasattr(b, "send_abort"):
                try:
                    b.send_abort()
                except Exception:
                    pass

    # -- execution -------------------------------------------------------
    def run_to_completion(self) -> None:
        if self.profile_dir:
            # Device-level trace (TensorBoard/xprof format) around the whole
            # run — the tracing upgrade SURVEY.md §6 plans in from the start.
            with jax.profiler.trace(self.profile_dir):
                self._run_to_completion()
            return
        self._run_to_completion()

    def _run_to_completion(self) -> None:
        for b in self.cfg.order:
            b._runtime = self
            b.start()
        try:
            if self.cfg.n_batches is None:
                raise ValueError(
                    "flowgraph is unbounded: add a head block, a finite source, "
                    "or pass total_items (or use start()/stop() for live runs)"
                )
            use_scan = self._can_scan() and self.cfg.n_batches >= 2
            if use_scan:
                self._run_scan(self.cfg.n_batches)
            else:
                self._run_loop(self.cfg.n_batches)
        finally:
            for b in self.cfg.order:
                b.stop()
                b._runtime = None

    def _can_scan(self) -> bool:
        """Device-pure graph: no host IO, pacing, messages, checkpointing,
        or stats — everything can stay on device across batches."""
        return not (self._has_host_io or self._has_pacing or self._msg_queue
                    or self.resume_from or self.checkpoint_path
                    or self.collect_stats)

    def _run_scan(self, n_batches: int) -> None:
        step = self.cfg.step
        params_enc = self._params_enc()
        run_all = getattr(self, "_run_all_cache", {}).get(n_batches)
        if run_all is None:

            @jax.jit
            def run_all(params_enc):
                params = cplx.decode(params_enc)

                def scan_fn(states, _):
                    new_states, sink_out = step(states, params)
                    return new_states, cplx.encode(sink_out)

                # States are built inside the program: complex leaves never
                # cross the boundary; the scan carry stays internal.
                states0 = self.cfg.init_states()
                final, stacked = jax.lax.scan(scan_fn, states0, xs=None,
                                              length=n_batches)
                del final
                return stacked

            self._run_all_cache = getattr(self, "_run_all_cache", {})
            self._run_all_cache[n_batches] = run_all

        stacked = run_all(params_enc)
        jax.block_until_ready(stacked)
        self._deliver_stacked(stacked, n_batches)

    # -- checkpoint/resume (reference has none; SURVEY.md §6 upgrade:
    # all state is an explicit pytree, so snapshotting is trivial) -------
    def _save_checkpoint(self, states_enc, batch_idx: int) -> None:
        ocp = require("orbax.checkpoint", "orbax-checkpoint", "checkpointing")

        host = jax.device_get(states_enc)
        # Key by topological position, not block name: auto-generated
        # instance names differ between otherwise-identical graph builds,
        # but resume only requires structural identity.
        ordered = {f"b{i:04d}": host[b.name] for i, b in enumerate(self.cfg.order)}
        path = os.path.abspath(self.checkpoint_path)
        ckpt = ocp.StandardCheckpointer()
        ckpt.save(os.path.join(path, f"step_{batch_idx}"),
                  {"states": ordered, "batch_idx": batch_idx}, force=True)
        ckpt.wait_until_finished()

    def _load_checkpoint(self):
        ocp = require("orbax.checkpoint", "orbax-checkpoint", "checkpointing")

        path = os.path.abspath(self.resume_from)
        steps = sorted(
            (int(d.split("_")[1]) for d in os.listdir(path) if d.startswith("step_")),
        )
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {path}")
        latest = steps[-1]
        template_named = jax.device_get(self._init_states_enc())
        template = {f"b{i:04d}": template_named[b.name]
                    for i, b in enumerate(self.cfg.order)}
        ckpt = ocp.StandardCheckpointer()
        restored = ckpt.restore(os.path.join(path, f"step_{latest}"),
                                {"states": template, "batch_idx": 0})
        states = {b.name: restored["states"][f"b{i:04d}"]
                  for i, b in enumerate(self.cfg.order)}
        return states, int(restored["batch_idx"])

    def _run_loop(self, n_batches: int, unbounded: bool = False) -> None:
        params = self._params_enc()
        start_batch = 0
        if self.resume_from:
            states, start_batch = self._load_checkpoint()
        else:
            states = self._init_states_enc()
        per_sink: dict[str, list] = {name: [] for name in self.cfg.sink_totals}
        pullers = [b for b in self.cfg.order if hasattr(b, "host_pull")]
        pushers = {b.name: b for b in self.cfg.order if hasattr(b, "host_push")}
        t0 = time.monotonic()
        items_done = 0
        try:
            for i in range(start_batch, n_batches):
                if self._stop.is_set():
                    break
                bt0 = time.monotonic() if self.collect_stats else 0.0
                self._drain_msgs()
                # snapshot-then-clear: remote ControlServer threads may
                # add names concurrently (runtime/control.py)
                dirty, self._dirty_params = self._dirty_params, set()
                for name in dirty:
                    blk = next(b for b in self.cfg.order if b.name == name)
                    params[name] = cplx.encode(blk.param_leaves())
                if self._fence_dirty:
                    self._fence_dirty = False
                    self._jit_step = self._make_jit_step()
                host_ins = cplx.encode(
                    {b.name: b.host_pull(self.cfg.n_out[b.name]) for b in pullers}
                )
                states, sink_out = self._jit_step(states, params, host_ins)
                for name, v in sink_out.items():
                    if name in pushers:
                        # streaming egress (zmq/audio-style sinks): deliver
                        # this batch now rather than accumulating to the end
                        pushers[name].host_push(cplx.decode(jax.device_get(v)))
                    else:
                        per_sink.setdefault(name, []).append(v)
                if unbounded:
                    self._bound_collections(per_sink, per_batch=True)
                items_done += self.cfg.batch_ref
                if self.checkpoint_path and self.checkpoint_every and \
                        (i + 1) % self.checkpoint_every == 0:
                    self._save_checkpoint(states, i + 1)
                if self.collect_stats:
                    jax.block_until_ready(states)
                    self.stats["batch_seconds"].append(time.monotonic() - bt0)
                    self.stats["batches"] += 1
                    self.stats["items"] += self.cfg.batch_ref
                self._pace(items_done, t0)
        except StreamAborted as e:
            # Clean local abort (Runtime.stop / sibling shutdown): end the
            # stream here, deliver what was collected.
            log.info("stream aborted: %s", e)
        jax.block_until_ready(states)
        if self.checkpoint_path:
            self._save_checkpoint(states, n_batches)
        self._deliver_batches({k: v for k, v in per_sink.items() if v})

    def _pace(self, items_done: int, t0: float) -> None:
        """items_done is at the REFERENCE rate; each throttle paces by the
        item count in its own stream domain (rate-scaled), so a throttle
        after a decimator sees 1/decim of the reference items. The slowest
        throttle governs (max target time)."""
        if not self._has_pacing:
            return
        target = 0.0
        for b in self.cfg.order:
            p = getattr(b, "pacing", None)
            if p:
                items_here = items_done * float(self.cfg.rates[b.name])
                target = max(target, items_here / p)
        dt = target - (time.monotonic() - t0)
        if dt > 0:
            time.sleep(dt)

    # -- unbounded-run memory bounds --------------------------------------
    # The reference never buffers unboundedly anywhere (SURVEY.md §3.2
    # backpressure); here a live stream's collecting sinks must either
    # fold incrementally (combine_collected), keep a declared trailing
    # window (collect_capacity), or be rejected before the run starts.
    def _check_unbounded_sinks(self) -> None:
        for name in self.cfg.sink_totals:
            b = next(blk for blk in self.cfg.order if blk.name == name)
            if (hasattr(b, "host_push") or hasattr(b, "combine_collected")
                    or getattr(b, "collect_capacity", None) is not None):
                continue
            raise ValueError(
                f"sink {name!r} collects an UNBOUNDED stream into host "
                f"memory: give it a capacity (vector_sink(capacity=...)), "
                f"use a streaming sink (zmq/file/audio), or bound the "
                f"stream (head block / total_items)")

    def _bound_collections(self, per_sink: dict[str, list],
                           per_batch: bool) -> None:
        """Fold/trim live collections so host memory stays bounded.

        per_batch=True: entries are per-batch DEVICE values (loop mode) —
        combiners fold every 256 batches (device_get of already-ready
        values, off the dispatch critical path); rings drop leading
        batches beyond the capacity window. per_batch=False: entries are
        host chunk pytrees from _run_unbounded_chunked.
        """
        acc = getattr(self, "_collect_acc", None)
        if acc is None:
            acc = self._collect_acc = {}
            self._dropped_items: dict[str, int] = {}
        for name, lst in per_sink.items():
            if not lst:
                continue
            b = next(blk for blk in self.cfg.order if blk.name == name)
            if hasattr(b, "combine_collected"):
                if not per_batch or len(lst) >= 256:
                    host = [cplx.decode(h) for h in jax.device_get(lst)]
                    acc[name] = b.combine_collected(acc.get(name), host)
                    lst.clear()
                continue
            cap = getattr(b, "collect_capacity", None)
            if cap is None:
                continue

            def n_items(entry):
                if per_batch:
                    return self.cfg.n_in[name]
                leaf = next(x for x in jax.tree_util.tree_leaves(
                    entry, is_leaf=_is_tagbatch) if not _is_tagbatch(x))
                return int(np.shape(leaf)[0])

            total = sum(n_items(e) for e in lst)
            while len(lst) > 1 and total - n_items(lst[0]) >= cap:
                total -= n_items(lst[0])
                self._dropped_items[name] = (self._dropped_items.get(name, 0)
                                             + n_items(lst[0]))
                lst.pop(0)
            self.stats["retained_items"] = max(
                self.stats.get("retained_items", 0), total)

    # -- delivery --------------------------------------------------------
    def _trim(self, b, collected):
        """Drop leading garbage and the final partial batch's padding for
        stream-collecting sinks (the compiler's exact-totals arithmetic)."""
        if not getattr(b, "collect_is_stream", True):
            return collected
        lead = self.cfg.sink_leads.get(b.name, 0)
        # Ring-trimmed live collections already dropped their leading
        # batches (and with them any leading garbage items).
        lead = max(0, lead - getattr(self, "_dropped_items", {}).get(b.name, 0))
        total = self.cfg.sink_totals.get(b.name)
        end = None if total is None else lead + total
        return jax.tree_util.tree_map(lambda a: a[lead:end], collected)

    def _finalize_sink(self, b, collected_host) -> None:
        """collected_host: host pytree; stream leaves have batches flattened
        into the leading axis; TagBatch nodes keep their (n_batches, K)
        shape for absolute-offset reconstruction."""
        from newsched_tpu.runtime import tags as tags_mod

        total = self.cfg.sink_totals.get(b.name)
        lead = max(0, self.cfg.sink_leads.get(b.name, 0)
                   - getattr(self, "_dropped_items", {}).get(b.name, 0))
        if isinstance(collected_host, dict) and "tags" in collected_host \
                and getattr(b, "collects_tags", False):
            data = self._trim(b, cplx.decode(collected_host["data"]))
            raw = tags_mod.decode_batches(collected_host["tags"],
                                          self.cfg.n_in[b.name])
            hi = np.inf if total is None else total
            tags = [t._replace(offset=t.offset - lead) for t in raw
                    if 0 <= t.offset - lead < hi]
            b.finalize({"data": data, "tags": tags}, total)
        else:
            b.finalize(self._trim(b, cplx.decode(collected_host)), total)

    def _deliver_stacked(self, stacked: dict[str, Any], n_batches: int) -> None:
        # ONE device_get for all sinks: one device-to-host synchronisation
        # per delivery instead of one per sink.
        host = jax.device_get(stacked)
        drops = host.pop("__tag_drops__", None)
        if drops is not None:
            n = int(np.sum(np.asarray(drops)))
            self.stats["tag_drops"] = self.stats.get("tag_drops", 0) + n
            if n:
                log.warning("tag_capacity_limit compaction dropped %d tags", n)
        for b in self.cfg.order:
            if b.name in host:
                self._finalize_sink(b, _unstack_to_host(host[b.name]))

    def _deliver_batches(self, per_sink: dict[str, list]) -> None:
        # Unbounded loop-mode combiners: fold any staged tail into the
        # accumulator and finalize from it directly.
        acc = getattr(self, "_collect_acc", {})
        for name in list(acc):
            b = next(blk for blk in self.cfg.order if blk.name == name)
            staged = per_sink.pop(name, [])
            if staged:
                host_staged = [cplx.decode(h) for h in jax.device_get(staged)]
                acc[name] = b.combine_collected(acc[name], host_staged)
            b.finalize(acc[name], None)
        host = jax.device_get(per_sink)
        drops = host.pop("__tag_drops__", None)
        if drops:
            n = int(np.sum([np.asarray(d) for d in drops]))
            self.stats["tag_drops"] = self.stats.get("tag_drops", 0) + n
            if n:
                log.warning("tag_capacity_limit compaction dropped %d tags", n)
        for b in self.cfg.order:
            if b.name in host and host[b.name]:
                self._finalize_sink(b, _transpose(host[b.name]))

    # -- async (start/wait) ---------------------------------------------
    def start_async(self) -> None:
        self._thread = threading.Thread(target=self._async_body, daemon=True)
        self._thread.start()

    def _async_body(self) -> None:
        try:
            for b in self.cfg.order:
                b._runtime = self
                b.start()
            try:
                n = self.cfg.n_batches
                if n is None:
                    # Unbounded: device-pure graphs run as repeated jitted
                    # scan chunks (zero per-batch host round trips); host-IO
                    # graphs fall back to the per-batch loop. Either way the
                    # sinks must hold bounded host memory — checked up front.
                    self._check_unbounded_sinks()
                    if self._can_scan():
                        self._run_unbounded_chunked()
                    else:
                        self._run_loop(1 << 62, unbounded=True)  # until stop()
                else:
                    self._run_loop(n)
            finally:
                for b in self.cfg.order:
                    b.stop()
                    b._runtime = None
        except Exception:  # surfaced on wait()
            import traceback

            self._exc = traceback.format_exc()
            log.error("runner thread failed:\n%s", self._exc)

    def _run_unbounded_chunked(self, chunk: int = 8) -> None:
        """Unbounded device-pure stream as repeated ``lax.scan`` chunks.
        stop() and parameter changes take effect at chunk granularity;
        sink data is host-fetched once per chunk and delivered on stop."""
        def make_chunk():
            # fresh closure per fence retrace (see _make_jit_step)
            step = self.cfg.step

            @jax.jit
            def run_chunk(states_enc, params_enc):
                params = cplx.decode(params_enc)

                def scan_fn(se, _):
                    ns, so = step(cplx.decode(se), params)
                    return cplx.encode(ns), cplx.encode(so)

                return jax.lax.scan(scan_fn, states_enc, xs=None,
                                    length=chunk)

            return run_chunk

        run_chunk = make_chunk()
        states = self._init_states_enc()
        params = self._params_enc()
        per_sink: dict[str, list] = {name: [] for name in self.cfg.sink_totals}
        while not self._stop.is_set():
            self._drain_msgs()
            dirty, self._dirty_params = self._dirty_params, set()
            for name in dirty:
                blk = next(b for b in self.cfg.order if b.name == name)
                params[name] = cplx.encode(blk.param_leaves())
            if self._fence_dirty:
                self._fence_dirty = False
                run_chunk = make_chunk()
            states, stacked = run_chunk(states, params)
            host = jax.device_get(stacked)
            for name, v in host.items():
                per_sink[name].append(_unstack_to_host(v))
            self._bound_collections(per_sink, per_batch=False)
            self.stats["batches"] += chunk
            self.stats["items"] += chunk * self.cfg.batch_ref
        jax.block_until_ready(states)
        acc = getattr(self, "_collect_acc", {})
        for b in self.cfg.order:
            if b.name in acc:
                b.finalize(acc[b.name], None)
            elif b.name in per_sink and per_sink[b.name]:
                self._finalize_sink(b, _concat_chunks(per_sink[b.name]))

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            if getattr(self, "_exc", None):
                raise RuntimeError(f"flowgraph execution failed:\n{self._exc}")


def _is_tagbatch(x) -> bool:
    from newsched_tpu.runtime.tags import TagBatch

    return isinstance(x, TagBatch)


def _unstack_to_host(tree):
    """Stacked scan output pytree (leading n_batches axis on every leaf) ->
    host pytree with batches flattened into the leading axis. TagBatch
    nodes keep their per-batch leading axis."""
    from newsched_tpu.runtime.tags import TagBatch

    host = jax.device_get(tree)

    def fix(x):
        if _is_tagbatch(x):
            return TagBatch(*(np.asarray(l) if l is not None else None for l in x))
        a = np.asarray(x)
        return np.reshape(a, (-1,) + a.shape[2:])

    return jax.tree_util.tree_map(fix, host, is_leaf=_is_tagbatch)


def _concat_chunks(chunks: list):
    """List of already-flattened chunk pytrees (from _unstack_to_host) ->
    one host pytree: stream leaves AND TagBatch per-batch axes concatenate."""
    from newsched_tpu.runtime.tags import TagBatch

    def comb(*xs):
        if _is_tagbatch(xs[0]):
            return TagBatch(*(np.concatenate([np.asarray(getattr(x, f)) for x in xs])
                              if getattr(xs[0], f) is not None else None
                              for f in xs[0]._fields))
        return np.concatenate([np.atleast_1d(np.asarray(x)) for x in xs])

    return jax.tree_util.tree_map(comb, *chunks, is_leaf=_is_tagbatch)


def _transpose(batches: list):
    """List of per-batch pytrees -> host pytree: stream leaves concatenated,
    TagBatch nodes stacked (keeping the per-batch axis)."""
    from newsched_tpu.runtime.tags import TagBatch

    if not batches:
        return batches

    def comb(*xs):
        if _is_tagbatch(xs[0]):
            return TagBatch(*(np.stack([np.asarray(getattr(x, f)) for x in xs])
                              if getattr(xs[0], f) is not None else None
                              for f in xs[0]._fields))
        return np.concatenate([np.atleast_1d(np.asarray(x)) for x in xs])

    return jax.tree_util.tree_map(comb, *batches, is_leaf=_is_tagbatch)
