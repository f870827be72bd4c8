"""Flowgraph compiler: rate algebra + single-step program builder.

This module is what deletes the reference's scheduler (SURVEY.md §4.3): the
entire job of schedulers/nbt/graph_executor.cc — windowing, rate matching,
buffer sizing, notification — is solved *once, statically*:

  1. Rational rate propagation assigns every block an items-per-reference-
     item Fraction (the compile-time replacement for the runtime
     forecast/consume/produce dance).
  2. A batch size N is chosen as the smallest multiple of the LCM of all
     rate denominators >= the requested size, so every edge carries a
     compile-time-fixed integer item count.
  3. Finite-stream bounds (head blocks, finite sources) propagate through
     the same algebra to give exact per-sink totals and the batch count.
  4. ``build_step`` emits the pure function (states, params) ->
     (states, sink_outputs) that XLA compiles and fuses end-to-end.
"""

from __future__ import annotations

import dataclasses
import math
from fractions import Fraction
from typing import Any, Callable

from newsched_tpu.runtime.block import Block
from newsched_tpu.runtime.graph import Graph
from newsched_tpu.utils.logger import get_logger

log = get_logger("compile")

DEFAULT_BATCH = 1 << 16


@dataclasses.dataclass
class CompiledFlowgraph:
    graph: Graph
    order: list[Block]
    rates: dict[str, Fraction]  # block name -> output rate (items/ref item)
    batch_ref: int  # N: reference items per batch
    n_in: dict[str, int]  # per-block input items per batch
    n_out: dict[str, int]  # per-block output items per batch
    bounds: dict[str, int | None]  # per-block total output items (None = inf)
    leads: dict[str, int]  # per-block leading garbage items at output
    n_batches: int | None  # None if unbounded
    sink_totals: dict[str, int | None]  # sink block name -> total input items
    sink_leads: dict[str, int]  # sink block name -> leading items to drop
    step: Callable[[dict, dict], tuple[dict, dict]]
    mesh: Any = None  # device mesh the step is constrained to (None = single)
    time_axis: str | None = None

    def _mesh_n(self) -> int:
        return (math.prod(self.mesh.shape.values())
                if self.mesh is not None else 1)

    def init_states(self) -> dict[str, Any]:
        # Blocks may carry a mesh-shaped state variant (e.g. the fused
        # chain block's per-device carry rows) via
        # ``init_state_sharded`` — the state twin of ``work_sharded``.
        out: dict[str, Any] = {}
        axis = self.time_axis or (self.mesh.axis_names[0]
                                  if self.mesh is not None else None)
        # Gate on the TIME axis size — the same quantity build_step uses to
        # select work_sharded — so a multi-axis mesh whose time axis is 1
        # never pairs a mesh-shaped state with the unsharded work().
        n_time = self.mesh.shape[axis] if self.mesh is not None else 1
        for b in self.order:
            if n_time > 1 and hasattr(b, "init_state_sharded"):
                out[b.name] = b.init_state_sharded(
                    self.n_in[b.name], self.n_out[b.name], self.mesh, axis)
            else:
                out[b.name] = b.init_state(self.n_in[b.name], self.n_out[b.name])
        return out

    def init_params(self) -> dict[str, Any]:
        return {b.name: b.param_leaves() for b in self.order}


def _port_ratio(b: Block, port: str) -> Fraction:
    """Items consumed on `port` per item on the block's base (ratio-1) input
    port. Declared via ``in_port_ratios`` (reference: the forecast machinery
    permitted arbitrary per-port ratios, SURVEY.md §3.1 work_io row)."""
    ratios = getattr(b, "in_port_ratios", None)
    return Fraction(ratios.get(port, 1)) if ratios else Fraction(1)


def _in_base_rate(g: Graph, b: Block, rates: dict[str, Fraction]) -> Fraction:
    """The block's base input rate: each input edge must carry
    base * ratio(port) items/ref-item."""
    bases = {}
    for e in g.in_edges(b):
        bases[e.dst_port] = rates[e.src.name] / _port_ratio(b, e.dst_port)
    uniq = set(bases.values())
    if len(uniq) != 1:
        raise ValueError(
            f"{b.name}: input rate mismatch {sorted(bases.items())} — each "
            "input must run at base_rate * in_port_ratios[port] (default "
            "ratio 1, i.e. all inputs at one rate)"
        )
    return uniq.pop()


def _propagate_rates(g: Graph, order: list[Block]) -> dict[str, Fraction]:
    rates: dict[str, Fraction] = {}
    for b in order:
        ins = g.in_edges(b)
        if not ins:
            rates[b.name] = Fraction(b.relative_rate)
            continue
        rates[b.name] = _in_base_rate(g, b, rates) * Fraction(b.relative_rate)
    return rates


def _choose_batch(rates: dict[str, Fraction], requested: int | None,
                  shard_n: int = 1, extra_lcm: int = 1) -> int:
    from newsched_tpu.utils import prefs

    lcm = int(extra_lcm)
    for r in rates.values():
        lcm = lcm * r.denominator // math.gcd(lcm, r.denominator)
        # also keep numerators' contribution: n_out must be integer for
        # every block, which the denominator LCM guarantees.
    # Under a mesh, every edge's per-batch item count should divide evenly
    # across the time axis: N % (den_i * shard_n) == 0 makes n_out_i a
    # multiple of shard_n for every block.
    lcm *= shard_n
    target = requested or int(prefs.get("default_batch_size", DEFAULT_BATCH))
    n = max(1, -(-target // lcm)) * lcm
    return n


def _propagate_bounds(
    g: Graph, order: list[Block], rates: dict[str, Fraction]
) -> dict[str, int | None]:
    """Total output items each block will ever produce (None = unbounded).

    A block's own limit comes from block.finite_items(in_bound): head
    returns min(in_bound, max_items); finite sources return len(data);
    default scales the tightest input bound by the rate ratio.
    """
    bounds: dict[str, int | None] = {}
    for b in order:
        in_bound = _in_base_bound(g, b, bounds)
        limit = getattr(b, "finite_items", None)
        if limit is not None:
            own = limit(in_bound)
        elif in_bound is None:
            own = None
        else:
            rr = Fraction(b.relative_rate)
            own = int(in_bound * rr)
        bounds[b.name] = own
    return bounds


def compile_flowgraph(
    g: Graph, batch_size: int | None = None, total_items: int | None = None,
    mesh=None, time_axis: str | None = None,
    tag_capacity_limit: int | None = None,
) -> CompiledFlowgraph:
    """batch_size: requested items/batch at the reference rate (rate-1 source).
    total_items: override stream length at the reference rate (else derived
    from head blocks / finite sources; None with no bound = unbounded).

    mesh: a jax.sharding.Mesh. The SAME flowgraph compiles to a sharded
    program: the compiler pins every stream edge to a time-sharded layout
    (leading axis over `time_axis`, default the mesh's first axis) and XLA's
    SPMD partitioner inserts the halo exchanges every tail-stateful kernel
    needs — the reference's graph_utils::partition + multi-scheduler
    (SURVEY.md §3.6 rows 3-4) expressed as sharding annotations instead of
    buffer plumbing. Hand-tuned shard_map pipelines live in parallel/."""
    order = g.topo_order()
    rates = _propagate_rates(g, order)
    shard_n = 1
    if mesh is not None:
        time_axis = time_axis or mesh.axis_names[0]
        shard_n = mesh.shape[time_axis]
    # Grouping constraints the rate fraction alone cannot carry
    # (reference: output_multiple/forecast, SURVEY.md §4.3): a block may
    # declare ``in_multiple`` — its per-batch input count must divide by
    # it (e.g. keep_m_in_n groups of n even though m/n reduces;
    # interleave blocksize). Fold each into the batch LCM at the block's
    # input rate: need (r.num * N) / r.den divisible by m.
    extra = 1
    for b in order:
        m = int(getattr(b, "in_multiple", 1))
        if m > 1 and g.in_edges(b):
            r = _in_base_rate(g, b, rates)
            need = (m * r.denominator) // math.gcd(r.numerator,
                                                   m * r.denominator)
            extra = extra * need // math.gcd(extra, need)
    N = _choose_batch(rates, batch_size, shard_n, extra)
    n_in: dict[str, int] = {}
    n_out: dict[str, int] = {}
    for b in order:
        ins = g.in_edges(b)
        # n_in is in BASE-port items (ports with a declared ratio consume
        # ratio * n_in items per batch; their edge counts carry that).
        n_in[b.name] = int(_in_base_rate(g, b, rates) * N) if ins else 0
        r = rates[b.name] * N
        if r.denominator != 1:
            raise AssertionError(f"non-integer batch for {b.name}: {r}")
        n_out[b.name] = int(r)

    bounds = _propagate_bounds(g, order, rates)
    if total_items is not None:
        for b in order:
            if not g.in_edges(b):
                cap = int(total_items * rates[b.name])
                bounds[b.name] = cap if bounds[b.name] is None else min(bounds[b.name], cap)
        # re-propagate downstream of the capped sources
        bounds = _merge_bounds(g, order, rates, bounds)

    # Leading-garbage propagation (blocks with lookahead latency, e.g.
    # skiphead, declare lead_items; default scales by the rate ratio).
    leads: dict[str, int] = {}
    for b in order:
        ins = g.in_edges(b)
        in_lead = max((int(Fraction(leads[e.src.name]) / _port_ratio(b, e.dst_port))
                       for e in ins), default=0)
        fn = getattr(b, "lead_items", None)
        if fn is not None:
            leads[b.name] = fn(in_lead, n_in[b.name], n_out[b.name])
        else:
            lr = in_lead * Fraction(b.relative_rate)
            if lr.denominator != 1:
                raise ValueError(f"{b.name}: lead items {lr} not integral at this rate")
            leads[b.name] = int(lr)

    sinks = [b for b in order if not b.outputs]
    sink_totals: dict[str, int | None] = {}
    sink_leads: dict[str, int] = {}
    n_batches: int | None = None
    for s in sinks:
        ins = g.in_edges(s)
        t = None
        for e in ins:
            sb = bounds[e.src.name]
            if sb is not None:
                t = sb if t is None else min(t, sb)
        sink_totals[s.name] = t
        sink_leads[s.name] = max((leads[e.src.name] for e in ins), default=0)
        if t is not None and n_in[s.name] > 0:
            nb = -(-(t + sink_leads[s.name]) // n_in[s.name])
            n_batches = nb if n_batches is None else max(n_batches, nb)

    step = build_step(g, order, n_out, n_in, mesh=mesh, time_axis=time_axis,
                      tag_capacity_limit=tag_capacity_limit)
    return CompiledFlowgraph(
        graph=g,
        order=order,
        rates=rates,
        batch_ref=N,
        n_in=n_in,
        n_out=n_out,
        bounds=bounds,
        leads=leads,
        n_batches=n_batches,
        sink_totals=sink_totals,
        sink_leads=sink_leads,
        step=step,
        mesh=mesh,
        time_axis=time_axis,
    )


def _in_base_bound(g: Graph, b: Block, bounds: dict) -> int | None:
    """Tightest input bound expressed in base-port items (per-port ratios
    normalize each edge's total)."""
    in_bound = None
    for e in g.in_edges(b):
        x = bounds[e.src.name]
        if x is None:
            continue
        x = int(Fraction(x) / _port_ratio(b, e.dst_port))
        in_bound = x if in_bound is None else min(in_bound, x)
    return in_bound


def _merge_bounds(g, order, rates, seeded):
    bounds = dict(seeded)
    for b in order:
        ins = g.in_edges(b)
        if not ins:
            continue
        in_bound = _in_base_bound(g, b, bounds)
        limit = getattr(b, "finite_items", None)
        if limit is not None:
            own = limit(in_bound)
        elif in_bound is None:
            own = bounds[b.name]
        else:
            own = int(in_bound * Fraction(b.relative_rate))
            if bounds[b.name] is not None:
                own = min(own, bounds[b.name])
        bounds[b.name] = own
    return bounds


def build_step(g: Graph, order: list[Block], n_out: dict[str, int],
               n_in: dict[str, int] | None = None, mesh=None,
               time_axis: str | None = None,
               tag_capacity_limit: int | None = None):
    """Emit the pure per-batch function. Sinks (no stream outputs) return a
    per-batch collected pytree under their name (None to collect nothing).

    ``host_ins`` maps the name of each host-ingest block (one defining
    host_pull, e.g. file_source) to its staged batch; it appears to that
    block's work as the pseudo input port "host_in".

    Tag plane (reference: executor tag propagation per
    tag_propagation_policy_t, SURVEY.md §3.1): a shadow value per edge
    carries a TagBatch. Capacity propagates statically from each block's
    ``tag_capacity`` (sources) through merges; a graph with zero capacity
    pays zero overhead. Blocks with ``tag_aware=True`` get ``in_tags=``
    and return (state, outs, out_tags); others get the policy default
    (all_to_all merge + exact rational offset remap). Sinks with
    ``collects_tags=True`` receive {"data", "tags"} as their collection.
    """
    from newsched_tpu.runtime import tags as tags_mod

    n_in = n_in or {}

    # Mesh lowering: pin each stream edge's value to a time-sharded layout.
    # That single annotation is the whole multi-device story — XLA's SPMD
    # partitioner turns the global tail-concat + conv/matmul kernels into
    # per-shard compute with halo exchange (the scaling-book recipe:
    # annotate shardings, let the compiler insert collectives).
    constrain = None
    n_shard = 0
    axis = None
    if mesh is not None and math.prod(mesh.shape.values()) > 1:
        import jax
        from jax.sharding import NamedSharding, PartitionSpec

        axis = time_axis or mesh.axis_names[0]
        n_shard = mesh.shape[axis]

        def constrain(v, count):
            if count % n_shard != 0:
                return v  # indivisible edge stays unconstrained (replicated)

            def one(a):
                if getattr(a, "ndim", 0) >= 1 and a.shape[0] == count:
                    spec = PartitionSpec(axis, *([None] * (a.ndim - 1)))
                    return jax.lax.with_sharding_constraint(
                        a, NamedSharding(mesh, spec))
                return a

            return jax.tree_util.tree_map(one, v)

    # Static tag-capacity propagation, per OUTPUT PORT (the reference
    # propagates per-edge; per-port is what ONE_TO_ONE needs).
    caps: dict[tuple[str, str], int] = {}
    for b in order:
        in_caps = []
        for p in b.inputs:
            e = next((e for e in g.in_edges(b) if e.dst_port == p.name), None)
            in_caps.append(caps.get((e.src.name, e.src_port), 0) if e else 0)
        own = int(getattr(b, "tag_capacity", 0))
        policy = b.tag_policy
        if policy == "one_to_one" and b.inputs and b.outputs \
                and len(b.inputs) != len(b.outputs):
            raise ValueError(
                f"{b.name}: tag_policy 'one_to_one' requires equal input/"
                f"output port counts ({len(b.inputs)} vs {len(b.outputs)}), "
                "as in the reference's TPP_ONE_TO_ONE")
        for i, p in enumerate(b.outputs):
            if getattr(b, "tag_aware", False):
                c = sum(in_caps) + own
            elif policy == "one_to_one":
                c = (in_caps[i] if i < len(in_caps) else 0) + own
            elif policy == "dont":
                c = own
            else:  # all_to_all
                c = sum(in_caps) + own
            if tag_capacity_limit is not None:
                # Bound capacity snowballing in deep multi-input graphs:
                # batches over the limit are runtime-compacted (valid-first,
                # truncate); drops are counted into sink "__tag_drops__".
                c = min(c, tag_capacity_limit)
            caps[(b.name, p.name)] = c
    any_tags = any(caps.values())

    def step(states: dict, params: dict, host_ins: dict | None = None):
        if constrain is not None:
            from newsched_tpu.runtime.meshctx import mesh_scope

            with mesh_scope(mesh, time_axis or mesh.axis_names[0]):
                return _step_body(states, params, host_ins)
        return _step_body(states, params, host_ins)

    def _step_body(states: dict, params: dict, host_ins: dict | None = None):
        host_ins = host_ins or {}
        vals: dict[tuple[str, str], Any] = {}
        tag_vals: dict[tuple[str, str], Any] = {}  # (block, out port) -> TagBatch
        new_states = dict(states)
        sink_out: dict[str, Any] = {}
        tag_drops = None  # int32 scalar when tag_capacity_limit is active
        for b in order:
            ins = {e.dst_port: vals[(e.src.name, e.src_port)] for e in g.in_edges(b)}
            if b.name in host_ins:
                ins["host_in"] = host_ins[b.name]
            # Tags on each input port, in declared port order (ONE_TO_ONE
            # pairs input i with output i, as the reference executor does).
            in_tags_by_port: list[Any] = []
            if any_tags:
                for p in b.inputs:
                    e = next((e for e in g.in_edges(b) if e.dst_port == p.name), None)
                    in_tags_by_port.append(
                        tag_vals.get((e.src.name, e.src_port)) if e else None)
            merged_in = None
            for t in in_tags_by_port:
                if t is not None:
                    merged_in = t if merged_in is None else tags_mod.merge(merged_in, t)

            ni, no = n_in.get(b.name, 0), n_out[b.name]

            def _remap(t):
                return (tags_mod.remap(t, no, ni)
                        if t is not None and ni and no and ni != no else t)

            if getattr(b, "tag_aware", False):
                st, outs, otags = b.work(states[b.name], ins, params[b.name],
                                         n_out[b.name], in_tags=merged_in)
                out_tags = {p.name: otags for p in b.outputs}
            else:
                # Explicit-collective lowering hook: under a real mesh, a
                # block exposing ``work_sharded`` runs its own shard_map
                # formulation (e.g. the fused FM chain per time shard)
                # instead of relying on the SPMD partitioner — the graph
                # analog of the reference's per-edge custom buffers.
                if n_shard > 1 and hasattr(b, "work_sharded"):
                    st, outs = b.work_sharded(states[b.name], ins,
                                              params[b.name], n_out[b.name],
                                              mesh=mesh, axis=axis)
                else:
                    st, outs = b.work(states[b.name], ins, params[b.name],
                                      n_out[b.name])
                if b.tag_policy == "one_to_one":
                    out_tags = {
                        p.name: _remap(in_tags_by_port[i]
                                       if i < len(in_tags_by_port) else None)
                        for i, p in enumerate(b.outputs)
                    }
                elif b.tag_policy == "dont":
                    out_tags = {p.name: None for p in b.outputs}
                else:  # all_to_all
                    out_tags = {p.name: _remap(merged_in) for p in b.outputs}
            new_states[b.name] = st
            if b.outputs:
                for p in b.outputs:
                    if p.name not in outs:
                        raise KeyError(f"{b.name}.work missing output {p.name!r}")
                    v = outs[p.name]
                    if constrain is not None:
                        v = constrain(v, n_out[b.name])
                    vals[(b.name, p.name)] = v
                    t = out_tags[p.name]
                    if (tag_capacity_limit is not None and t is not None
                            and t.capacity > tag_capacity_limit):
                        t, dropped = tags_mod.compact(t, tag_capacity_limit)
                        tag_drops = (dropped if tag_drops is None
                                     else tag_drops + dropped)
                    tag_vals[(b.name, p.name)] = t
            else:
                if getattr(b, "collects_tags", False) and merged_in is not None:
                    sink_out[b.name] = {"data": outs, "tags": merged_in}
                elif outs is not None:
                    sink_out[b.name] = outs
        if tag_drops is not None:
            sink_out["__tag_drops__"] = tag_drops
        return new_states, sink_out

    return step
