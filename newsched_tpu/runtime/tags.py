"""Stream tags — metadata pinned to absolute item offsets.

The reference (runtime/include/gnuradio/tag.h + buffer-side add_tag /
get_tags_in_range + executor propagation per tag_propagation_policy_t)
attaches {offset, pmtf map} tags to ring-buffer positions and remaps them
as the executor crosses rate changes.

Compile-time design: tags travel as a fixed-capacity, mask-validated
TagBatch pytree alongside each batch — SPMD-friendly static shapes, no
dynamic lists on device:

  offsets: int32[K]  item offset RELATIVE to the batch start (absolute
                     offsets are reconstructed on the host as
                     batch_index * items_per_batch + offset, keeping
                     device arithmetic in int32 — streams of any length
                     never overflow because the per-batch offset is small)
  keys:    int32[K]  interned key ids (host-side registry)
  values:  f32[K,VP] small numeric payload (richer payloads live host-side
                     keyed by (key, emission index) — the pmtf analog at
                     the boundary is plain Python)
  valid:   bool[K]

Rate remapping is exact rational arithmetic on offsets:
offset' = offset * num // den (the reference's decimator/interpolator tag
placement convention).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

VALUE_DIM = 2


class TagBatch(NamedTuple):
    offsets: jax.Array  # int32[K]
    keys: jax.Array  # int32[K]
    values: jax.Array  # f32[K, VALUE_DIM]
    valid: jax.Array  # bool[K]
    # Rich-payload handle: 0 = none, else 1-based index into the host-side
    # PAYLOADS registry (the pmtf-map analog: arbitrary Python payloads
    # never touch the device, only their int32 handle does). Optional
    # (None) so numeric-only tag planes pay nothing.
    pids: Any = None  # int32[K] | None

    @property
    def capacity(self) -> int:
        return self.offsets.shape[0]


def empty(capacity: int, with_pids: bool = False) -> TagBatch:
    return TagBatch(
        offsets=jnp.zeros((capacity,), jnp.int32),
        keys=jnp.zeros((capacity,), jnp.int32),
        values=jnp.zeros((capacity, VALUE_DIM), jnp.float32),
        valid=jnp.zeros((capacity,), jnp.bool_),
        pids=jnp.zeros((capacity,), jnp.int32) if with_pids else None,
    )


def remap(tags: TagBatch, num: int, den: int) -> TagBatch:
    """Rational offset remap across a rate change (out = in * num / den)."""
    if num == den:
        return tags
    off = (tags.offsets * num) // den  # int32 safe: offsets are batch-relative
    return tags._replace(offsets=off.astype(jnp.int32))


def shift(tags: TagBatch, delta) -> TagBatch:
    return tags._replace(offsets=(tags.offsets + jnp.int32(delta)).astype(jnp.int32))


def _pids_of(t: TagBatch):
    return t.pids if t.pids is not None else jnp.zeros((t.capacity,), jnp.int32)


def merge(a: TagBatch, b: TagBatch) -> TagBatch:
    """Concatenate two tag batches (capacity grows; compile-time static)."""
    any_pids = a.pids is not None or b.pids is not None
    return TagBatch(
        offsets=jnp.concatenate([a.offsets, b.offsets]),
        keys=jnp.concatenate([a.keys, b.keys]),
        values=jnp.concatenate([a.values, b.values]),
        valid=jnp.concatenate([a.valid, b.valid]),
        pids=jnp.concatenate([_pids_of(a), _pids_of(b)]) if any_pids else None,
    )


def compact(t: TagBatch, capacity: int):
    """Pack valid tags first (stable) and truncate to ``capacity``.

    Bounds the capacity snowballing of deep multi-input graphs (every
    all_to_all merge concatenates, so static capacities sum along paths —
    reference executors have the same duplication semantics but dynamic
    storage). Returns (compacted TagBatch, n_dropped int32 scalar); drops
    only occur when more than ``capacity`` tags are simultaneously valid.
    """
    if t.capacity <= capacity:
        return t, jnp.int32(0)
    # Sort by (invalid, offset): valid entries first IN STREAM ORDER, so
    # when over capacity the earliest-offset valid tags survive
    # deterministically regardless of which input port they merged in from
    # (a validity-only sort kept port-major order, making survival
    # arbitrary w.r.t. the stream).
    key = jnp.where(t.valid, t.offsets, jnp.iinfo(jnp.int32).max)
    idx = jnp.argsort(key, stable=True)
    take = idx[:capacity]
    n_valid = jnp.sum(t.valid.astype(jnp.int32))
    dropped = jnp.maximum(n_valid - jnp.int32(capacity), 0)
    return TagBatch(
        offsets=t.offsets[take],
        keys=t.keys[take],
        values=t.values[take],
        valid=t.valid[take],
        pids=None if t.pids is None else t.pids[take],
    ), dropped


class KeyRegistry:
    """Host-side interning of tag keys (the pmtf-symbol analog)."""

    def __init__(self):
        self._to_id: dict[str, int] = {}
        self._to_key: list[str] = []

    def intern(self, key: str) -> int:
        if key not in self._to_id:
            self._to_id[key] = len(self._to_key)
            self._to_key.append(key)
        return self._to_id[key]

    def name(self, kid: int) -> str:
        return self._to_key[kid]


REGISTRY = KeyRegistry()


class PayloadRegistry:
    """Host-side store of rich tag payloads (the pmtf-map analog): arbitrary
    Python objects keyed by the 1-based int handle the device carries in
    TagBatch.pids. Per-process; the zmq wire re-interns on receive."""

    def __init__(self):
        self._items: list = []

    def add(self, obj) -> int:
        self._items.append(obj)
        return len(self._items)  # 1-based; 0 = no payload

    def get(self, pid: int):
        return self._items[pid - 1] if 0 < pid <= len(self._items) else None


PAYLOADS = PayloadRegistry()


class Tag(NamedTuple):
    """Host-side tag: absolute offset + key + numeric vector (+ optional
    rich payload, the pmtf-map analog)."""

    offset: int
    key: str
    value: tuple
    payload: Any = None


def decode_batches(stacked: TagBatch, items_per_batch: int,
                   registry: KeyRegistry = REGISTRY,
                   payloads: PayloadRegistry = PAYLOADS) -> list[Tag]:
    """Host: stacked per-batch TagBatch (leading n_batches axis) -> absolute
    tags list."""
    offs = np.asarray(stacked.offsets)
    keys = np.asarray(stacked.keys)
    vals = np.asarray(stacked.values)
    valid = np.asarray(stacked.valid)
    pids = None if stacked.pids is None else np.asarray(stacked.pids)
    out: list[Tag] = []
    n_batches = offs.shape[0]
    for b in range(n_batches):
        for i in np.nonzero(valid[b])[0]:
            payload = payloads.get(int(pids[b, i])) if pids is not None else None
            out.append(Tag(int(offs[b, i]) + b * items_per_batch,
                           registry.name(int(keys[b, i])),
                           tuple(float(v) for v in vals[b, i]),
                           payload))
    out.sort(key=lambda t: t.offset)
    return out
