"""Tiered KV cache: a host-RAM page tier (with optional disk spill) under
the PagePool, and the page-shipping substrate between tiers.

Counterpart of kafka_tpu/runtime/kv_tier.py (the host and disk tiers, the
local shipper and the cross-replica shipper).  Almost every thread is idle
at any moment, and an idle thread's conversation KV must not occupy device memory — yet a thread
resuming later should not re-prefill its whole history either.  Pages are
the unit of demotion:

* **Demotion** — when the radix prefix cache's leaf-LRU eviction or
  page-pressure ``reclaim()`` would free a node's pages, the engine instead
  copies them device->host and keeps the radix node as a *host-resident*
  run.  The gather (``index_select`` on the pool's slot axis into a fresh
  tensor) is enqueued on the compute stream *before* the pages go back to
  the pool, so in-order execution reads them before any later step
  overwrites them.  Its device->host copy runs on a side stream into
  pinned memory, and its completion is a ``torch.cuda.Event``: resolving
  the host bytes waits on that event, never on the whole device, which
  may be up to ``fetch_lag`` decode steps behind the host.
* **Promotion** — a ``lookup()`` hit against a host-resident run allocates
  fresh pool pages and enqueues the host->device copy and the scatter on
  the compute stream *before* the suffix prefill.  The scatter is an
  in-place ``index_copy_`` into the pool tensors: the pools are bound once
  and every captured decode graph reads their storage, so they are never
  rebound (``cache_source="host_tier"``).
* **Second-chance LRU + disk** — the host pool lives under a byte budget
  (``KAFKA_TORCH_KV_HOST_TIER_MB``, charged by the memory planner as host
  RAM).  Overflow gives each run one second chance (the radix walk
  touching a host node sets its reference bit), then spills it to
  ``KAFKA_TORCH_KV_DISK_TIER_DIR`` (background writer thread) or drops it
  when no disk tier is configured.
* **Failure semantics** — a failed or torn promote frees the destination
  pages and removes the radix node: the request degrades to re-prefill,
  never to corrupt KV.  A failed demote falls back to plain eviction.
  Both copies are chaos-testable via the ``kv.demote`` / ``kv.promote``
  failpoints (fired once per shipped chunk, so an ``nth=2`` error rule
  produces a genuinely torn multi-chunk copy).

* **Cross-replica shipping** (disaggregated prefill/decode, the DP
  router): ``CrossReplicaPageShipper`` moves a page run from one replica's
  pool into another's, chunk by chunk, device to device: a gather, a
  ``.to`` of the destination device (a no-op when both replicas share the
  card), and an in-place ``index_copy_``.  The JAX package also has a
  host-staged transport, which it needs because its pools are not
  addressable across replicas in process; the port's always are, so it
  keeps only the device copy.  Every copy is enqueued on the current
  stream: the gather runs before any later source step can overwrite the
  pages, the scatter before any later destination step reads them, and
  the host never waits on the device.

Payloads are host tensors, one per pool leaf (a dense pool is one leaf; an
int8 pool is its int8 rows, then its ``[L, SLOTS, 1]`` f32 scales — the
order ``jax.tree.leaves`` gives the JAX package's ``QTensor``).  The disk
and object tiers store them in the JAX package's npz format, bf16 as a
``uint16`` view named ``"bfloat16"``, so both packages read each other's
runs.
"""

from __future__ import annotations

import io
import json
import logging
import os
import queue
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..failpoints import failpoint
from ..models.quant import QTensor
from ..tracing import record_span

logger = logging.getLogger("kafka_tpu_torch.kv_tier")

# Pages per gather/scatter chunk.  Runs ship in fixed buckets padded with
# trash-page slots (the reference's chunking, kept so the per-chunk
# failpoints and the staging sizes match it); runs longer than the largest
# bucket ship as a chunk sequence.  Padding round-trips harmlessly: padded
# gathers read trash rows that resolution trims, padded scatters write
# zero rows INTO the trash page, which is garbage by contract
# (kv_cache.TRASH_PAGE).  Each bucket's pinned staging block is allocated
# once by the engine's warmup_kv_tier and reused from the caching host
# allocator afterwards.
SHIP_BUCKETS = (1, 2, 4, 8, 16, 32, 64)

_TRASH_PAGE = 0  # mirrors kv_cache.TRASH_PAGE

# torch dtype -> the numpy dtype name the JAX package writes (npz meta,
# object-store fingerprint)
_DTYPE_NAMES = {
    torch.float32: "float32",
    torch.bfloat16: "bfloat16",
    torch.float16: "float16",
    torch.int8: "int8",
}
_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}
# same-width unsigned views for dtypes numpy cannot hold natively
_UINT_VIEW = {torch.bfloat16: (torch.uint16, np.uint16)}


class ShipError(RuntimeError):
    """A page-run transfer failed (torn copy, missing payload).  The tier
    manager converts this into degrade-to-re-prefill, never corruption."""


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype ("bfloat16", "float32", "int8")."""
    return _DTYPE_NAMES[dtype]


def pool_leaves(pool: Any) -> List[torch.Tensor]:
    """A pool's tensors in the JAX package's leaf order: [rows] for a
    dense pool, [int8 rows, f32 scales] for a QTensor pool."""
    if isinstance(pool, QTensor):
        return [pool.q, pool.s]
    return [pool]


def _bucketize(n_pages: int) -> List[int]:
    """Split a run of n pages into SHIP_BUCKET-sized chunk lengths."""
    out: List[int] = []
    biggest = SHIP_BUCKETS[-1]
    while n_pages > biggest:
        out.append(biggest)
        n_pages -= biggest
    if n_pages > 0:
        out.append(next(b for b in SHIP_BUCKETS if b >= n_pages))
    return out  # each entry is the PADDED chunk length


def _flat_slots(pages: Sequence[int], page_size: int, pad_to: int) -> np.ndarray:
    """Flat pool-slot indices for `pages`, padded to `pad_to` pages with
    trash-page slots."""
    padded = list(pages) + [_TRASH_PAGE] * (pad_to - len(pages))
    idx = np.empty(pad_to * page_size, np.int32)
    for i, p in enumerate(padded):
        idx[i * page_size:(i + 1) * page_size] = np.arange(
            p * page_size, (p + 1) * page_size, dtype=np.int32
        )
    return idx


# ---------------------------------------------------------------------------
# the wire format (the JAX package's npz, byte for byte)
# ---------------------------------------------------------------------------


def _storable(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """An npz-serializable numpy view of a host tensor + its dtype name
    (bf16 as a same-width uint, as the JAX package stores ml_dtypes)."""
    t = t.detach().cpu().contiguous()
    name = dtype_name(t.dtype)
    view = _UINT_VIEW.get(t.dtype)
    if view is not None:
        return t.view(view[0]).numpy(), name
    return t.numpy(), name


def _from_stored(arr: np.ndarray, name: str) -> torch.Tensor:
    dtype = _DTYPES[name]
    view = _UINT_VIEW.get(dtype)
    if view is not None:
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(view[1])).view(dtype)
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.dtype(name)))


def encode_run_npz(k_leaves: Sequence[torch.Tensor],
                   v_leaves: Sequence[torch.Tensor], n_pages: int) -> bytes:
    """ONE wire format for persisted page runs — the disk tier's spill
    files and the object tier's payloads (meta json + k{i}/v{i} arrays,
    bf16 stored as uint16), the JAX package's exactly."""
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {"n_pages": n_pages, "k": [], "v": []}
    for side, leaves in (("k", k_leaves), ("v", v_leaves)):
        for i, a in enumerate(leaves):
            stored, name = _storable(a)
            arrays[f"{side}{i}"] = stored
            meta[side].append(name)
    buf = io.BytesIO()
    np.savez(buf, meta=json.dumps(meta), **arrays)
    return buf.getvalue()


def decode_run_npz(
    data: bytes,
) -> Tuple[List[torch.Tensor], List[torch.Tensor], int]:
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        k_leaves = [_from_stored(z[f"k{i}"], name)
                    for i, name in enumerate(meta["k"])]
        v_leaves = [_from_stored(z[f"v{i}"], name)
                    for i, name in enumerate(meta["v"])]
    return k_leaves, v_leaves, int(meta["n_pages"])


# ---------------------------------------------------------------------------
# shipping
# ---------------------------------------------------------------------------


class PageShipper:
    """Transport seam for page runs: export to a portable payload, import
    a payload into destination pages (host tensors, one per pool leaf)."""

    def export_run(self, pages: Sequence[int]) -> "_PendingExport":
        raise NotImplementedError

    def resolve(self, pending: "_PendingExport"
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        raise NotImplementedError

    def import_run(self, k_leaves: List[torch.Tensor],
                   v_leaves: List[torch.Tensor], n_pages: int,
                   dest_pages: Sequence[int]) -> None:
        raise NotImplementedError

    def bytes_per_page(self) -> int:
        raise NotImplementedError


class _PendingExport:
    """An in-flight D2H export: per-chunk host tensors (pinned on CUDA)
    whose copies were enqueued asynchronously, and the event each chunk's
    copy records.  `ready()` is advisory; `resolve` waits on the events."""

    __slots__ = ("n_pages", "chunk_pages", "chunks", "events")

    def __init__(self, n_pages: int, chunk_pages: List[int],
                 chunks: List[Tuple[List[torch.Tensor], List[torch.Tensor]]],
                 events: List[Any]):
        self.n_pages = n_pages
        self.chunk_pages = chunk_pages  # REAL pages per chunk (unpadded)
        self.chunks = chunks  # [(k_leaf_tensors, v_leaf_tensors), ...]
        self.events = events  # CUDA events (empty on the CPU)

    def ready(self) -> bool:
        return all(e.query() for e in self.events)

    def wait(self) -> None:
        for e in self.events:
            e.synchronize()

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for k, v in self.chunks for a in (*k, *v))


class LocalPageShipper(PageShipper):
    """Ship page runs between one engine's device pool and host memory.

    `owner` exposes ``k_pool`` / ``v_pool`` (the engine; tests use a stub).
    Imports write the pools IN PLACE and never rebind them, and run on the
    thread that owns dispatch (the engine thread)."""

    def __init__(self, owner: Any, page_size: int):
        self.owner = owner
        self.page_size = page_size
        self._copy_stream = None  # CUDA side stream for D2H copies

    def _leaves(self) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        return pool_leaves(self.owner.k_pool), pool_leaves(self.owner.v_pool)

    def _slot_index(self, idx: np.ndarray, device: torch.device
                    ) -> torch.Tensor:
        t = torch.from_numpy(idx.astype(np.int64))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t

    # -- export (demotion: D2H) -----------------------------------------

    def export_run(self, pages: Sequence[int]) -> _PendingExport:
        ps = self.page_size
        k_pool, v_pool = self._leaves()
        device = k_pool[0].device
        cuda = device.type == "cuda"
        if cuda and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device)
        chunks: List[Tuple[List[torch.Tensor], List[torch.Tensor]]] = []
        chunk_pages: List[int] = []
        events: List[Any] = []
        off = 0
        for padded in _bucketize(len(pages)):
            failpoint("kv.demote")
            real = min(padded, len(pages) - off)
            idx = self._slot_index(
                _flat_slots(pages[off:off + real], ps, padded), device)
            # the gather runs on the compute stream, ahead of any later
            # step that overwrites these pages
            k_rows = [a.index_select(1, idx) for a in k_pool]
            v_rows = [a.index_select(1, idx) for a in v_pool]
            if cuda:
                side = self._copy_stream
                side.wait_stream(torch.cuda.current_stream(device))
                k_host, v_host = [], []
                with torch.cuda.stream(side):
                    for rows, out in ((k_rows, k_host), (v_rows, v_host)):
                        for r in rows:
                            h = torch.empty(r.shape, dtype=r.dtype,
                                            pin_memory=True)
                            h.copy_(r, non_blocking=True)
                            # the gathered tensor was allocated on the
                            # compute stream: keep it alive for the copy
                            r.record_stream(side)
                            out.append(h)
                    ev = torch.cuda.Event()
                    ev.record(side)
                events.append(ev)
                chunks.append((k_host, v_host))
            else:
                chunks.append((k_rows, v_rows))
            chunk_pages.append(real)
            off += real
        return _PendingExport(len(pages), chunk_pages, chunks, events)

    def resolve(self, pending: _PendingExport
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Materialize an export on the host: wait for its copies, trim
        chunk padding, concatenate chunks — one tensor per pool leaf,
        [L, n_pages*ps, ...]."""
        pending.wait()
        ps = self.page_size
        parts = [
            ([a[:, : real * ps] for a in k], [a[:, : real * ps] for a in v])
            for (k, v), real in zip(pending.chunks, pending.chunk_pages)
        ]
        n_leaves = len(parts[0][0])

        def join(side: int, i: int) -> torch.Tensor:
            if len(parts) == 1:
                return parts[0][side][i].contiguous()
            return torch.cat([p[side][i] for p in parts], dim=1)

        return ([join(0, i) for i in range(n_leaves)],
                [join(1, i) for i in range(n_leaves)])

    # -- import (promotion: H2D) ----------------------------------------

    def import_run(self, k_leaves: List[torch.Tensor],
                   v_leaves: List[torch.Tensor], n_pages: int,
                   dest_pages: Sequence[int]) -> None:
        if len(dest_pages) != n_pages:
            raise ShipError(
                f"import of {n_pages}-page run into {len(dest_pages)} pages")
        ps = self.page_size
        k_pool, v_pool = self._leaves()
        if len(k_leaves) != len(k_pool) or len(v_leaves) != len(v_pool):
            raise ShipError("payload leaves do not match the pool layout")
        device = k_pool[0].device
        off = 0
        for padded in _bucketize(n_pages):
            failpoint("kv.promote")
            real = min(padded, n_pages - off)
            idx = self._slot_index(
                _flat_slots(dest_pages[off:off + real], ps, padded), device)
            lo, hi = off * ps, (off + real) * ps
            pad_rows = (padded - real) * ps
            for pool, leaves in ((k_pool, k_leaves), (v_pool, v_leaves)):
                for dst, a in zip(pool, leaves):
                    rows = a[:, lo:hi]
                    if pad_rows:
                        rows = torch.cat([rows, rows.new_zeros(
                            (rows.shape[0], pad_rows) + tuple(rows.shape[2:]))],
                            dim=1)
                    rows = rows.to(device=device, dtype=dst.dtype,
                                   non_blocking=True)
                    # in place: captured step graphs read this storage
                    dst.index_copy_(1, idx, rows)
            off += real

    def bytes_per_page(self) -> int:
        ps = self.page_size
        total = 0
        k_pool, v_pool = self._leaves()
        for a in (*k_pool, *v_pool):
            per_slot = int(np.prod(a.shape[2:])) if a.dim() > 2 else 1
            total += a.shape[0] * ps * per_slot * a.element_size()
        return total


def _pool_bytes_per_page(pool_owner: Any, page_size: int) -> int:
    total = 0
    for pool in (pool_owner.k_pool, pool_owner.v_pool):
        for a in pool_leaves(pool):
            per_slot = int(np.prod(a.shape[2:])) if a.dim() > 2 else 1
            total += a.shape[0] * page_size * per_slot * a.element_size()
    return total


def _slot_index(idx: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(idx.astype(np.int64))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class CrossReplicaPageShipper:
    """Ship a page run from one replica's pool into another's
    (disaggregated prefill/decode; the JAX package's DeviceShipper,
    kafka_tpu/runtime/kv_tier.py:482).

    Per SHIP_BUCKETS chunk: ``index_select`` on the source pool's slot
    axis, ``.to(destination device, non_blocking=True)`` (a no-op when
    both replicas share the card), and an in-place ``index_copy_`` into
    the destination pool: the pools are bound in captured decode graphs,
    so they are never rebound.  Ordering: replicas on one card share the
    current stream, so the scatter runs after the gather and both run
    before any later step of either replica; across cards PyTorch's peer
    copy makes the destination's current stream wait for the source's.
    ship() runs on the thread that drives both replicas (the router's
    worker thread).

    Chunks are padded to SHIP_BUCKETS with trash-page slots on both
    sides: padded gather rows are read from the source trash page, and
    their scatter writes land in the destination trash page, which is
    garbage by contract.  ``kv.ship`` fires once per chunk: an
    ``error:nth=2`` rule on a multi-chunk run tears the copy, ship()
    raises with the destination pages PARTIAL, and the caller
    (dp_router._ship_run) frees every destination page (they were freshly
    allocated and shared with nobody) and the thread re-prefills."""

    # the DisaggMetrics transport dimension and the hand-off event attrs
    transport = "device"

    def __init__(self, src_owner: Any, dst_owner: Any, page_size: int):
        self.src = src_owner
        self.dst = dst_owner
        self.page_size = page_size

    def bytes_per_page(self) -> int:
        return _pool_bytes_per_page(self.src, self.page_size)

    def ship(self, src_pages: Sequence[int],
             dest_pages: Sequence[int]) -> int:
        """Copy `src_pages` (source pool) into `dest_pages` (destination
        pool); returns the real (unpadded) bytes moved.  Raises on a torn
        chunk (see the class docstring for the cleanup contract)."""
        if len(src_pages) != len(dest_pages):
            raise ShipError(f"ship of {len(src_pages)} pages into "
                            f"{len(dest_pages)} destination pages")
        ps = self.page_size
        src_leaves = pool_leaves(self.src.k_pool) + pool_leaves(
            self.src.v_pool)
        dst_leaves = pool_leaves(self.dst.k_pool) + pool_leaves(
            self.dst.v_pool)
        if len(src_leaves) != len(dst_leaves):
            raise ShipError("source and destination pool layouts differ")
        sdev, ddev = src_leaves[0].device, dst_leaves[0].device
        off = 0
        nbytes = 0
        for padded in _bucketize(len(src_pages)):
            failpoint("kv.ship")
            real = min(padded, len(src_pages) - off)
            sidx = _slot_index(
                _flat_slots(src_pages[off:off + real], ps, padded), sdev)
            didx = _slot_index(
                _flat_slots(dest_pages[off:off + real], ps, padded), ddev)
            for s_leaf, d_leaf in zip(src_leaves, dst_leaves):
                rows = s_leaf.index_select(1, sidx).to(ddev,
                                                       non_blocking=True)
                nbytes += int(rows.numel() * rows.element_size()
                              * real / padded)
                d_leaf.index_copy_(1, didx, rows)
            off += real
        return nbytes


# ---------------------------------------------------------------------------
# host + disk tiers
# ---------------------------------------------------------------------------


class HostRun:
    """One demoted page run resident in the host tier (or below)."""

    __slots__ = (
        "run_id", "n_pages", "nbytes", "location", "pending",
        "k_leaves", "v_leaves", "ref_bit", "discarded",
        "path_runs", "threads", "object_key",
    )

    def __init__(self, run_id: str, n_pages: int, nbytes: int,
                 pending: Optional[_PendingExport]):
        self.run_id = run_id
        self.n_pages = n_pages
        self.nbytes = nbytes
        # "pending" (D2H still materializing) -> "host" -> "spilling"
        # -> "disk"; "object" = archived into the shared object store
        # (runtime/object_tier.py) — payload-less locally, fetched back
        # on promote
        self.location = "pending"
        self.pending = pending
        self.k_leaves: Optional[List[torch.Tensor]] = None
        self.v_leaves: Optional[List[torch.Tensor]] = None
        self.ref_bit = False  # second-chance LRU
        self.discarded = False
        # Content-address context (object tier): the per-node token runs
        # of the radix path from the root THROUGH this run, and the
        # prefix keys claiming the node at demotion time.  None = the
        # caller could not supply it (such runs never archive).
        self.path_runs: Optional[List[List[int]]] = None
        self.threads: Tuple[str, ...] = ()
        self.object_key: Optional[str] = None


class KVTierManager:
    """The host-RAM (+ optional disk) KV tier and its shipping policy.

    Single-writer like the engine: demote/promote/split/discard run on the
    engine thread (they touch the pools through the shipper); only the
    background spill writer touches disk state, under ``_lock``.
    ``snapshot()`` is read from serving threads and is torn-tolerant.
    ``close()`` stops the spill writer and joins it.
    """

    def __init__(
        self,
        shipper: PageShipper,
        host_budget_bytes: int,
        disk_dir: Optional[str] = None,
        page_size: int = 16,
    ):
        self.shipper = shipper
        self.host_budget_bytes = int(host_budget_bytes)
        self.disk_dir = disk_dir
        self.page_size = page_size
        if disk_dir:
            os.makedirs(disk_dir, exist_ok=True)
        self._runs: "OrderedDict[str, HostRun]" = OrderedDict()
        self._lock = threading.Lock()
        # run ids are namespaced per manager so engines (or restarts)
        # sharing one disk dir never collide on file names
        self._uid = uuid.uuid4().hex[:8]
        self._next_id = 0
        self.host_bytes = 0
        self.disk_bytes = 0
        self.disk_runs = 0
        # the trace context of the request whose pressure (or prefix hit)
        # drives the current demote/promote — spans attach to it; None =
        # untraced (record_span is then a no-op)
        self.trace_ctx = None
        # counters (KV_TIER_METRIC_KEYS; exported via /metrics + Prometheus)
        self.demotions = 0
        self.pages_demoted = 0
        self.bytes_demoted = 0
        self.demote_failures = 0
        self.promotions = 0
        self.pages_promoted = 0
        self.bytes_promoted = 0
        self.promote_failures = 0
        self.host_evictions = 0  # runs dropped (no disk tier / lost)
        self.disk_spills = 0
        self.disk_loads = 0
        self._spill_q: "queue.Queue[Optional[HostRun]]" = queue.Queue()
        self._spill_thread: Optional[threading.Thread] = None
        # Object-store tier below host+disk (runtime/object_tier.py): when
        # attached, a run the local ladder would DROP is archived into the
        # shared store instead and stays promotable.
        self.object = None

    def attach_object(self, obj: Any) -> None:
        """Mount the object tier (engine construction).  The tier reads
        this manager's trace context so kv.object_* spans attach to the
        request whose pressure or wake drives them."""
        self.object = obj
        obj.manager = self

    # -- sizing ----------------------------------------------------------

    def bytes_for_pages(self, n_pages: int) -> int:
        return n_pages * self.shipper.bytes_per_page()

    # -- demote ----------------------------------------------------------

    def demote(self, pages: Sequence[int],
               path_runs: Optional[List[List[int]]] = None,
               threads: Sequence[str] = ()) -> Optional[str]:
        """Copy `pages` D2H and admit them as a host run.  Returns the run
        id, or None when the copy failed or the run cannot fit — the
        caller then falls back to plain eviction (pages are simply freed).
        The gather is enqueued before the caller releases the pages, so
        in-order device execution reads them pre-overwrite; only the host
        materialization is deferred (see drain()).

        `path_runs` / `threads` carry the radix-path content context the
        OBJECT tier needs (root->run token runs + claiming prefix keys)."""
        from .autoscaler import background_deferred

        if background_deferred():
            # the autoscaler ladder's rung 3: demotion is background D2H
            # work — refuse, the caller falls back to plain eviction
            return None
        est = self.bytes_for_pages(len(pages))
        if est > self.host_budget_bytes:
            return None  # a run larger than the whole tier never fits
        t0 = time.monotonic()
        try:
            pending = self.shipper.export_run(pages)
        except Exception as e:  # injected fault / transfer error
            self.demote_failures += 1
            logger.warning("kv demote of %d pages failed: %s", len(pages), e)
            return None
        nbytes = pending.nbytes
        self._evict_for(nbytes)
        with self._lock:
            self._next_id += 1
            run = HostRun(f"{self._uid}.r{self._next_id}", len(pages),
                          nbytes, pending)
            run.path_runs = path_runs
            run.threads = tuple(threads)
            self._runs[run.run_id] = run
            self.host_bytes += nbytes
        dur = time.monotonic() - t0
        self.demotions += 1
        self.pages_demoted += len(pages)
        self.bytes_demoted += nbytes
        record_span(
            self.trace_ctx, "kv.demote", dur,
            attrs={"pages": len(pages), "bytes": nbytes, "overlap": "async"},
        )
        return run.run_id

    # -- promote ---------------------------------------------------------

    def promote(self, run_id: str, dest_pages: Sequence[int]) -> bool:
        """Ship a host run back into freshly-allocated pool pages.

        The copy and the scatter are enqueued ahead of the caller's suffix
        prefill.  Returns False on any failure (missing run, torn copy):
        the destination pages are the caller's to free and the run is
        gone — degrade to re-prefill, never serve partial KV.  A torn
        scatter only ever wrote pages the caller just allocated (shared
        with nobody), so freeing them is complete cleanup."""
        t0 = time.monotonic()
        run = self._take(run_id)
        if run is None:
            self.promote_failures += 1
            return False
        src = "disk" if run.location == "disk" else "host"
        try:
            k_leaves, v_leaves = self._materialize(run)
            self.shipper.import_run(k_leaves, v_leaves, run.n_pages,
                                    dest_pages)
        except Exception as e:
            self.promote_failures += 1
            logger.warning(
                "kv promote of run %s (%d pages) failed: %s — degrading "
                "to re-prefill", run_id, run.n_pages, e)
            return False
        dur = time.monotonic() - t0
        self.promotions += 1
        self.pages_promoted += run.n_pages
        self.bytes_promoted += run.nbytes
        record_span(
            self.trace_ctx, "kv.promote", dur,
            attrs={"pages": run.n_pages, "bytes": run.nbytes, "source": src,
                   "overlap": "prefill"},
        )
        return True

    # -- structure ops (radix-tree splits / invalidation) ----------------

    def split(self, run_id: str, front_pages: int) -> Optional[Tuple[str, str]]:
        """Split a run at a page boundary into (front, back) runs — the
        host-side mirror of a radix-node split.  None when the run is gone
        (the caller removes the node instead)."""
        run = self._take(run_id)
        if run is None or not (0 < front_pages < run.n_pages):
            if run is not None:
                self._readmit(run)
            return None
        try:
            k_leaves, v_leaves = self._materialize(run)
        except Exception as e:
            logger.warning("kv split of run %s failed: %s", run_id, e)
            return None
        cut = front_pages * self.page_size
        # the content-address context splits at the same boundary
        front_path = back_path = None
        if run.path_runs:
            head, last = run.path_runs[:-1], run.path_runs[-1]
            front_path = head + [last[:cut]]
            back_path = head + [last[:cut], last[cut:]]
        ids: List[str] = []
        for lo, hi, n, path in (
            (0, cut, front_pages, front_path),
            (cut, None, run.n_pages - front_pages, back_path),
        ):
            k_part = [a[:, lo:hi].contiguous() for a in k_leaves]
            v_part = [a[:, lo:hi].contiguous() for a in v_leaves]
            nbytes = sum(a.numel() * a.element_size()
                         for a in (*k_part, *v_part))
            with self._lock:
                self._next_id += 1
                piece = HostRun(f"{self._uid}.r{self._next_id}", n,
                                nbytes, None)
                piece.location = "host"
                piece.k_leaves, piece.v_leaves = k_part, v_part
                piece.path_runs = path
                piece.threads = run.threads
                self._runs[piece.run_id] = piece
                self.host_bytes += nbytes
            ids.append(piece.run_id)
        self._evict_for(0)  # splitting resolved/copied: re-check budget
        return ids[0], ids[1]

    def touch(self, run_id: str) -> None:
        """Second-chance reference bit: the radix walk crossed this run."""
        with self._lock:
            run = self._runs.get(run_id)
            if run is not None:
                run.ref_bit = True

    def discard(self, run_id: str) -> None:
        """Drop a run (node invalidated, or its pages were re-adopted).
        An object-archived run also drops this owner's store reference."""
        run = self._take(run_id, load=False)
        if run is not None:
            run.discarded = True
            if (run.location == "object" and run.object_key is not None
                    and self.object is not None):
                self.object.release(run.object_key)

    def peek(self, run_id: str
             ) -> Optional[Tuple[List[torch.Tensor], List[torch.Tensor]]]:
        """Read-only materialization for the sleep path: the run's host
        leaves wherever it lives, WITHOUT removing it from the tier.  None
        for object-archived runs and on any load failure."""
        with self._lock:
            run = self._runs.get(run_id)
        if run is None or run.location == "object":
            return None
        try:
            if run.location == "disk":
                return self._disk_load(run)
            return self._materialize(run)
        except Exception as e:
            logger.warning("kv peek of run %s failed: %s", run_id, e)
            return None

    # -- background resolution & spill -----------------------------------

    def drain(self, force: bool = False) -> None:
        """Materialize pending D2H exports whose transfer completed.

        Called at scheduler cadence (engine.step) so pending runs release
        their staging promptly.  `force` resolves everything (tests, the
        sleep path, shutdown)."""
        if not self._runs:  # hot-path fast exit (torn-tolerant read)
            return
        with self._lock:
            todo = [r for r in self._runs.values() if r.location == "pending"]
        for run in todo:
            if force or run.pending is None or run.pending.ready():
                try:
                    self._materialize(run)
                except Exception as e:
                    logger.warning("kv demote resolution of %s failed: %s",
                                   run.run_id, e)
                    self.discard(run.run_id)
                    self.host_evictions += 1
        if todo:
            # a pressure moment with every run still in flight may have
            # overshot the budget; now that transfers resolved, re-enforce
            self._evict_for(0)

    def flush(self, timeout: float = 5.0) -> None:
        """Resolve all pending exports and wait until the spill writer has
        taken every queued run (tests, shutdown)."""
        self.drain(force=True)
        if self._spill_thread is not None:
            self._spill_q.join()

    def close(self) -> None:
        """Flush, then stop and join the spill writer."""
        self.flush()
        t = self._spill_thread
        if t is not None:
            self._spill_q.put(None)
            t.join(timeout=10.0)
            self._spill_thread = None

    def _materialize(self, run: HostRun
                     ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Resolve a run to host leaves wherever it currently lives."""
        if run.k_leaves is not None:
            return run.k_leaves, run.v_leaves
        if run.location == "object":
            if self.object is None or run.object_key is None:
                raise ShipError(f"run {run.run_id} archived but no "
                                "object tier is attached")
            got = self.object.get_run(run.object_key)
            if got is None or got[2] != run.n_pages:
                raise ShipError(f"object tier lost run {run.run_id} "
                                f"(key {run.object_key})")
            return got[0], got[1]
        if run.location == "disk":
            k_leaves, v_leaves = self._disk_load(run)
            self.disk_loads += 1
            return k_leaves, v_leaves
        if run.pending is None:
            raise ShipError(f"run {run.run_id} has no payload")
        k_leaves, v_leaves = self.shipper.resolve(run.pending)
        run.k_leaves, run.v_leaves = k_leaves, v_leaves
        run.pending = None
        if run.location == "pending":
            run.location = "host"
        return k_leaves, v_leaves

    def _take(self, run_id: str, load: bool = True) -> Optional[HostRun]:
        """Remove a run from the tier (promote/split/discard paths).  Its
        bytes are uncharged immediately.  Disk-resident runs are loaded
        into memory BEFORE their file is unlinked (`load=False` skips the
        read for discards)."""
        with self._lock:
            run = self._runs.pop(run_id, None)
            if run is None:
                return None
            if run.location == "disk":
                self.disk_bytes -= run.nbytes
                self.disk_runs -= 1
            elif run.location != "object":  # archived runs charge nothing
                self.host_bytes -= run.nbytes
        if run.location == "disk":
            if load:
                try:
                    run.k_leaves, run.v_leaves = self._disk_load(run)
                    self.disk_loads += 1
                except ShipError as e:
                    logger.warning("%s", e)
            try:
                os.unlink(self._disk_path(run.run_id))
            except OSError:
                pass
        return run

    def _readmit(self, run: HostRun) -> None:
        if run.location == "object":
            with self._lock:
                self._runs[run.run_id] = run
            return
        if run.location == "disk":
            run.location = "host"
        with self._lock:
            self._runs[run.run_id] = run
            self.host_bytes += run.nbytes

    def _evict_for(self, incoming_bytes: int) -> None:
        """Second-chance LRU over host-resident runs: referenced runs get
        one more cycle; unreferenced ones spill to disk (when configured),
        archive to the object tier, or drop.  Runs whose D2H transfer is
        still in flight are never victims (resolving one would block the
        scheduler on the copy); the budget then overshoots transiently
        and drain() re-enforces it."""
        scanned = 0
        while True:
            with self._lock:
                if self.host_bytes + incoming_bytes <= self.host_budget_bytes:
                    return
                ready = [
                    r for r in self._runs.values()
                    if r.location == "host" or (
                        r.location == "pending"
                        and (r.pending is None or r.pending.ready()))
                ]
                if not ready:
                    return  # in-flight/spilling only: tolerate overshoot
                victim = ready[0]
                if victim.ref_bit and scanned < len(ready):
                    victim.ref_bit = False
                    self._runs.move_to_end(victim.run_id)
                    scanned += 1
                    continue
            scanned = 0
            if victim.location == "pending":
                try:
                    self._materialize(victim)
                except Exception:
                    victim.location = "host"  # fall through to drop
                    victim.k_leaves = victim.v_leaves = None
            if self.disk_dir and victim.k_leaves is not None:
                with self._lock:
                    victim.location = "spilling"
                self._spill(victim)
            elif self._archive(victim):
                pass  # demoted past disk into the object store
            else:
                self._take(victim.run_id)
                self.host_evictions += 1

    def _archive(self, run: HostRun) -> bool:
        """Demotion past disk: archive a run the local ladder would drop
        into the shared object store and refresh its claimants' sleep
        manifests.  The run stays registered (payload-less, zero local
        bytes).  False = no object tier / no path context / store breaker
        open / torn put — the caller drops the run."""
        if (self.object is None or run.k_leaves is None
                or not run.path_runs or not self.object.available()):
            return False
        flat = [t for seg in run.path_runs for t in seg]
        key = self.object.put_run(flat, run.k_leaves, run.v_leaves,
                                  run.n_pages)
        if key is None:
            return False
        with self._lock:
            run.location = "object"
            run.object_key = key
            run.k_leaves = run.v_leaves = None
            run.pending = None
            self.host_bytes -= run.nbytes
        if run.threads:
            self.object.note_archive(run.threads, run.path_runs)
        return True

    # -- disk tier -------------------------------------------------------

    def _disk_path(self, run_id: str) -> str:
        return os.path.join(self.disk_dir or "", f"{run_id}.kvrun.npz")

    def _spill(self, run: HostRun) -> None:
        if self._spill_thread is None:
            self._spill_thread = threading.Thread(
                target=self._spill_loop, name="kv-tier-spill", daemon=True)
            self._spill_thread.start()
        self._spill_q.put(run)

    def _spill_loop(self) -> None:
        while True:
            run = self._spill_q.get()
            try:
                if run is None:
                    return
                try:
                    self._spill_one(run)
                except Exception as e:
                    logger.warning("kv disk spill of %s failed: %s",
                                   run.run_id, e)
                    self._take(run.run_id)
                    self.host_evictions += 1
            finally:
                self._spill_q.task_done()

    def _spill_one(self, run: HostRun) -> None:
        if run.discarded:
            return
        data = encode_run_npz(run.k_leaves, run.v_leaves, run.n_pages)
        path = self._disk_path(run.run_id)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        with self._lock:
            if run.discarded or run.run_id not in self._runs:
                try:
                    os.unlink(path)
                except OSError:
                    pass
                return
            run.location = "disk"
            run.k_leaves = run.v_leaves = None
            self.host_bytes -= run.nbytes
            self.disk_bytes += run.nbytes
            self.disk_runs += 1
            self.disk_spills += 1

    def _disk_load(self, run: HostRun
                   ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        path = self._disk_path(run.run_id)
        try:
            with open(path, "rb") as f:
                k_leaves, v_leaves, _ = decode_run_npz(f.read())
        except (OSError, KeyError, ValueError) as e:
            raise ShipError(f"disk tier lost run {run.run_id}: {e}")
        return k_leaves, v_leaves

    # -- export ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The /metrics "kv_tier" section (KV_TIER_METRIC_KEYS)."""
        with self._lock:
            host_runs = sum(1 for r in self._runs.values()
                            if r.location not in ("disk", "object"))
        return {
            "host_budget_bytes": self.host_budget_bytes,
            "host_bytes": self.host_bytes,
            "host_runs": host_runs,
            "disk_bytes": self.disk_bytes,
            "disk_runs": self.disk_runs,
            "demotions": self.demotions,
            "pages_demoted": self.pages_demoted,
            "bytes_demoted": self.bytes_demoted,
            "demote_failures": self.demote_failures,
            "promotions": self.promotions,
            "pages_promoted": self.pages_promoted,
            "bytes_promoted": self.bytes_promoted,
            "promote_failures": self.promote_failures,
            "host_evictions": self.host_evictions,
            "disk_spills": self.disk_spills,
            "disk_loads": self.disk_loads,
        }
