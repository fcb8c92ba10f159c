"""Content-addressed radix-tree KV prefix cache over the refcounted page pool.

Counterpart of kafka_tpu/runtime/prefix_cache.py (its jax-free body,
copied).  Multi-turn threads re-serve the
same conversation prefix every turn, and in a fan-out agent deployment
every thread begins with the same system prompt and tool schemas.  The
cache is a radix tree over page-granular token runs (SGLang's
RadixAttention; page sharing as in vLLM's PagedAttention): `lookup()`
walks the tree for the longest cached prefix regardless of which thread
wrote it, so a shared prefix prefills once per engine.

Mechanics:

* Nodes hold page-aligned token runs plus the physical pages backing them
  (the cache holds exactly one retain per stored page).  Children are keyed
  by their first *page* of tokens — sequences diverging mid-page therefore
  have different keys and never share the divergent page, which keeps every
  shared page byte-exact.
* `store()` inserts a finished sequence's materialized tokens along its
  token path: matched runs are descended (the cache keeps its existing
  pages — the incoming duplicates are simply not retained), divergence
  splits a node at the page boundary, and the unmatched suffix becomes a
  new node whose pages are retained.
* `lookup()` shares only whole pages and always leaves at least one prompt
  token to prefill (the prefill must produce last-token logits).  New
  tokens only ever write pages at or past the first partial page, so a
  shared full page is never re-written by the reusing sequence.
* Eviction is leaf-LRU: under page pressure (`reclaim`) or the page budget
  (`max_pages`, KAFKA_TORCH_PREFIX_CACHE_PAGES through the serving config)
  the least-recently-used *leaf* releases its pages — shared prefixes near
  the root survive their coldest consumer.  The engine reclaims here
  before it ever preempts a live request.
* `invalidate(thread_id)` drops only the nodes no *other* thread's store
  path claims, so deleting one thread never cold-starts its siblings.
* With a KV tier attached (runtime/kv_tier.py), eviction **demotes**
  instead of dropping: the node's pages are copied to the host tier and
  the node stays in the tree as a *host-resident* run (``pages == []``,
  ``host_run`` set).  A later ``lookup()`` crossing it allocates fresh
  pool pages and promotes the run back (``source="host_tier"``) — a
  returning thread re-materializes its KV instead of re-prefilling it.
  ``store()`` descending a host-resident run with matching tokens *adopts*
  the incoming sequence's pages — a free promotion.  A failed promote
  removes the node subtree and the hit truncates at that boundary:
  degrade to re-prefill, never partial KV.  With an object tier below the
  host tier (runtime/object_tier.py), ``sleep_to_object`` archives every
  run with per-thread sleep manifests, and a lookup wakes a dormant thread
  from its manifest (``source="object_tier"``).

Sharing is safe with the engine's async pipeline: a retiring request's
in-flight decode steps only write KV at positions >= the stored token
count, which land in the first partial (unshared) page or later.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from .kv_cache import OutOfPagesError, PagePool


@dataclasses.dataclass
class PrefixHit:
    """One successful lookup: the caller owns one retain on each page."""

    pages: List[int]
    tokens: int  # cached token count (= len(pages) * page_size)
    # "own" (this thread stored through here) | "cross" (another thread's
    # shared prefix) | "host_tier" (any part was promoted from the tier)
    # | "object_tier" (any part was woken from the shared object store)
    # | "shipped" (any part arrived via cross-replica page shipping)
    source: str
    # tokens of the hit that were re-materialized from the host/disk tier
    promoted_tokens: int = 0
    # tokens of the hit re-materialized from the shared OBJECT store —
    # a dormant thread waking on a replica that never served it
    object_tokens: int = 0


# Per-node claim cap: a fan-out shared-prefix node is stored through by
# EVERY thread, and claims must not grow host memory unboundedly on a
# long-lived engine.  Dropping the oldest claim is conservative: the node merely
# reads as "cross" for (and survives invalidate by) a thread that hasn't
# stored through it recently — exactly how a genuinely shared node behaves.
_KEYS_CAP = 512


class _Node:
    """One page-aligned token run.  Device-resident: len(tokens) ==
    len(pages) * page_size.  Host-resident (KV tier): pages is empty and
    `host_run` names the demoted payload — tokens are kept so the radix
    walk still matches through it."""

    __slots__ = ("tokens", "pages", "children", "parent", "keys",
                 "host_run", "shipped", "woken")

    def __init__(
        self,
        tokens: List[int],
        pages: List[int],
        parent: Optional["_Node"],
    ):
        self.tokens = tokens
        self.pages = pages
        # first-page token tuple -> child (mid-page divergence => distinct
        # first pages => distinct keys; splits stay page-aligned)
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        # prefix_keys whose store() path includes this node, recency-
        # ordered and capped (invalidate removes only nodes nobody else
        # claims; `in` answers own/cross classification)
        self.keys: "OrderedDict[str, None]" = OrderedDict()
        # KV-tier run id when demoted (host/disk resident), else None
        self.host_run: Optional[str] = None
        # True while this run's pages arrived via cross-replica page
        # shipping (disaggregated prefill/decode) and no local thread has
        # stored through it yet: the first lookup crossing it classifies
        # as cache_source="shipped", and a normal store() descending it
        # clears the marker.
        self.shipped = False
        # True while this run's pages were re-materialized from the
        # shared OBJECT store (a sleep-manifest wake) and no local thread
        # has stored through it since: lookups crossing it classify as
        # cache_source="object_tier" — the cross-host wake proof.
        self.woken = False

    def n_pages(self, page_size: int) -> int:
        """Run length in pages regardless of residency."""
        return len(self.tokens) // page_size


class PrefixCache:
    """Radix tree: token path -> retained pages, shared across threads."""

    def __init__(self, pool: PagePool, max_pages: Optional[int] = None,
                 tier=None):
        self.pool = pool
        # Page budget for retained pages (None = bounded only by pool
        # pressure via reclaim()).  Replaces the old entry-count cap: pages
        # are what the pool actually runs out of.
        self.max_pages = max_pages
        # Optional KV tier manager (runtime/kv_tier.KVTierManager): when
        # set, eviction demotes page runs host-side instead of dropping
        # them, and lookups promote them back.  None = the pre-tier
        # behavior, byte-identical.
        self.tier = tier
        self._root = _Node([], [], None)
        # running shape counters (store() at budget must not re-walk the
        # tree per evicted leaf — that is O(nodes^2) on the engine thread)
        self._n_nodes = 0
        self._n_pages = 0
        # leaves in (approximate) recency order: eviction pops the front in
        # O(1) instead of a full-tree scan per reclaimed leaf — reclaim()
        # runs on the engine thread's allocation path.  Approximate: a
        # node that BECOMES a leaf (split / child removal) re-enters at
        # the back; true recency is restored on its next touch.
        self._leaves: "OrderedDict[_Node, None]" = OrderedDict()
        # Set once any node's claim list hits _KEYS_CAP and drops a key:
        # the dropped key's deeper nodes may still claim it, breaking the
        # root-anchored invariant invalidate()'s fast path walks — it then
        # degrades to a full-tree sweep (tree size is page-bounded).
        self._claims_capped = False
        # Incremental page -> retain-count index mirroring the tree's
        # holdings.  Two consumers: page_owners() (engine self_check) no
        # longer walks the tree, and owns_any() answers the speculative-
        # decoding write-span invariant ("verify writes never touch
        # radix-shared pages") in O(span) per dispatch.
        self._page_retains: Dict[int, int] = {}
        # KV-tier shape counters (gauges; the tier manager owns the
        # demote/promote traffic counters)
        self._host_nodes = 0
        self._host_pages = 0
        # content generation: bumped whenever the set of cached (token,
        # page) runs changes; the DP router's probe memo keys each
        # replica's match_tokens result on it
        self.generation = 0
        # counters (observability + tests)
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0
        self.cross_thread_hits = 0  # hits whose deepest node another thread wrote
        self.host_tier_hits = 0  # hits that promoted at least one tier run
        self.object_tier_hits = 0  # hits crossing an object-store-woken run
        self.shipped_hits = 0  # hits crossing a cross-replica-shipped run
        self.probes = 0  # read-only match_tokens walks (router memo tests)
        self.evictions = 0  # nodes evicted under pressure (leaf-LRU + budget)
        self.pages_evicted = 0

    # -- introspection ---------------------------------------------------

    def _iter_nodes(self) -> Iterator[_Node]:
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            yield node

    def __len__(self) -> int:
        """Node count (the old per-thread entry count's closest analogue)."""
        return self._n_nodes

    @property
    def total_pages(self) -> int:
        """HBM pool pages the cache currently retains (gauge for
        /metrics; host-resident runs are counted by host_pages)."""
        return self._n_pages

    @property
    def host_nodes(self) -> int:
        """Radix nodes currently demoted to the KV tier (gauge)."""
        return self._host_nodes

    @property
    def host_pages(self) -> int:
        """Page-equivalents currently demoted to the KV tier (gauge)."""
        return self._host_pages

    def page_owners(self) -> Dict[int, int]:
        """Per-page retain counts held by the tree (engine self_check:
        these are legitimate owners alongside live sequences).  Served
        from the incremental index — O(cached pages), no tree walk."""
        return dict(self._page_retains)

    def owns_any(self, pages: Sequence[int]) -> bool:
        """Does the cache retain ANY of `pages`?  O(len(pages)) probe for
        the speculative-decoding invariant (engine._assert_private_tail):
        verify-step writes must never land in a radix-cached page."""
        return any(p in self._page_retains for p in pages)

    def _retain_pages(self, pages: Sequence[int]) -> None:
        self.pool.retain(pages)
        for p in pages:
            self._page_retains[p] = self._page_retains.get(p, 0) + 1

    def _release_pages(self, pages: Sequence[int]) -> None:
        self.pool.release(pages)
        for p in pages:
            left = self._page_retains.get(p, 0) - 1
            if left <= 0:
                self._page_retains.pop(p, None)
            else:
                self._page_retains[p] = left

    def _claim(self, node: _Node, key: str) -> None:
        node.keys[key] = None
        node.keys.move_to_end(key)
        while len(node.keys) > _KEYS_CAP:
            node.keys.popitem(last=False)
            self._claims_capped = True

    def _touch(self, node: _Node) -> None:
        """Refresh recency.  The _leaves OrderedDict IS the LRU state —
        only leaves are eviction candidates, so touching a non-leaf is a
        no-op by design."""
        if node in self._leaves:
            self._leaves.move_to_end(node)

    # -- lookup ----------------------------------------------------------

    def _walk(
        self, prompt_ids: Sequence[int]
    ) -> Tuple[List[Tuple[_Node, int]], int, _Node]:
        """Longest whole-page cached match for `prompt_ids` (read-only).

        Returns (segments, matched_pages, deepest_node) where segments is
        the matched (node, pages_taken) chain — nodes may be device- or
        host-resident (lookup() promotes the latter).  At least one prompt
        token is always left to prefill, so at most (len-1)//page_size
        pages are matchable.
        """
        ps = self.pool.page_size
        limit = (len(prompt_ids) - 1) // ps
        node = self._root
        segments: List[Tuple[_Node, int]] = []
        matched = 0
        while matched < limit:
            key = tuple(prompt_ids[matched * ps:(matched + 1) * ps])
            child = node.children.get(key)
            if child is None:
                break
            n = child.n_pages(ps)
            take = 1  # the child key IS its first page: already matched
            while (
                take < n
                and matched + take < limit
                and child.tokens[take * ps:(take + 1) * ps]
                == list(prompt_ids[(matched + take) * ps:(matched + take + 1) * ps])
            ):
                take += 1
            segments.append((child, take))
            matched += take
            node = child
            if take < n:
                break
        return segments, matched, node

    def match_tokens(self, prompt_ids: Sequence[int]) -> int:
        """Longest cached prefix in TOKENS — a read-only probe (no retains,
        no LRU touch, no hit/miss counters; `probes` counts walks so the
        router's memoization is testable).  Host-resident runs count: a
        lookup would promote them.  The DP router scores replicas with
        this."""
        self.probes += 1
        _, matched, _ = self._walk(prompt_ids)
        return matched * self.pool.page_size

    def lookup(
        self, key: str, prompt_ids: Sequence[int]
    ) -> Optional[PrefixHit]:
        """Longest cached prefix for `prompt_ids`, whoever wrote it.

        The caller owns one retain on each returned page (released through
        the sequence's normal free path).  `key` only classifies the hit:
        "own" when this thread's own store path covers the match, "cross"
        when another thread's prefix is being reused, "host_tier" when any
        part of the match was promoted back from the KV tier.

        Host-resident runs along the match are promoted here: fresh pool
        pages are allocated and the H2D copy is enqueued (ahead of the
        caller's suffix prefill, so it overlaps).  A promotion that cannot
        get pages — or whose run the tier lost — truncates the hit at that
        boundary; a torn promote additionally removes the node subtree
        (its pages were freed, nothing is shared yet: re-prefill, never
        partial KV).
        """
        segments, matched, _ = self._walk(prompt_ids)
        if (
            key is not None
            and self.tier is not None
            and getattr(self.tier, "object", None) is not None
        ):
            # Sleep-manifest wake: when the shared object
            # store knows this thread beyond what the local tree holds,
            # fetch its runs, import them into fresh pages and insert
            # them — the dormant thread wakes on THIS replica whether or
            # not it ever served here.
            if self._wake_from_object(key, prompt_ids, matched,
                                      {n for n, _ in segments}):
                segments, matched, _ = self._walk(prompt_ids)
        if matched == 0:
            self.misses += 1
            return None
        ps = self.pool.page_size
        pages: List[int] = []
        promoted = 0
        object_tok = 0
        shipped_any = False
        last_node: Optional[_Node] = None
        # nodes of this walk must not be evicted by promotion's reclaim —
        # their pages are in `pages` but not yet retained by the caller
        protect = {node for node, _ in segments}
        for node, take in segments:
            if node.host_run is not None:
                if self.tier is None:
                    break  # unreachable by construction; fail soft
                self.tier.touch(node.host_run)
                if not self._promote_node(node, protect):
                    break
                promoted += take * ps
            if node.shipped:
                shipped_any = True
            if node.woken:
                object_tok += take * ps
            pages.extend(node.pages[:take])
            last_node = node
        if last_node is None:
            self.misses += 1
            return None
        # refresh recency: only the deepest matched node can be a leaf
        # (its ancestors have children by construction), so one touch
        # keeps hot prefixes off the eviction front
        self._touch(last_node)
        self.pool.retain(pages)
        cached = len(pages) * ps
        if shipped_any:
            # runs shipped from a prefill-pool replica: the thread's
            # admission on the decode pool without a re-prefill is
            # provable from this
            source = "shipped"
        elif object_tok:
            # runs woken from the shared object store: the cross-host
            # resume-without-re-prefill is provable from this
            source = "object_tier"
        elif promoted:
            source = "host_tier"
        elif key is not None and key in last_node.keys:
            source = "own"
        else:
            source = "cross"
        return PrefixHit(pages=pages, tokens=cached, source=source,
                         promoted_tokens=promoted,
                         object_tokens=object_tok)

    def _wake_from_object(self, key: str, prompt_ids: Sequence[int],
                          matched: int, protect) -> bool:
        """Re-materialize a dormant thread from its sleep manifest.

        The manifest's runs beyond the locally-matched boundary are
        fetched from the shared store, imported into freshly-allocated
        pool pages (one contiguous alloc), and inserted into the radix
        tree via store() — dummy page ids stand in for the local prefix,
        which store() descends without touching.

        The wake TRUNCATES at the first ABSENT object (cheap head
        probes, before any paging work): organically-written manifests
        legitimately name ancestor runs that are still device-resident
        on the sleeping host and not archived yet, and runs past a
        missing one are unusable anyway (their prefix is the hole).
        Over the present runs it is ALL-OR-NOTHING: a failed get of a
        present object, size mismatch, or torn import frees every page
        allocated for the wake and aborts it — the request degrades to
        the local (disk-tier-or-less) hit, never partial KV.  Pages are
        reserved BEFORE the payload fetches, so pool pressure aborts
        without wasting store round-trips.  Returns True when at least
        one run was woken (the caller re-walks)."""
        from ..tracing import record_span

        obj = self.tier.object
        ps = self.pool.page_size
        limit = (len(prompt_ids) - 1) // ps  # max matchable pages
        if matched >= limit:
            return False
        man = obj.read_manifest(key)
        if man is None:
            return False
        toks = man.get("tokens") or []
        runs = man.get("runs") or []
        # verified page-aligned agreement between manifest and prompt
        m = 0
        stop = min(len(toks), limit * ps)
        while m < stop and toks[m] == prompt_ids[m]:
            m += 1
        man_pages = m // ps
        if man_pages <= matched:
            return False
        t0 = time.monotonic()
        # select the manifest runs beyond the local boundary (contiguous
        # from it; a run straddling the boundary means the local tree
        # split differently than the sleeping host's — abort, the local
        # hit stands)
        wake: List[Tuple[int, str]] = []  # (n_pages, run_key)
        off = 0
        for r in runs:
            n = int(r.get("tokens", 0)) // ps
            if n <= 0:
                return False  # malformed manifest
            if off + n <= matched:
                off += n
                continue
            if off < matched or off + n > man_pages:
                break
            if not r.get("key") or not obj.has_run(r["key"]):
                # absent object (an organically-manifested ancestor not
                # archived yet, or budget-evicted content): truncate —
                # deeper runs are unusable without this prefix
                break
            wake.append((n, r["key"]))
            off += n
        if not wake:
            return False
        # reserve the destination pages BEFORE fetching payloads: pool
        # pressure must abort without paying store round-trips
        total_pages = sum(n for n, _ in wake)
        if self.pool.free_pages < total_pages:
            self._reclaim_protected(total_pages, protect)
        try:
            pages = self.pool.alloc(total_pages)
        except OutOfPagesError:
            return False
        nbytes = 0
        pos = 0
        # fetch_run consumes payloads the wake prefetcher staged at
        # submit time; without a prefetcher (or on a bare
        # test tier predating it) it IS get_run
        fetch = getattr(obj, "fetch_run", None) or obj.get_run
        pre = getattr(obj, "prefetcher", None)
        if pre is not None and len(wake) > 1:
            # multi-run wake: stage every run NOW so the store GETs run
            # in parallel on the prefetcher pool and the loop below
            # consumes them in order — the wake pays ~one RTT instead of
            # len(wake).  Single-flight with any return-hint prefetch;
            # a full staging budget degrades per-run to the serial fetch.
            pre.stage_runs([rkey for _, rkey in wake], key)
        try:
            for n, rkey in wake:
                got = fetch(rkey)
                if got is None or got[2] != n:
                    # failed get of a PRESENT object (torn fetch, lost
                    # between head and get) or a payload whose span
                    # disagrees with the manifest: free EVERY wake page
                    # and keep the local hit.  A miss already counted in
                    # get_run; a span mismatch must not stay invisible.
                    if got is not None:
                        obj.object_get_failures += 1
                    self.pool.release(pages)
                    return False
                k_l, v_l, _, got_bytes = got
                nbytes += got_bytes
                self.tier.shipper.import_run(k_l, v_l, n,
                                             pages[pos:pos + n])
                pos += n
        except Exception:
            # torn import: free EVERY wake page (freshly allocated,
            # shared with nobody — complete cleanup), keep the local hit
            self.pool.release(pages)
            obj.object_get_failures += 1
            return False
        end = (matched + total_pages) * ps
        self.store(key, list(prompt_ids[:end]),
                   [-1] * matched + list(pages), woken=True)
        self.pool.release(pages)  # store() retained what it kept
        woken_tokens = total_pages * ps
        obj.wake_threads += 1
        obj.wake_tokens += woken_tokens
        record_span(
            self.tier.trace_ctx, "thread.wake", time.monotonic() - t0,
            attrs={"tokens": woken_tokens, "runs": len(wake),
                   "bytes": nbytes, "source": "object_tier"},
        )
        return True

    def _promote_node(self, node: _Node, protect) -> bool:
        """Re-materialize a host-resident run into fresh pool pages.

        Under page pressure, promotion reclaims OTHER leaves first —
        demoting a cold run to re-materialize the returning hot one is
        the tier's whole policy — but never a node of the current walk
        (`protect`): those pages are in the hit being assembled and not
        yet retained by the caller, so evicting one would free pages out
        from under the hit.  On tier failure the node subtree is removed
        (the run is gone; deeper nodes are unreachable KV) and the caller
        degrades to re-prefill.
        """
        assert self.tier is not None and node.host_run is not None
        n = node.n_pages(self.pool.page_size)
        if self.pool.free_pages < n:
            self._reclaim_protected(n, protect)
        try:
            new_pages = self.pool.alloc(n)
        except OutOfPagesError:
            return False  # hit truncates; the node stays host-resident
        if not self.tier.promote(node.host_run, new_pages):
            self.pool.release(new_pages)
            self._remove_subtree(node)
            return False
        node.host_run = None
        node.pages = new_pages
        for p in new_pages:
            # alloc's refcount 1 IS the cache's retain — index it without
            # a second pool.retain
            self._page_retains[p] = self._page_retains.get(p, 0) + 1
        self._n_pages += n
        self._host_pages -= n
        self._host_nodes -= 1
        if not node.children:
            self._leaves[node] = None
            self._leaves.move_to_end(node)
        return True

    def commit_hit(self, tokens: int, source: Optional[str]) -> None:
        """Count one hit.  Deliberately NOT done inside lookup(): these
        counters export as a Prometheus counter family (monotone by
        contract), and a page-blocked admission re-runs lookup every
        scheduler iteration — counting there would either inflate the
        hit/reuse figures at scheduler cadence exactly while the cache is
        thrashing, or require a retraction that breaks monotonicity (a
        decreasing counter reads as a reset to PromQL rate()).  The
        engine commits exactly once, when the prefill actually starts."""
        self.hits += 1
        self.tokens_reused += tokens
        if source == "cross":
            self.cross_thread_hits += 1
        elif source == "host_tier":
            self.host_tier_hits += 1
        elif source == "object_tier":
            self.object_tier_hits += 1
        elif source == "shipped":
            self.shipped_hits += 1

    # -- store -----------------------------------------------------------

    def store(self, key: str, tokens: Sequence[int], pages: Sequence[int],
              shipped: bool = False, woken: bool = False) -> None:
        """Insert a finished sequence's materialized tokens along its path.

        Only whole pages are stored (`tokens` must count exactly the
        materialized KV slots — the engine drops the final sampled token,
        whose KV is never written).  Matched runs keep the cache's
        existing pages; only the unmatched suffix's pages are retained.

        ``shipped=True`` registers a run arriving via cross-replica page
        shipping (dp_router._ship_run): new nodes carry the shipped marker
        so the thread's first lookup classifies as
        ``cache_source="shipped"``; a later normal store descending them
        clears it.  Matched runs along a shipped registration are not
        re-marked: they are this replica's own content, and the duplicate
        shipped pages for them are not retained (the caller's release
        frees them).

        ``woken=True`` marks runs re-materialized from the object store
        (_wake_from_object): first lookups crossing them classify as
        ``cache_source="object_tier"``.  Both callers pass DUMMY page ids
        (-1) for the already-present prefix; matched
        runs never read their page entries, and the guards below make a
        dummy id inert everywhere one could otherwise be captured (fresh
        insert after a racing eviction, host-run adoption).
        """
        ps = self.pool.page_size
        n_full = min(len(pages), len(tokens) // ps)
        node = self._root
        idx = 0  # page index into the incoming sequence
        while idx < n_full:
            pkey = tuple(tokens[idx * ps:(idx + 1) * ps])
            child = node.children.get(pkey)
            if child is None:
                run_pages = list(pages[idx:n_full])
                if any(p < 0 for p in run_pages):
                    # dummy placeholder ids (delta-ship skip / object
                    # wake) whose matched node was evicted mid-operation:
                    # there is nothing real to insert here
                    break
                run_tokens = list(tokens[idx * ps:n_full * ps])
                self._retain_pages(run_pages)
                self.generation += 1
                new = _Node(run_tokens, run_pages, node)
                new.shipped = shipped
                new.woken = woken
                self._claim(new, key)
                node.children[pkey] = new
                self._n_nodes += 1
                self._n_pages += len(run_pages)
                self._leaves[new] = None
                self._leaves.pop(node, None)  # parent is no longer a leaf
                self._touch(new)
                break
            n = child.n_pages(ps)
            take = 1
            while (
                take < n
                and idx + take < n_full
                and child.tokens[take * ps:(take + 1) * ps]
                == list(tokens[(idx + take) * ps:(idx + take + 1) * ps])
            ):
                take += 1
            if take < n:
                # The run extends past this sequence's path — divergence
                # inside the run, OR our tokens ran out mid-run.  Split at
                # the boundary either way: the claim below must cover ONLY
                # the pages this thread's path actually walked, or a short
                # store would extend its ownership over another thread's
                # tail (mislabelling own/cross hits and pinning the tail
                # against invalidate()).  A host-resident run whose tier
                # payload is gone cannot split — drop the subtree and
                # retry this page index (the fresh-insert branch takes it).
                if not self._split(child, take):
                    self._remove_subtree(child)
                    continue
            if child.host_run is not None:
                # Adoption: the incoming sequence carries freshly-computed
                # pages for exactly this run's tokens — a free promotion.
                # The tier copy is dropped; the node is device-resident
                # again without any H2D traffic.  Adoption is keyed on
                # REAL page ids: a delta-ship registration or object wake
                # passes dummy (-1) entries for runs the destination
                # already holds, and adopting those would capture garbage
                # — the run stays tier-resident and promotes as usual.
                adopt = list(pages[idx:idx + take])
                if all(p >= 0 for p in adopt):
                    self._retain_pages(adopt)
                    child.pages = adopt
                    if self.tier is not None:
                        self.tier.discard(child.host_run)
                    child.host_run = None
                    self._n_pages += take
                    self._host_pages -= take
                    self._host_nodes -= 1
                    if not child.children:
                        self._leaves[child] = None
            if child.shipped and not shipped:
                # the thread's own finish stored through the shipped run:
                # ordinary cache content from here on
                child.shipped = False
            if child.woken and not woken and not shipped:
                # the thread's own finish stored through the woken run
                child.woken = False
            self._claim(child, key)
            self._touch(child)
            node = child
            idx += take
        self._evict_to_budget()

    def _split(self, node: _Node, take: int) -> bool:
        """Split `node` at `take` pages; the suffix becomes its child.
        Device runs move pages between the nodes (no refcount changes);
        host-resident runs split their tier payload at the same boundary.
        Returns False when the tier payload is gone — the caller must
        remove the node (its KV no longer exists anywhere)."""
        ps = self.pool.page_size
        front_run = back_run = None
        if node.host_run is not None:
            if self.tier is None:
                return False
            parts = self.tier.split(node.host_run, take)
            if parts is None:
                return False
            front_run, back_run = parts
        suffix = _Node(node.tokens[take * ps:], node.pages[take:], node)
        suffix.shipped = node.shipped  # both halves are the shipped run
        suffix.woken = node.woken
        suffix.children = node.children
        for c in suffix.children.values():
            c.parent = suffix
        suffix.keys = OrderedDict(node.keys)
        node.tokens = node.tokens[: take * ps]
        node.pages = node.pages[:take]
        node.children = {tuple(suffix.tokens[:ps]): suffix}
        if front_run is not None:
            node.host_run, suffix.host_run = front_run, back_run
            self._host_nodes += 1  # one host node became two
        self._n_nodes += 1  # pages just moved between the two nodes
        # leaf status transfers: the prefix now has a child; the suffix is
        # a leaf iff the original node was one (it inherited the children)
        # — host-resident suffixes are never pool-eviction candidates
        self._leaves.pop(node, None)
        if not suffix.children and suffix.host_run is None:
            self._leaves[suffix] = None
        return True

    # -- eviction --------------------------------------------------------

    def _remove(self, node: _Node) -> None:
        """Detach one node and release its pages (or discard its tier
        run).  No eviction counters — pressure eviction (_evict_leaf)
        counts itself; invalidate()/clear() must not read as cache thrash
        on /metrics."""
        ps = self.pool.page_size
        parent = node.parent
        if parent is not None:
            parent.children.pop(tuple(node.tokens[:ps]), None)
            if (
                parent is not self._root
                and not parent.children
                and parent.host_run is None
            ):
                self._leaves[parent] = None  # parent became a leaf
        if node.host_run is not None:
            if self.tier is not None:
                self.tier.discard(node.host_run)
            self._host_nodes -= 1
            self._host_pages -= node.n_pages(ps)
            node.host_run = None
        else:
            self._release_pages(node.pages)
            self._n_pages -= len(node.pages)
        self.generation += 1
        self._n_nodes -= 1
        self._leaves.pop(node, None)
        node.parent = None

    def _remove_subtree(self, node: _Node) -> None:
        """Remove `node` and everything below it (a lost tier run makes
        the whole subtree unreachable KV — deeper runs can never be
        attached without their prefix)."""
        stack = [node]
        order: List[_Node] = []
        while stack:
            n = stack.pop()
            order.append(n)
            stack.extend(n.children.values())
        for n in reversed(order):  # children before ancestors
            self._remove(n)

    def _evict_leaf(self) -> bool:
        """Release the least-recently-used leaf — O(1) via the recency-
        ordered leaf map, not a tree walk (reclaim runs on the engine
        thread's allocation path).  Leaf-LRU by design: shared prefixes
        near the root outlive their coldest consumer.

        With a KV tier attached the victim is DEMOTED instead of dropped:
        its rows are copied device->host (async; the gather is enqueued
        before the pages are released, so in-order execution reads them
        pre-overwrite), the pool pages are freed, and the node stays in
        the tree as a host-resident run a future lookup can promote.  A
        refused/failed demote (tier full, injected fault) falls back to
        the plain drop."""
        if not self._leaves:
            return False
        self._evict_node(next(iter(self._leaves)))
        return True

    def _path_runs(self, node: _Node) -> List[List[int]]:
        """Per-node token runs of the radix path root -> `node` (the
        object tier's content-address context: a run's KV depends on its
        whole prefix).  O(path depth)."""
        runs: List[List[int]] = []
        n: Optional[_Node] = node
        while n is not None and n is not self._root:
            runs.append(list(n.tokens))
            n = n.parent
        runs.reverse()
        return runs

    def _evict_node(self, victim: _Node) -> None:
        """Demote-or-drop one leaf (the shared step of LRU eviction and
        promotion's protected reclaim)."""
        if self.tier is not None and victim.pages:
            has_obj = getattr(self.tier, "object", None) is not None
            run = self.tier.demote(
                victim.pages,
                # content-address context rides only when an object tier
                # can use it (the path walk is not free)
                path_runs=self._path_runs(victim) if has_obj else None,
                threads=list(victim.keys) if has_obj else (),
            )
            if run is not None:
                n = len(victim.pages)
                self._release_pages(victim.pages)
                self._n_pages -= n
                self._host_pages += n
                self._host_nodes += 1
                victim.pages = []
                victim.host_run = run
                # host-resident runs leave the pool-eviction LRU; the
                # tier's own second-chance LRU owns them now.
                self._leaves.pop(victim, None)
                return
        self.evictions += 1
        self.pages_evicted += len(victim.pages)
        self._remove(victim)

    def _reclaim_protected(self, pages_needed: int, protect) -> None:
        """Evict LRU leaves outside `protect` until the pool can satisfy
        `pages_needed` (promotion's reclaim).  Best-effort: released
        pages only become free when no live sequence shares them."""
        while self.pool.free_pages < pages_needed:
            victim = next(
                (nd for nd in self._leaves if nd not in protect), None
            )
            if victim is None:
                return
            self._evict_node(victim)

    def _evict_to_budget(self) -> None:
        """Enforce the page budget, PAGE-granular: the LRU leaf is trimmed
        from its tail rather than dropped whole, so a budget smaller than
        one stored run keeps the head of the shared prefix (the part every
        thread reuses) instead of zeroing the cache."""
        if self.max_pages is None:
            return
        ps = self.pool.page_size
        while self._n_pages > self.max_pages and self._leaves:
            if self.tier is not None:
                # tiered: demote the whole LRU leaf (run granularity —
                # demotion is not loss, so the partial-trim subtlety
                # below doesn't apply)
                if not self._evict_leaf():
                    break
                continue
            overage = self._n_pages - self.max_pages
            victim = next(iter(self._leaves))
            n = min(len(victim.pages), overage)
            self.pages_evicted += n
            keep = len(victim.pages) - n
            if keep <= 0:
                self.evictions += 1
                self._remove(victim)
            else:
                self._release_pages(victim.pages[keep:])
                self.generation += 1
                victim.pages = victim.pages[:keep]
                victim.tokens = victim.tokens[: keep * ps]
                self._n_pages -= n

    def reclaim(self, pages_needed: int) -> bool:
        """Evict LRU leaves until the pool can satisfy `pages_needed`.

        Released pages only become free when no live sequence shares them,
        so eviction proceeds leaf by leaf and may legitimately fail.
        """
        while self.pool.free_pages < pages_needed:
            if not self._evict_leaf():
                return False
        return True

    # -- sleep (drain-to-object) -----------------------------------------

    def _materialize_node(self, node: _Node):
        """Host leaves of one node's KV wherever it lives (device pages
        via a blocking D2H gather, host/disk via the tier's read-only
        peek).  None = nothing local to archive (object-resident) or a
        failed load — the sleep entry is skipped."""
        try:
            if node.pages:
                pend = self.tier.shipper.export_run(node.pages)
                return self.tier.shipper.resolve(pend)
            if node.host_run is not None:
                return self.tier.peek(node.host_run)
        except Exception:
            return None
        return None

    def _claimed_chain(self, key: str) -> List[_Node]:
        """The deepest root-anchored chain of nodes claiming `key` (the
        thread's stored path; store() claims every node it walks, so the
        claims form chains — a thread whose prompt diverged mid-history
        has several, and the deepest is its current conversation)."""
        best: List[_Node] = []
        best_tokens = 0
        stack = [
            [c] for c in self._root.children.values() if key in c.keys
        ]
        while stack:
            path = stack.pop()
            deeper = [
                c for c in path[-1].children.values() if key in c.keys
            ]
            if deeper:
                stack.extend(path + [c] for c in deeper)
                continue
            n_tok = sum(len(n.tokens) for n in path)
            if n_tok > best_tokens:
                best, best_tokens = path, n_tok
        return best

    def sleep_to_object(self) -> Dict[str, int]:
        """Flush EVERY cached run into the shared object store and write
        every claiming thread's sleep manifest — the ``POST
        /admin/drain/{replica}`` seam (autoscaler drain-then-shrink): a
        replica drained this way can be torn down without discarding any
        warm thread state, because any replica of any host sharing the
        store can wake the threads from their manifests.

        Non-destructive: archiving is a COPY (content-addressed and
        refcounted, so re-archiving present content is a reference-only
        dedupe), the tree and pool are untouched, and serving resumes
        unchanged if the replica is kept after all.  Must run with the
        scheduler quiesced (the provider parks the worker) — the D2H
        gathers read the pool the engine thread otherwise mutates."""
        if self.tier is None or getattr(self.tier, "object", None) is None:
            return {"enabled": False}
        obj = self.tier.object
        self.tier.drain(force=True)  # resolve in-flight demotes first
        ps = self.pool.page_size
        stats = {
            "enabled": True, "runs_archived": 0, "runs_failed": 0,
            "runs_skipped_store_down": 0, "manifests": 0,
            "manifests_failed": 0, "threads": 0,
        }
        bytes0 = obj.object_bytes_put
        dedupe0 = obj.dedupe_hits
        keys_seen: set = set()
        # 1) archive every run, parents before children, path accumulated
        stack = [(c, []) for c in self._root.children.values()]
        while stack:
            node, path = stack.pop()
            path_runs = path + [list(node.tokens)]
            for c in node.children.values():
                stack.append((c, path_runs))
            keys_seen.update(node.keys)
            if not obj.available():
                # store breaker open: nothing can land, so skip the D2H
                # gather + encode outright.  The drain returns a PARTIAL
                # result with honest per-run accounting — the autoscaler
                # shrinks anyway (capacity beats warm state) and the
                # skipped runs re-prefill on wake.
                stats["runs_failed"] += 1
                stats["runs_skipped_store_down"] += 1
                continue
            flat = [t for seg in path_runs for t in seg]
            if obj.has_run(obj.run_key(flat, node.n_pages(ps))):
                ok = obj.put_run(flat, None, None,
                                 node.n_pages(ps)) is not None
            else:
                payload = self._materialize_node(node)
                if payload is None and node.host_run is not None:
                    # object-resident already (archived organically)
                    ok = obj.put_run(flat, None, None,
                                     node.n_pages(ps)) is not None
                elif payload is None:
                    ok = False
                else:
                    ok = obj.put_run(flat, payload[0], payload[1],
                                     node.n_pages(ps)) is not None
            stats["runs_archived" if ok else "runs_failed"] += 1
        # 2) one manifest per claiming thread, covering its deepest chain
        for key in sorted(keys_seen):
            chain = self._claimed_chain(key)
            if not chain:
                continue
            path_runs = [list(n.tokens) for n in chain]
            tokens = [t for seg in path_runs for t in seg]
            if obj.write_manifest(key, tokens, obj.manifest_runs(path_runs)):
                stats["manifests"] += 1
            else:
                stats["manifests_failed"] += 1
        stats["threads"] = len(keys_seen)
        stats["bytes_put"] = obj.object_bytes_put - bytes0
        stats["dedupe_hits"] = obj.dedupe_hits - dedupe0
        stats["breaker_state"] = obj.breaker_state()
        return stats

    # -- agent tool-call gap ---------------------------------------------

    def touch_thread(self, key: str) -> int:
        """Set the second-chance reference bit on every tier-resident run
        of `key`'s stored path (the return hint fired: the follow-up turn
        is imminent, so the thread's runs must survive host-tier LRU for
        the next few seconds).  Returns the thread's locally-resident
        token depth — the same figure thread_resident_tokens reports,
        saved a second chain walk."""
        resident = 0
        for node in self._claimed_chain(key):
            resident += len(node.tokens)
            if node.host_run is not None and self.tier is not None:
                self.tier.touch(node.host_run)
        return resident

    def thread_resident_tokens(self, key: str) -> int:
        """Tokens of `key`'s stored path resident LOCALLY — device pages
        or host/disk runs, either of which a wake serves without a store
        round trip.  The return-triggered prefetch passes this as
        ``min_depth``: object GETs only help beyond it."""
        return sum(len(n.tokens) for n in self._claimed_chain(key))

    def demote_thread(self, key: str, archive: bool = False) -> Dict[str, int]:
        """Proactively demote thread `key`'s device-resident KV down the
        tier ladder (the agent tool-call gap): the thread just
        emitted a tool call and will sit idle for the tool's runtime, so
        its pages serve nobody — free them NOW instead of waiting for
        eviction pressure to find the leaf.

        Walks the thread's deepest claimed chain leaf-ward and demotes
        each exclusively-claimed node exactly like LRU eviction's demote
        branch (node stays in the tree as a host run; content unchanged,
        the follow-up turn's lookup still matches
        and promotes).  Stops at the first SHARED node: claims form
        root-anchored paths, so everything above it is shared too, and a
        fan-out system prompt must stay hot for its sibling threads.  A
        refused demote (tier budget, deferral ladder) stops the walk —
        never drops: losing KV to save HBM would turn the follow-up turn
        into a re-prefill, the exact cost this path exists to avoid.

        With ``archive=True`` (KAFKA_TORCH_AGENT_DEMOTE=object) the chain
        is archived into the object store FIRST and the thread's sleep
        manifest written — the same per-run protocol as
        :meth:`sleep_to_object`, scoped to one thread — so the return
        hint's wake prefetch works from ANY replica, not just this one.
        A durable archive also upgrades the refusal rule: when the host
        tier refuses a node (budget smaller than the run — the ladder's
        first rung is missing), the node drops straight to the OBJECT
        rung — removed from the tree, pages freed — because the store
        now holds the bytes and the follow-up's lookup wakes the chain
        back via the manifest.  Without a durable manifest a refusal
        still stops the walk (never trade KV for HBM blindly)."""
        stats = {"nodes": 0, "pages": 0, "dropped": 0}
        if self.tier is None:
            return stats
        chain = self._claimed_chain(key)
        has_obj = getattr(self.tier, "object", None) is not None
        durable = False
        if archive and has_obj and chain:
            # archive BEFORE demoting: _materialize_node reads device
            # pages or host runs, and a durable manifest licenses the
            # direct-to-object drop below
            stats["manifest"] = self._archive_thread_chain(key, chain)
            durable = stats["manifest"] == 1
        path_clear = True  # no on-path child left behind so far
        for node in reversed(chain):  # leaf-ward: private before shared
            if len(node.keys) > 1 or key not in node.keys:
                break  # shared prefix: stays hot for sibling threads
            if not node.pages:
                path_clear = False  # tier-resident node stays in tree
                continue
            run = self.tier.demote(
                node.pages,
                path_runs=self._path_runs(node) if has_obj else None,
                threads=list(node.keys) if has_obj else (),
            )
            if run is None:
                # tier refused.  With the chain durably archived, drop to
                # the object rung — but only a node whose children are
                # all already gone (pure-path tail): removing a fan-out
                # node would orphan live subtrees.
                if durable and path_clear and not node.children:
                    n = len(node.pages)
                    self._remove(node)
                    stats["dropped"] += 1
                    stats["pages"] += n
                    continue
                break  # keep the remainder hot, never drop
            n = len(node.pages)
            self._release_pages(node.pages)
            self._n_pages -= n
            self._host_pages += n
            self._host_nodes += 1
            node.pages = []
            node.host_run = run
            self._leaves.pop(node, None)
            path_clear = False  # node survives in the tree
            stats["nodes"] += 1
            stats["pages"] += n
        return stats

    def _archive_thread_chain(self, key: str, chain: List[_Node]) -> int:
        """Archive one thread's chain + manifest (demote_thread's object
        mode).  Returns 1 when the manifest landed, else 0."""
        obj = self.tier.object
        if not obj.available():
            return 0
        self.tier.drain(force=True)  # resolve in-flight demotes for peek
        ps = self.pool.page_size
        path: List[List[int]] = []
        for node in chain:
            path.append(list(node.tokens))
            flat = [t for seg in path for t in seg]
            if obj.has_run(obj.run_key(flat, node.n_pages(ps))):
                ok = obj.put_run(flat, None, None,
                                 node.n_pages(ps)) is not None
            else:
                payload = self._materialize_node(node)
                ok = (payload is not None
                      and obj.put_run(flat, payload[0], payload[1],
                                      node.n_pages(ps)) is not None)
            if not ok:
                # a manifest naming an absent run would truncate every
                # wake at the gap — better no manifest than a torn one
                return 0
        runs = [list(n.tokens) for n in chain]
        tokens = [t for seg in runs for t in seg]
        return 1 if obj.write_manifest(
            key, tokens, obj.manifest_runs(runs)
        ) else 0

    def invalidate(self, key: str) -> None:
        """Drop `key`'s claim; free only nodes no other thread claims.

        Shared prefix nodes (another thread's store path crosses them)
        survive, so deleting one thread never cold-starts its siblings.
        Claimed nodes form root-anchored paths (store() claims every node
        it walks), so the traversal descends only children claiming `key`
        — O(claimed path), not O(tree) — and unwinds iteratively (a long
        multi-turn thread is a deep node chain; recursion would overflow).
        Once any claim list has hit _KEYS_CAP the root-anchored invariant
        may be broken (an ancestor dropped the key while deeper nodes
        still hold it), so the sweep covers the whole tree instead —
        correctness over speed, and the tree stays page-bounded anyway.
        """
        if self._claims_capped:
            order: List[_Node] = list(self._iter_nodes())
        else:
            stack = [
                c for c in self._root.children.values() if key in c.keys
            ]
            order = []
            while stack:
                node = stack.pop()
                order.append(node)
                stack.extend(
                    c for c in node.children.values() if key in c.keys
                )
        # preorder reversed: every node is processed before its ancestors,
        # so a freed leaf can cascade up its now-empty parents
        for node in reversed(order):
            node.keys.pop(key, None)
            if not node.children and not node.keys:
                self._remove(node)

    def clear(self) -> None:
        """Release everything (not counted as pressure eviction)."""
        for node in list(self._iter_nodes()):
            if node.host_run is not None:
                if self.tier is not None:
                    self.tier.discard(node.host_run)
            else:
                self.pool.release(node.pages)
        self._root = _Node([], [], None)
        self._n_nodes = 0
        self._n_pages = 0
        self._host_nodes = 0
        self._host_pages = 0
        self._leaves = OrderedDict()
        self._page_retains = {}
        self.generation += 1
