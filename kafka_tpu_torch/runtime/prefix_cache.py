"""Content-addressed radix-tree KV prefix cache over the refcounted page pool.

Counterpart of kafka_tpu/runtime/prefix_cache.py (its jax-free body,
copied).  Multi-turn threads re-serve the same conversation prefix every
turn, and in a fan-out agent deployment every thread begins with the same
system prompt and tool schemas.  The cache is a radix tree over
page-granular token runs (SGLang's RadixAttention; page sharing as in
vLLM's PagedAttention): `lookup()` walks the tree for the longest cached
prefix regardless of which thread wrote it, so a shared prefix prefills
once per engine.

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

Not ported yet (ROADMAP A10/A11): the KV-tier and object-store hooks of
the reference — host-resident nodes, demotion on eviction and promotion
on lookup, sleep manifests and wake, agent-gap thread demotion and the
shipped-run markers of disaggregated serving.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from .kv_cache import PagePool


@dataclasses.dataclass
class PrefixHit:
    """One successful lookup: the caller owns one retain on each page."""

    pages: List[int]
    tokens: int  # cached token count (= len(pages) * page_size)
    # "own" (this thread stored through here) | "cross" (another thread's
    # shared prefix)
    source: str


# Per-node claim cap: a fan-out shared-prefix node is stored through by
# every thread, and claims must not grow host memory without bound.
# Dropping the oldest claim is conservative: the node merely reads as
# "cross" for (and survives invalidate by) a thread that hasn't stored
# through it recently — exactly how a genuinely shared node behaves.
_KEYS_CAP = 512


class _Node:
    """One page-aligned token run: len(tokens) == len(pages) * page_size."""

    __slots__ = ("tokens", "pages", "children", "parent", "keys")

    def __init__(self, tokens: List[int], pages: List[int],
                 parent: Optional["_Node"]):
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

    def n_pages(self, page_size: int) -> int:
        return len(self.tokens) // page_size


class PrefixCache:
    """Radix tree: token path -> retained pages, shared across threads."""

    def __init__(self, pool: PagePool, max_pages: Optional[int] = None):
        self.pool = pool
        # page budget for retained pages (None = bounded only by pool
        # pressure via reclaim())
        self.max_pages = max_pages
        self._root = _Node([], [], None)
        # retained-page count (store() at budget must not re-walk the tree
        # per evicted leaf)
        self._n_pages = 0
        # leaves in (approximate) recency order: eviction pops the front
        # in O(1).  A node that BECOMES a leaf (split / child removal)
        # re-enters at the back; true recency returns on its next touch.
        self._leaves: "OrderedDict[_Node, None]" = OrderedDict()
        # set once any node's claim list hits _KEYS_CAP: invalidate() then
        # sweeps the whole tree (the root-anchored claim chains may break)
        self._claims_capped = False
        # page -> retain count mirroring the tree's holdings: the engine's
        # self_check (page_owners) and the speculative write-span
        # invariant (owns_any) read it without walking the tree
        self._page_retains: Dict[int, int] = {}
        # counters (observability + tests)
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0
        self.cross_thread_hits = 0
        self.evictions = 0  # nodes evicted (leaf-LRU + budget)
        self.pages_evicted = 0

    # -- introspection ---------------------------------------------------

    def _iter_nodes(self) -> Iterator[_Node]:
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            yield node

    @property
    def total_pages(self) -> int:
        """Pool pages the cache currently retains."""
        return self._n_pages

    def page_owners(self) -> Dict[int, int]:
        """Per-page retain counts held by the tree (engine self_check:
        these are legitimate owners alongside live sequences)."""
        return dict(self._page_retains)

    def owns_any(self, pages: Sequence[int]) -> bool:
        """Does the cache retain ANY of `pages`?  The speculative verify
        step's writes must never land in a radix-cached page."""
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
        """Refresh recency (only leaves are eviction candidates)."""
        if node in self._leaves:
            self._leaves.move_to_end(node)

    # -- lookup ----------------------------------------------------------

    def _walk(self, prompt_ids: Sequence[int]
              ) -> Tuple[List[Tuple[_Node, int]], int]:
        """Longest whole-page cached match for `prompt_ids` (read-only):
        (the matched (node, pages_taken) chain, matched pages).  At least
        one prompt token is always left to prefill, so at most
        (len-1)//page_size pages are matchable."""
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
                == list(prompt_ids[(matched + take) * ps:
                                   (matched + take + 1) * ps])
            ):
                take += 1
            segments.append((child, take))
            matched += take
            node = child
            if take < n:
                break
        return segments, matched

    def match_tokens(self, prompt_ids: Sequence[int]) -> int:
        """Longest cached prefix in TOKENS — a read-only probe (no
        retains, no LRU touch, no counters)."""
        return self._walk(prompt_ids)[1] * self.pool.page_size

    def lookup(self, key: Optional[str], prompt_ids: Sequence[int]
               ) -> Optional[PrefixHit]:
        """Longest cached prefix for `prompt_ids`, whoever wrote it.

        The caller owns one retain on each returned page (released through
        the sequence's normal free path).  `key` only classifies the hit:
        "own" when this thread's own store path covers the match, "cross"
        when another thread's prefix is being reused.
        """
        segments, matched = self._walk(prompt_ids)
        if matched == 0:
            self.misses += 1
            return None
        pages: List[int] = []
        for node, take in segments:
            pages.extend(node.pages[:take])
        last_node = segments[-1][0]
        # only the deepest matched node can be a leaf (its ancestors have
        # children by construction): one touch keeps hot prefixes off the
        # eviction front
        self._touch(last_node)
        self.pool.retain(pages)
        source = "own" if key is not None and key in last_node.keys \
            else "cross"
        return PrefixHit(pages=pages, tokens=len(pages) * self.pool.page_size,
                         source=source)

    def commit_hit(self, tokens: int, source: Optional[str]) -> None:
        """Count one hit.  Not done inside lookup(): a page-blocked
        admission re-runs lookup every scheduler iteration, so the engine
        commits exactly once, when the prefill actually starts."""
        self.hits += 1
        self.tokens_reused += tokens
        if source == "cross":
            self.cross_thread_hits += 1

    # -- store -----------------------------------------------------------

    def store(self, key: str, tokens: Sequence[int],
              pages: Sequence[int]) -> None:
        """Insert a finished sequence's materialized tokens along its path.

        Only whole pages are stored (`tokens` must count exactly the
        materialized KV slots — the engine drops the final sampled token,
        whose KV is never written).  Matched runs keep the cache's
        existing pages; only the unmatched suffix's pages are retained.
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
                self._retain_pages(run_pages)
                new = _Node(list(tokens[idx * ps:n_full * ps]), run_pages,
                            node)
                self._claim(new, key)
                node.children[pkey] = new
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
                # The run extends past this sequence's path (divergence
                # inside the run, or our tokens ran out mid-run).  Split at
                # the boundary either way: the claim below must cover ONLY
                # the pages this thread's path walked, or a short store
                # would extend its ownership over another thread's tail.
                self._split(child, take)
            self._claim(child, key)
            self._touch(child)
            node = child
            idx += take
        self._evict_to_budget()

    def _split(self, node: _Node, take: int) -> None:
        """Split `node` at `take` pages; the suffix becomes its child.
        Pages move between the nodes (no refcount changes)."""
        ps = self.pool.page_size
        suffix = _Node(node.tokens[take * ps:], node.pages[take:], node)
        suffix.children = node.children
        for c in suffix.children.values():
            c.parent = suffix
        suffix.keys = OrderedDict(node.keys)
        node.tokens = node.tokens[: take * ps]
        node.pages = node.pages[:take]
        node.children = {tuple(suffix.tokens[:ps]): suffix}
        # leaf status transfers: the prefix now has a child; the suffix is
        # a leaf iff the original node was one (it inherited the children)
        self._leaves.pop(node, None)
        if not suffix.children:
            self._leaves[suffix] = None

    # -- eviction --------------------------------------------------------

    def _remove(self, node: _Node) -> None:
        """Detach one node and release its pages (no eviction counters:
        invalidate()/clear() are not pressure eviction)."""
        ps = self.pool.page_size
        parent = node.parent
        if parent is not None:
            parent.children.pop(tuple(node.tokens[:ps]), None)
            if parent is not self._root and not parent.children:
                self._leaves[parent] = None  # parent became a leaf
        self._release_pages(node.pages)
        self._n_pages -= len(node.pages)
        self._leaves.pop(node, None)
        node.parent = None

    def _evict_leaf(self) -> bool:
        """Release the least-recently-used leaf (O(1) via the recency-
        ordered leaf map)."""
        if not self._leaves:
            return False
        victim = next(iter(self._leaves))
        self.evictions += 1
        self.pages_evicted += len(victim.pages)
        self._remove(victim)
        return True

    def _evict_to_budget(self) -> None:
        """Enforce the page budget, PAGE-granular: the LRU leaf is trimmed
        from its tail rather than dropped whole, so a budget smaller than
        one stored run keeps the head of the shared prefix."""
        if self.max_pages is None:
            return
        ps = self.pool.page_size
        while self._n_pages > self.max_pages and self._leaves:
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
                victim.pages = victim.pages[:keep]
                victim.tokens = victim.tokens[: keep * ps]
                self._n_pages -= n

    def reclaim(self, pages_needed: int) -> bool:
        """Evict LRU leaves until the pool can satisfy `pages_needed`.
        Released pages only become free when no live sequence shares
        them, so eviction proceeds leaf by leaf and may legitimately
        fail."""
        while self.pool.free_pages < pages_needed:
            if not self._evict_leaf():
                return False
        return True

    def invalidate(self, key: str) -> None:
        """Drop `key`'s claim; free only nodes no other thread claims.

        Claimed nodes form root-anchored paths (store() claims every node
        it walks), so the traversal descends only children claiming `key`
        and unwinds iteratively.  Once any claim list has hit _KEYS_CAP the
        sweep covers the whole tree instead.
        """
        if self._claims_capped:
            order: List[_Node] = list(self._iter_nodes())
        else:
            stack = [c for c in self._root.children.values()
                     if key in c.keys]
            order = []
            while stack:
                node = stack.pop()
                order.append(node)
                stack.extend(c for c in node.children.values()
                             if key in c.keys)
        # preorder reversed: every node is processed before its ancestors,
        # so a freed leaf can cascade up its now-empty parents
        for node in reversed(order):
            node.keys.pop(key, None)
            if not node.children and not node.keys:
                self._remove(node)

    def clear(self) -> None:
        """Release everything (not counted as pressure eviction)."""
        for node in list(self._iter_nodes()):
            self.pool.release(node.pages)
        self._root = _Node([], [], None)
        self._n_pages = 0
        self._leaves = OrderedDict()
        self._page_retains = {}
