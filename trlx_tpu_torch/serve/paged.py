"""Host side of the paged KV cache: free-list page allocator + radix-tree
prefix cache.

The device half (trlx_tpu_torch.models.generation / transformer ``block_apply``
paged mode) is shape-static and dumb on purpose: it scatters/gathers
through whatever per-slot page tables it is handed. ALL policy lives
here, in plain-python structures the scheduler thread owns exclusively:

- :class:`PageAllocator` — a free list over ``num_pages`` fixed-size KV
  pages plus per-page refcounts (number of live slots whose table maps
  the page). ``alloc`` never blocks and never raises on pressure: it
  returns ``None``, and the scheduler leaves the request QUEUED (the
  exhaustion -> queue-not-crash contract). Refcounts are guarded — a
  release below zero is a real bookkeeping bug and raises.
- :class:`RadixCache` — vLLM's block pool crossed with SGLang's
  RadixAttention (Zheng et al., 2023), rebuilt block-granular: a trie
  over ``page_size``-token blocks of COMMITTED prompts, each node owning
  the physical page that holds that block's KV. Admission walks the
  prompt's full blocks through the trie; every hit page is refcounted
  and mapped copy-free into the new slot's page table, and only the
  unmatched suffix is prefilled. Matches are capped one token short of
  the prompt (``(len - 1) // page_size`` blocks) so at least one suffix
  token always runs — the first-step logits must come from a real
  forward. Pages whose refcount is 0 but that the trie still owns are
  *cached*, not free: when ``alloc`` runs dry it evicts refcount-0 LEAF
  nodes in LRU order (evicting an interior node would orphan its
  descendants' prefixes) until the request fits or nothing evictable
  remains.

Commit happens at ADMISSION, not harvest: the pages of the suffix a
request is about to prefill enter the trie immediately, so later
requests in the very same admission batch (and every batch after) hit
them. That is sound because the device program scatters each layer's
fresh K/V *before* the attention gather reads it — a same-batch sharer's
gather sees the owner row's writes — and because committed-but-pending
pages always carry refcount >= 1 (the owner slot), so they cannot be
evicted before their content lands. A failed prefill rolls the inserted
nodes back (:meth:`RadixCache.rollback`).

Everything here is nanosecond-scale dict/list work on the scheduler
thread — no torch, no device syncs. The allocator's free list and
refcounts carry their own mutex (``/healthz`` reads them from the HTTP
thread); the radix trie itself stays worker-confined.
"""

import threading
from typing import Dict, List, Optional, Sequence, Tuple

from trlx_tpu_torch import telemetry


class PageAllocator:
    """Free-list allocator + refcounts for a fixed pool of KV pages."""

    def __init__(self, num_pages: int):
        if num_pages <= 0:
            raise ValueError(f"num_pages={num_pages} must be >= 1")
        self.num_pages = num_pages
        self._lock = threading.Lock()
        # LIFO free list: recently-freed pages are reused first (their
        # HBM is warm, and reuse order is deterministic for tests)
        self._free: List[int] = list(range(num_pages - 1, -1, -1))  # guarded-by: _lock
        self._ref: List[int] = [0] * num_pages  # guarded-by: _lock

    def free_count(self) -> int:
        # read under the lock: /healthz calls this from the HTTP thread
        # while alloc/free resize the list
        with self._lock:
            return len(self._free)

    def refcount(self, page: int) -> int:
        return self._ref[page]

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` fresh pages at refcount 1, or ``None`` when the free
        list cannot cover them (caller decides whether to evict/queue —
        never partial, never raising)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        with self._lock:
            if n > len(self._free):
                return None
            pages = [self._free.pop() for _ in range(n)]
            for p in pages:
                self._ref[p] = 1
        return pages

    def retain(self, page: int) -> None:
        with self._lock:
            self._ref[page] += 1

    def release(self, page: int) -> int:
        """Drop one reference; returns the new refcount. A page at
        refcount 0 is NOT auto-freed — the radix cache may still own it
        (cached, evictable); :meth:`free_page` returns it to the list."""
        with self._lock:
            ref = self._ref[page] - 1
            if ref < 0:
                raise RuntimeError(
                    f"page {page} released below refcount 0 — allocator "
                    f"bookkeeping bug (double free)"
                )
            self._ref[page] = ref
        return ref

    def free_page(self, page: int) -> None:
        with self._lock:
            if self._ref[page] != 0:
                raise RuntimeError(
                    f"page {page} freed at refcount {self._ref[page]} "
                    f"(> 0)"
                )
            self._free.append(page)


class _Node:
    """One committed token block: ``key`` (the block's tokens) under its
    parent, owning physical ``page``."""

    __slots__ = ("key", "page", "parent", "children", "last_used")

    def __init__(self, key, page, parent):
        self.key: Tuple[int, ...] = key
        self.page: int = page
        self.parent: Optional["_Node"] = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0


class RadixCache:
    """Block-granular radix tree over committed prompt pages + the
    allocator they live in. The scheduler's one-stop paged-KV broker:
    ``match`` -> ``alloc`` -> ``commit`` at admission, ``release_all`` at
    harvest, ``evict`` under pressure (called by ``alloc`` itself)."""

    def __init__(self, num_pages: int, page_size: int):
        if page_size <= 0:
            raise ValueError(f"page_size={page_size} must be >= 1")
        self.allocator = PageAllocator(num_pages)
        self.page_size = page_size
        self._root = _Node((), -1, None)
        self._node_of_page: Dict[int, _Node] = {}
        self._clock = 0  # LRU tick (monotonic per-operation counter)
        self.evicted_pages = 0  # lifetime counter (telemetry mirrors it)

    # -- introspection ---------------------------------------------------

    def cached_pages(self) -> int:
        """Pages the trie owns (committed blocks, hit-able)."""
        return len(self._node_of_page)

    def free_pages(self) -> int:
        return self.allocator.free_count()

    # -- prefix match ----------------------------------------------------

    def match(self, tokens: Sequence[int]) -> List[int]:
        """Longest committed prefix of ``tokens`` in whole blocks, capped
        at ``(len(tokens) - 1) // page_size`` so >= 1 suffix token always
        remains to prefill. Every returned page is RETAINED for the
        caller (release via :meth:`release_all` at harvest) and
        LRU-touched."""
        ps = self.page_size
        max_blocks = max(len(tokens) - 1, 0) // ps
        self._clock += 1
        node = self._root
        pages: List[int] = []
        for i in range(max_blocks):
            child = node.children.get(tuple(tokens[i * ps:(i + 1) * ps]))
            if child is None:
                break
            child.last_used = self._clock
            self.allocator.retain(child.page)
            pages.append(child.page)
            node = child
        return pages

    def peek_continuation(self, tokens: Sequence[int], k: int) -> List[int]:
        """Read-only speculation probe: up to ``k`` tokens that committed
        prompts continued ``tokens`` with. Walks the trie by whole
        blocks, finishes a partial tail block from a prefix-matching
        child, then follows child chains. Touches NOTHING — no
        refcounts, no LRU clock — so a wrong guess costs only the
        verify pass that rejects it."""
        ps = self.page_size
        node = self._root
        blocks = len(tokens) // ps
        for i in range(blocks):
            child = node.children.get(tuple(tokens[i * ps:(i + 1) * ps]))
            if child is None:
                return []
            node = child
        out: List[int] = []
        tail = tuple(tokens[blocks * ps:])
        if tail:
            nxt = None
            for key, child in node.children.items():
                if key[:len(tail)] == tail:
                    nxt = child
                    break
            if nxt is None:
                return []
            out.extend(nxt.key[len(tail):])
            node = nxt
        while len(out) < k and node.children:
            node = next(iter(node.children.values()))
            out.extend(node.key)
        return out[:k]

    # -- allocation + eviction -------------------------------------------

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` pages at refcount 1, evicting LRU refcount-0 cached
        leaves as needed; ``None`` (nothing allocated, nothing evicted
        beyond what was already needed) when even full eviction cannot
        cover the request."""
        short = n - self.allocator.free_count()
        if short > 0 and self.evict(short) < short:
            return None
        return self.allocator.alloc(n)

    def evict(self, n: int) -> int:
        """Evict up to ``n`` refcount-0 LEAF nodes, least-recently-used
        first, returning their pages to the free list. Returns how many
        were actually evicted. Interior nodes become leaves as their
        children go, so repeated passes walk chains root-ward."""
        evicted = 0
        while evicted < n:
            victim = None
            for page, node in self._node_of_page.items():
                if node.children or self.allocator.refcount(page) != 0:
                    continue
                if victim is None or node.last_used < victim.last_used:
                    victim = node
            if victim is None:
                break
            self._remove_node(victim)
            self.allocator.free_page(victim.page)
            evicted += 1
        if evicted:
            self.evicted_pages += evicted
            telemetry.inc("serve/evicted_pages", evicted)
        return evicted

    def _remove_node(self, node: _Node) -> None:
        del node.parent.children[node.key]
        del self._node_of_page[node.page]

    # -- commit / rollback / release -------------------------------------

    def commit(self, tokens: Sequence[int],
               pages: Sequence[int]) -> List[int]:
        """Insert ``tokens``' full blocks (``len // page_size``) into the
        trie, block i living on ``pages[i]`` (the slot's page table:
        matched prefix pages first, then the fresh suffix pages). Blocks
        already present keep their existing page — a racing duplicate
        page simply never enters the trie and frees at harvest. Returns
        the newly inserted pages (the rollback handle for a failed
        prefill)."""
        ps = self.page_size
        self._clock += 1
        node = self._root
        inserted: List[int] = []
        for i in range(len(tokens) // ps):
            key = tuple(tokens[i * ps:(i + 1) * ps])
            child = node.children.get(key)
            if child is None:
                child = _Node(key, pages[i], node)
                node.children[key] = child
                self._node_of_page[pages[i]] = child
                inserted.append(pages[i])
            child.last_used = self._clock
            node = child
        return inserted

    def rollback(self, inserted: Sequence[int]) -> None:
        """Un-commit pages a failed prefill never filled (deepest first,
        so parents are leaves by the time they go). Refcounts are the
        caller's to release — this only detaches the trie nodes."""
        for page in reversed(list(inserted)):
            node = self._node_of_page.get(page)
            if node is not None and not node.children:
                self._remove_node(node)

    def release_all(self, pages: Sequence[int]) -> None:
        """Harvest path: drop one reference per page; pages at refcount 0
        return to the free list unless the trie still owns them (then
        they stay cached/evictable)."""
        for page in pages:
            if self.allocator.release(page) == 0 \
                    and page not in self._node_of_page:
                self.allocator.free_page(page)
