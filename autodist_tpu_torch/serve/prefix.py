"""Copy-on-write prefix sharing over the paged KV pool: the one radix home.

Ports the JAX package's ``serve/prefix.py`` (pure host Python; the port
keeps its own copy). Shared prefixes — system prompts, few-shot templates,
multi-turn history — map many page tables onto the same physical pages:

- **Blocks.** The tree is keyed by chained blake2b hashes of token blocks
  (one page's worth of tokens); every node stores its block's tokens, so a
  hash collision can never alias two prefixes onto one page.
- **Match + lease.** On admit the engine walks the prompt down the tree;
  each matched block maps onto the SAME physical page (refcount++ under a
  :class:`Lease`), and fresh pages are reserved only for the unmatched
  suffix. Matching is capped at ``(prompt_len - 1) // page_len`` full
  blocks, so at least the final prompt token always prefills and every
  live write lands after the shared region: shared pages are never
  written.
- **COW frontier.** When the prompt's next partial block shares a leading
  run with a cached child's block, the engine copies that child's page
  into the request's first exclusive page (a device page copy) and resumes
  prefill mid-page. :meth:`PrefixCache.acquire` pins the frontier node
  so eviction during the admission cannot reclaim the copy source.
- **Insert.** At prefill completion the request's fully-prompt-covered
  pages are adopted into the tree (refcount 1, on the request's lease).
- **Release + eviction.** Pages return to the pool only at refcount zero
  AND eviction: :meth:`PrefixCache.evict` reclaims LRU refcount-0 leaves
  under pool pressure and never a live request's page.

A speculative engine shares ONE tree across its target and draft pools:
each node carries a target page and, optionally, a draft page.

Thread contract: the tree mutates only on the scheduler thread; the
integer stats are safe to read from other threads.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "PrefixCache",
    "PrefixMatch",
    "Lease",
    "build_prefix_cache",
    "block_hashes",
    "selftest_prefix",
]

_DIGEST_SIZE = 16


def _chain(parent_digest: bytes, block: np.ndarray) -> bytes:
    """Chained block hash: commits to the whole prefix up to this block."""
    return hashlib.blake2b(parent_digest + block.tobytes(),
                           digest_size=_DIGEST_SIZE).digest()


def block_hashes(tokens, page_len: int,
                 limit: Optional[int] = None) -> List[str]:
    """Chained hashes of the full token blocks in ``tokens`` — the key
    space the radix tree indexes. ``limit`` caps the number of blocks
    hashed."""
    toks = np.asarray(tokens, np.int32).ravel()
    n_blocks = len(toks) // int(page_len)
    if limit is not None:
        n_blocks = min(n_blocks, int(limit))
    out: List[str] = []
    digest = b""
    for j in range(n_blocks):
        digest = _chain(digest, toks[j * page_len:(j + 1) * page_len])
        out.append(digest.hex())
    return out


class _RadixNode:
    """One cached block: a full page of KV for one token block.

    ``page`` (and ``draft_page`` when the tree spans a draft pool) stay
    in the pool's allocated set while the node lives — the tree owns
    them; ``refcount`` counts live requests leasing the page, and
    ``stamp`` is a logical LRU clock (deterministic — no wall time)."""

    __slots__ = ("digest", "tokens", "page", "draft_page", "parent",
                 "children", "refcount", "stamp")

    def __init__(self, digest: bytes, tokens: np.ndarray, page: int,
                 parent: "_RadixNode", draft_page: Optional[int] = None):
        self.digest = digest
        self.tokens = tokens
        self.page = int(page)
        self.draft_page = draft_page if draft_page is None else int(draft_page)
        self.parent = parent
        self.children: Dict[bytes, "_RadixNode"] = {}
        self.refcount = 0
        self.stamp = 0


@dataclass
class PrefixMatch:
    """Result of one prompt walk: what can be leased instead of computed.

    ``nodes`` are the matched full blocks root-down; ``tail_node`` /
    ``tail_len`` describe the COW frontier (the first ``tail_len`` tokens
    of ``tail_node``'s block match the prompt's next partial block);
    ``lookups`` is how many full blocks the walk attempted (the hit-rate
    denominator)."""

    nodes: List[_RadixNode] = field(default_factory=list)
    tail_node: Optional[_RadixNode] = None
    tail_len: int = 0
    lookups: int = 0

    @property
    def n_full(self) -> int:
        return len(self.nodes)

    @property
    def hit(self) -> bool:
        return bool(self.nodes) or self.tail_len > 0


@dataclass
class Lease:
    """A live request's claim on tree pages (matched at admit + adopted
    at insert). ``tail_node`` is the temporarily-pinned COW source —
    dropped via :meth:`PrefixCache.unpin_tail` once the copy landed."""

    nodes: List[_RadixNode] = field(default_factory=list)
    tail_node: Optional[_RadixNode] = None

    @property
    def pages(self) -> List[int]:
        return [nd.page for nd in self.nodes]

    @property
    def draft_pages(self) -> List[int]:
        return [nd.draft_page for nd in self.nodes
                if nd.draft_page is not None]


class PrefixCache:
    """Refcounted radix tree mapping token-block prefixes to pool pages.

    Owns no device arrays — like the page pool it is pure host
    bookkeeping; the engine performs the actual page-table prepends and
    the COW device copy. ``pool`` (and the optional paired ``draft_pool``)
    must be the same allocators the engine's tables draw from: adopted
    pages stay in the pool's allocated set until :meth:`evict` reclaims
    them, so physical utilization keeps counting shared pages exactly
    once.
    """

    def __init__(self, pool, page_len: int, draft_pool=None):
        self.pool = pool
        self.page_len = int(page_len)
        self.draft_pool = draft_pool
        self._root = _RadixNode(b"", np.zeros(0, np.int32), -1, None)
        #: page id -> owning node (every tree-owned target-pool page).
        self._owned: Dict[int, _RadixNode] = {}
        self._clock = 0
        # Stats (read by gauges from other threads; ints only).
        self.hits = 0            # full blocks served from the tree
        self.lookups = 0         # full blocks attempted
        self.evictions = 0       # nodes reclaimed under pressure
        self.inserts = 0         # pages adopted into the tree
        self.cow_copies = 0      # engine-reported frontier copies

    # ---------------------------------------------------------------- match
    def match(self, tokens) -> PrefixMatch:
        """Walk ``tokens`` down the tree. Caps full-block matching at
        ``(len - 1) // page_len`` so the final prompt token (at least)
        always prefills; then probes the divergence block for the longest
        partially-matching child (the COW frontier). Pure lookup — no
        refcounts move until :meth:`acquire`."""
        toks = np.asarray(tokens, np.int32).ravel()
        L = self.page_len
        limit = max(0, (len(toks) - 1) // L)
        m = PrefixMatch()
        node, digest = self._root, b""
        j = 0
        while j < limit:
            block = toks[j * L:(j + 1) * L]
            digest = _chain(digest, block)
            child = node.children.get(digest)
            if child is None or not np.array_equal(child.tokens, block):
                break
            m.nodes.append(child)
            node, j = child, j + 1
        m.lookups = min(limit, j + 1) if limit else 0
        self.lookups += m.lookups
        self.hits += len(m.nodes)
        # COW frontier: longest leading run of the next (partial) block
        # shared with a cached child. Never a full block — a full match
        # would have hash-matched above.
        t_max = min(L - 1, len(toks) - 1 - j * L)
        if t_max > 0:
            want = toks[j * L:j * L + t_max]
            best, best_len = None, 0
            for child in node.children.values():
                common = int(np.argmin(np.concatenate(
                    (child.tokens[:t_max] == want, [False]))))
                if common > best_len:
                    best, best_len = child, common
            if best is not None:
                m.tail_node, m.tail_len = best, best_len
        return m

    # ------------------------------------------------------------- leasing
    def acquire(self, m: PrefixMatch) -> Lease:
        """Refcount++ every matched node (and pin the COW frontier node so
        eviction during this admit's suffix allocation cannot reclaim the
        copy source). Pair with :meth:`release` (retire) or
        :meth:`cancel` (admission failed after match)."""
        self._clock += 1
        for nd in m.nodes:
            nd.refcount += 1
            nd.stamp = self._clock
        if m.tail_node is not None:
            m.tail_node.refcount += 1
            m.tail_node.stamp = self._clock
        return Lease(nodes=list(m.nodes), tail_node=m.tail_node)

    def unpin_tail(self, lease: Lease) -> None:
        """Drop the COW-source pin once the frontier copy landed (or was
        skipped)."""
        if lease.tail_node is not None:
            lease.tail_node.refcount -= 1
            lease.tail_node = None

    def cancel(self, lease: Lease) -> None:
        """Admission fell through after :meth:`acquire`: roll every
        refcount back (including the tail pin)."""
        self.unpin_tail(lease)
        for nd in lease.nodes:
            nd.refcount -= 1
        lease.nodes = []

    def release(self, lease: Lease) -> None:
        """Retire a request's claim. Pages stay tree-owned (cached) at
        refcount zero — only :meth:`evict` returns them to the pool."""
        self.unpin_tail(lease)
        for nd in lease.nodes:
            nd.refcount -= 1
            if nd.refcount < 0:
                raise ValueError(
                    f"prefix refcount underflow on page {nd.page}")
        lease.nodes = []

    # -------------------------------------------------------------- insert
    def insert(self, tokens, pages: List[int], lease: Lease,
               draft_pages: Optional[List[int]] = None) -> int:
        """Adopt the request's novel fully-prompt-covered blocks into the
        tree (called once, when its prefill completes). ``pages`` is the
        request's page list in timeline order; block ``j`` is adoptable
        only when the whole page holds prompt KV (``(j+1) * page_len <=
        len(tokens)``) — pages that will take decode/verify writes are
        never shared. Already-present blocks are skipped (the request
        keeps its exclusive page; a concurrent duplicate prefill loses
        the adoption race harmlessly). Adopted nodes join ``lease`` at
        refcount 1. Returns pages adopted."""
        toks = np.asarray(tokens, np.int32).ravel()
        L = self.page_len
        n_full = len(toks) // L
        self._clock += 1
        node, digest, adopted = self._root, b"", 0
        for j in range(n_full):
            block = toks[j * L:(j + 1) * L]
            digest = _chain(digest, block)
            child = node.children.get(digest)
            if child is not None and np.array_equal(child.tokens, block):
                child.stamp = self._clock
                node = child
                continue
            page = pages[j]
            if page in self._owned:      # defensive: never double-own
                break  # pragma: no cover - unreachable by contract
            draft_page = (draft_pages[j] if draft_pages is not None
                          and j < len(draft_pages) else None)
            child = _RadixNode(digest, block.copy(), page, node,
                               draft_page=draft_page)
            child.refcount = 1
            child.stamp = self._clock
            node.children[digest] = child
            self._owned[page] = child
            lease.nodes.append(child)
            node = child
            adopted += 1
        self.inserts += adopted
        return adopted

    # ------------------------------------------------------------- eviction
    def evict(self, n_pages: int) -> int:
        """Reclaim up to ``n_pages`` target-pool pages from cold leaves,
        LRU-first. Only refcount-0 LEAVES are candidates — a live
        request's pages (refcount > 0) and interior nodes (a child still
        commits to them) are untouchable, so eviction can only ever cost
        a future admission a recompute. Returns target pages reclaimed."""
        freed = 0
        while freed < n_pages:
            victim = None
            for nd in self._owned.values():
                if nd.refcount == 0 and not nd.children and (
                        victim is None or nd.stamp < victim.stamp):
                    victim = nd
            if victim is None:
                break
            self._drop(victim)
            freed += 1
        return freed

    def _drop(self, nd: _RadixNode) -> None:
        del nd.parent.children[nd.digest]
        del self._owned[nd.page]
        self.pool.reclaim([nd.page])
        if nd.draft_page is not None and self.draft_pool is not None:
            self.draft_pool.reclaim([nd.draft_page])
        self.evictions += 1

    def purge(self) -> int:
        """Evict EVERY refcount-0 block (leaves first, repeatedly) — the
        drain-time leak check: after purge, a balanced system's pools are
        back to empty. Returns pages reclaimed."""
        total = 0
        while True:
            freed = self.evict(len(self._owned) or 1)
            total += freed
            if freed == 0:
                return total

    # ------------------------------------------------------------ accounting
    @property
    def cached_pages(self) -> int:
        """Tree-owned target-pool pages (shared + cold)."""
        return len(self._owned)

    @property
    def shared_pages(self) -> int:
        """Tree pages currently leased by at least one live request —
        the ``serve_prefix_shared_pages`` gauge."""
        return sum(1 for nd in self._owned.values() if nd.refcount > 0)

    @property
    def live_refcount(self) -> int:
        """Sum of refcounts — zero at drain when every lease balanced."""
        return sum(nd.refcount for nd in self._owned.values())

    @property
    def hit_rate(self) -> float:
        """Block-level hit rate since construction, 0..1."""
        return self.hits / self.lookups if self.lookups else 0.0

    def stats(self) -> Dict[str, float]:
        return {
            "hit_rate": self.hit_rate,
            "hits": self.hits,
            "lookups": self.lookups,
            "cached_pages": self.cached_pages,
            "shared_pages": self.shared_pages,
            "evictions": self.evictions,
            "inserts": self.inserts,
            "cow_copies": self.cow_copies,
            "live_refcount": self.live_refcount,
        }


def build_prefix_cache(pool, page_len: int, draft_pool=None) -> PrefixCache:
    """The one constructor call sites use."""
    return PrefixCache(pool, page_len, draft_pool=draft_pool)




def selftest_prefix(max_new: int = 8, seed: int = 0) -> int:
    """The ``--selftest-prefix`` CPU proof; returns an exit code. On a
    system-prompt-heavy workload (96 shared tokens, 12 full blocks, plus an
    8-token suffix a request), at equal pool bytes (43 pages of 8):

    - streams equal to the sharing-off engine's on every path: cold insert,
      warm match, a mid-page copy-on-write divergence, and concurrent joins
      through the continuous batcher (cached admissions flagged);
    - a cached admission prefills >= 5x fewer chunks (1 against 13); the
      admit-to-first-token wall of both is reported;
    - >= 2x the admitted concurrency (the shared chain maps once);
    - refcounts back to zero and ``purge()`` returning every page;
    - a speculative engine whose draft pool shares the tree: streams equal,
      hits on the warm pass, both pools balanced after a purge.
    """
    import json
    import time

    from autodist_tpu_torch import metrics as M
    from autodist_tpu_torch.serve.batcher import ContinuousBatcher, RequestState
    from autodist_tpu_torch.serve.engine import AdmissionDenied
    from autodist_tpu_torch.serve.spec import SelftestRig, pools_balanced

    t_start = time.monotonic()
    rng = np.random.default_rng(seed)
    rig = SelftestRig(n_pages=43, draft_n_pages=43, max_seq_len=128)
    build = dict(n_slots=16, max_len=112)
    base = rig.engine(**build)
    shared = rig.engine(prefix_cache=True, **build)
    cache = shared.prefix_cache
    system = rng.integers(1, 128, size=96).astype(np.int32)

    def prompt_with_suffix():
        return np.concatenate([system, rng.integers(1, 128, size=8)]).astype(np.int32)

    prompts = [prompt_with_suffix() for _ in range(12)]
    expected = [base.generate(p, max_new) for p in prompts]
    parity_cold = [shared.generate(p, max_new) for p in prompts] == expected
    hits_after_cold = cache.hits
    parity_warm = [shared.generate(p, max_new) for p in prompts] == expected
    warm_hit = cache.hits > hits_after_cold

    cow_before = cache.cow_copies
    cow_prompt = np.concatenate([prompts[0][:100],
                                 rng.integers(1, 128, size=4)]).astype(np.int32)
    cow_parity = shared.generate(cow_prompt, max_new) == base.generate(cow_prompt, max_new)
    cow_seen = cache.cow_copies > cow_before

    def ttft(engine, n=9):
        walls, chunks = [], []
        for _ in range(n):
            before = engine.prefill_invocations
            t0 = time.perf_counter()
            slot = engine.admit(prompt_with_suffix(), max_new)
            if isinstance(slot, AdmissionDenied):
                raise RuntimeError(f"selftest admit denied: {slot.reason}")
            while engine.prefill_step(slot) is None:
                pass
            walls.append(time.perf_counter() - t0)
            chunks.append(engine.prefill_invocations - before)
            engine.release(slot)
        return sorted(walls)[n // 2], sorted(chunks)[n // 2]

    ttft_off, chunks_off = ttft(base)
    ttft_on, chunks_on = ttft(shared)

    def admitted(engine):
        slots = []
        while not isinstance(s := engine.admit(prompt_with_suffix(), max_new),
                             AdmissionDenied):
            slots.append(s)
        for s in slots:
            engine.release(s)
        return len(slots)

    conc_off, conc_on = admitted(base), admitted(shared)

    with ContinuousBatcher(shared, max_queue=32,
                           registry=M.MetricsRegistry()) as batcher:
        reqs = [batcher.submit(prompts[i % 12], max_new) for i in range(24)]
        batch_done = all(r.wait(120.0).state is RequestState.DONE for r in reqs)
    batch_parity = all(r.tokens == expected[i % 12] for i, r in enumerate(reqs))
    cached_seen = any(r.cached for r in reqs)

    drained = (cache.live_refcount == 0
               and shared.pool.used_pages == cache.cached_pages)
    cache.purge()
    leak_free = pools_balanced(shared) and pools_balanced(base)

    spec = rig.spec_engine(4, same_draft=True, prefix_cache=True, **build)
    spec_parity = ([spec.generate(p, max_new) for p in prompts[:4]] == expected[:4]
                   and [spec.generate(p, max_new) for p in prompts[:4]] == expected[:4])
    spec_hits = spec.prefix_cache.hits > 0
    spec.prefix_cache.purge()
    spec_balanced = pools_balanced(spec)

    ok = (parity_cold and parity_warm and warm_hit and cow_parity and cow_seen
          and chunks_off >= 5 * chunks_on and conc_on >= 2 * conc_off
          and batch_done and batch_parity and cached_seen and drained
          and leak_free and spec_parity and spec_hits and spec_balanced)
    print(json.dumps({
        "selftest": "autodist_tpu_torch.serve.prefix", "ok": bool(ok),
        "prefill_chunks_uncached": chunks_off, "prefill_chunks_cached": chunks_on,
        "ttft_uncached_p50_s_cpu": ttft_off, "ttft_cached_p50_s_cpu": ttft_on,
        "admitted_sharing_off": conc_off, "admitted_sharing_on": conc_on,
        "parity_cold": parity_cold, "parity_warm": parity_warm,
        "cow_parity": cow_parity, "cow_copies": cache.cow_copies,
        "batch_done": batch_done, "batch_parity": batch_parity,
        "cached_requests_seen": cached_seen, "hit_rate": cache.hit_rate,
        "refcounts_drained": drained, "pages_leak_free": leak_free,
        "spec_parity": spec_parity, "spec_balanced": spec_balanced,
        "duration_s": round(time.monotonic() - t_start, 1)}))
    return 0 if ok else 1
