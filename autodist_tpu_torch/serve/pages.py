"""Paged KV-cache bookkeeping: the ONE page-table/pool allocator home.

A port of the JAX package's ``serve/pages.py`` (pure host arithmetic; the
chaos hooks are left out). The serving engine's decode state is a single
fixed-size pool of KV pages (device tensors ``[layers, n_pages, page_len,
heads, head_dim]``, owned by
:class:`~autodist_tpu_torch.serve.engine.InferenceEngine`); WHICH pages
belong to WHICH request is host arithmetic, and it all lives here.

Page 0 is a reserved **scratch page** that is never allocated: page tables
are padded to a static length with it, so a request's pad entries (and idle
decode rows) scatter/gather against scratch instead of a live request's
pages.
"""
from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np

__all__ = [
    "DEFAULT_PAGE_LEN",
    "SCRATCH_PAGE",
    "PagePool",
    "PageTable",
    "build_pool",
    "pages_for_tokens",
    "pool_size_from_device",
]

DEFAULT_PAGE_LEN = 16
#: Reserved page index — never allocated, pads every page table.
SCRATCH_PAGE = 0


def pages_for_tokens(n_tokens: int, page_len: int) -> int:
    """Pages needed to hold ``n_tokens`` timeline tokens (ceil division)."""
    return max(1, -(-int(n_tokens) // int(page_len)))


class PageTable:
    """One request's page list: ``capacity`` timeline tokens of KV rows.

    Token position ``p`` lives at device page ``pages[p // page_len]``,
    offset ``p % page_len``. :meth:`padded` renders the static-shape int32
    row the compiled programs consume (pad entries point at scratch).
    """

    __slots__ = ("pages", "page_len")

    def __init__(self, pages: List[int], page_len: int):
        self.pages = list(pages)
        self.page_len = int(page_len)

    @property
    def capacity(self) -> int:
        """Timeline tokens these pages can hold."""
        return len(self.pages) * self.page_len

    def padded(self, max_pages: int) -> np.ndarray:
        """Static ``[max_pages]`` int32 row, padded with the scratch page."""
        row = np.full(max_pages, SCRATCH_PAGE, np.int32)
        row[: len(self.pages)] = self.pages
        return row

    def rewind(self, n_tokens: int) -> List[int]:
        """Truncate to the pages an ``n_tokens`` timeline needs, returning
        the freed tail page ids (caller hands them to
        :meth:`PagePool.reclaim` — or use :meth:`PagePool.rewind`, which
        does both under the pool lock). The speculative-decode rollback
        path: a rejected draft rewinds the slot's timeline, and the pages
        reserved past the accepted length go straight back to the pool —
        a rejection never leaks pages (docs/serving.md § speculative
        decode). ``n_tokens <= 0`` frees everything."""
        keep = 0 if n_tokens <= 0 else pages_for_tokens(n_tokens, self.page_len)
        keep = min(keep, len(self.pages))
        freed, self.pages = self.pages[keep:], self.pages[:keep]
        return freed

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"PageTable(pages={self.pages}, page_len={self.page_len})"


class PagePool:
    """Fixed pool of KV pages with LIFO recycling.

    Thread-safe (``alloc``/``release`` may race between a scheduler thread
    and a draining controller); allocation is all-or-nothing — a request
    either gets every page its ``prompt + max_new_tokens`` timeline needs
    or ``None`` (the batcher keeps it queued until retirement recycles
    pages). Page 0 (scratch) is never handed out.
    """

    def __init__(self, n_pages: int, page_len: int,
                 quantized: bool = False,
                 bytes_per_page: float = 0.0,
                 fp_equiv_bytes_per_page: float = 0.0):
        if n_pages < 2:
            raise ValueError(f"pool needs >=2 pages (1 scratch + >=1 "
                             f"allocatable), got {n_pages}")
        self.n_pages = int(n_pages)
        self.page_len = int(page_len)
        # Quantized pool mode (int8 pages + f32 scale planes): the device
        # tensors hold the scales; the pool carries the byte split so the
        # serve gauges can account physical vs fp-equivalent capacity from
        # one place. bytes_per_page is the
        # PHYSICAL page (int8 + scales when quantized); fp_equiv is what
        # the same page would cost at the model's fp cache dtype.
        self.quantized = bool(quantized)
        self.bytes_per_page = float(bytes_per_page)
        self.fp_equiv_bytes_per_page = float(fp_equiv_bytes_per_page)
        self._lock = threading.Lock()
        # LIFO free list: recycled pages are reused first (warm HBM rows).
        self._free = list(range(self.n_pages - 1, SCRATCH_PAGE, -1))
        self._allocated: set = set()

    # ------------------------------------------------------------- accounting
    @property
    def physical_bytes(self) -> float:
        """Pool HBM footprint as allocated (0 when bytes not stamped)."""
        return self.bytes_per_page * self.n_pages

    @property
    def fp_equiv_bytes(self) -> float:
        """What the pool's KV capacity would cost in fp pages — the
        quantization win's numerator (== physical when not quantized)."""
        return self.fp_equiv_bytes_per_page * self.n_pages

    @property
    def quant_capacity_x(self) -> float:
        """Effective-capacity multiplier from quantization: fp-equivalent
        bytes per physical byte (1.0 when fp or bytes unstamped)."""
        if self.bytes_per_page <= 0.0 or not self.quantized:
            return 1.0
        return self.fp_equiv_bytes_per_page / self.bytes_per_page

    @property
    def usable_pages(self) -> int:
        """Allocatable pages (total minus the scratch page)."""
        return self.n_pages - 1

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_pages(self) -> int:
        with self._lock:
            return len(self._allocated)

    @property
    def utilization(self) -> float:
        """Allocated fraction of the usable pool, 0..1."""
        return self.used_pages / max(self.usable_pages, 1)

    @property
    def allocated_tokens(self) -> int:
        """Timeline capacity currently reserved (pages * page_len) — the
        admission budget's currency."""
        return self.used_pages * self.page_len

    def fragmentation(self, written_tokens: int) -> float:
        """Internal fragmentation: the fraction of reserved timeline slots
        not (yet) holding a real token — tail waste inside part-filled
        pages plus capacity reserved for tokens not yet decoded."""
        alloc = self.allocated_tokens
        if alloc <= 0:
            return 0.0
        return max(0.0, 1.0 - float(written_tokens) / alloc)

    # ------------------------------------------------------------- allocation
    def alloc(self, n_tokens: int) -> Optional[PageTable]:
        """Reserve pages for an ``n_tokens`` timeline, or None when the
        pool cannot cover it (all-or-nothing)."""
        need = pages_for_tokens(n_tokens, self.page_len)
        with self._lock:
            if need > len(self._free):
                return None
            got = [self._free.pop() for _ in range(need)]
            self._allocated.update(got)
        return PageTable(got, self.page_len)

    def extend(self, table: PageTable, n_tokens: int) -> bool:
        """Grow ``table`` so it covers an ``n_tokens`` timeline.

        All-or-nothing like :meth:`alloc`. Returns
        True when the table already covers ``n_tokens`` or the extension
        landed; False when the pool cannot supply the extra pages — the
        caller degrades (speculative drafting shortens or stops) rather
        than blocks: extension is a *best-effort* growth path, never part
        of the admission liveness contract."""
        need = pages_for_tokens(n_tokens, self.page_len) - len(table.pages)
        if need <= 0:
            return True
        with self._lock:
            if need > len(self._free):
                return False
            got = [self._free.pop() for _ in range(need)]
            self._allocated.update(got)
        table.pages.extend(got)
        return True

    def reclaim(self, pages: List[int]) -> None:
        """Return specific page ids to the free list (the
        :meth:`PageTable.rewind` tail). Validates each was allocated —
        the same double-free refusal :meth:`release` keeps."""
        with self._lock:
            for p in pages:
                if p not in self._allocated:
                    raise ValueError(f"reclaim of unallocated page {p}")
                self._allocated.discard(p)
                self._free.append(p)

    def rewind(self, table: PageTable, n_tokens: int) -> int:
        """Truncate ``table`` to an ``n_tokens`` timeline and reclaim the
        freed tail in one step. Returns how many pages were freed."""
        freed = table.rewind(n_tokens)
        if freed:
            self.reclaim(freed)
        return len(freed)

    def release(self, table: PageTable) -> None:
        """Recycle a table's pages; immediately reallocatable."""
        with self._lock:
            for p in table.pages:
                if p not in self._allocated:
                    raise ValueError(f"double free of page {p}")
                self._allocated.discard(p)
                self._free.append(p)
        table.pages = []


def build_pool(n_pages: int, page_len: int = DEFAULT_PAGE_LEN,
               quantized: bool = False,
               bytes_per_page: float = 0.0,
               fp_equiv_bytes_per_page: float = 0.0) -> PagePool:
    """The one constructor call sites use."""
    return PagePool(n_pages, page_len, quantized=quantized,
                    bytes_per_page=bytes_per_page,
                    fp_equiv_bytes_per_page=fp_equiv_bytes_per_page)


def pool_size_from_device(
    device,
    bytes_per_page: float,
    params_bytes: float = 0.0,
    headroom: float = 0.8,
    serve_frac: float = 0.5,
    max_useful_pages: Optional[int] = None,
    min_useful_pages: int = 1,
) -> int:
    """Page count (INCLUDING the scratch page) from the card's memory.

    ``serve_frac`` of the usable memory left after the resident params
    funds the KV pool; the card's total memory comes from
    ``torch.cuda.get_device_properties(device).total_memory`` (where the
    JAX package read ``resource_spec.tpu.hbm_bytes``).
    ``max_useful_pages`` caps at the point more pages cannot help (every
    decode row at the full ``max_len`` timeline); ``min_useful_pages``
    floors at a functioning pool.
    """
    import torch

    capacity = float(torch.cuda.get_device_properties(device).total_memory)
    budget = max(0.0, capacity * headroom - float(params_bytes)) * serve_frac
    n = int(budget // max(float(bytes_per_page), 1.0))
    if max_useful_pages is not None:
        n = min(n, int(max_useful_pages))
    n = max(n, int(min_useful_pages))
    return n + 1  # + the reserved scratch page
