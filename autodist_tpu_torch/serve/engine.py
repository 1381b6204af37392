"""Paged KV-cache inference engine (PyTorch port, one card).

Ports the paged :class:`InferenceEngine` of the JAX package's
``serve/engine.py``. Decode state is ONE fixed pool of ``[layers, n_pages,
page_len, heads, head_dim]`` device pages, sized from the card's memory,
with per-request page tables (host int32 rows, ``serve/pages.py``) padded to
a static width. Two programs serve every request-length mix: one decode step
over every slot row, and one fixed-size prefill chunk — long prompts prefill
chunk by chunk, interleaved with decode ticks by the batcher. Admission
reserves pages all-or-nothing; retirement recycles them in the same tick.

What differs from the JAX engine: there is no sharding plan or mesh — on one
card the params are a dict of tensors on ``device``, which is what
``AllReduce`` gives on one chip. PyTorch runs eagerly, so nothing compiles;
the cache is updated in place by the forwards (the JAX engine donates it
through its compiled programs to the same effect).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from autodist_tpu_torch.serve import pages as serve_pages
from autodist_tpu_torch.serve import sampling as serve_sampling
from autodist_tpu_torch.utils.device import resolve_device

#: Slot phases (host bookkeeping; single scheduler-thread writer).
_FREE, _PREFILL, _DECODE = 0, 1, 2


class EngineDeadError(RuntimeError):
    """The inference engine can no longer decode. The batcher catches this
    specifically and sheds all load with typed REJECTED results instead of
    hanging clients."""


@dataclass
class DecodeModel:
    """Model adapter for autoregressive paged decode — functions bound to one
    config:

    - ``init_paged_cache(n_pages, page_len, device) -> cache`` dict of
      tensors carrying the page dim at dim 1;
    - ``prefill_chunk(params, tokens [1,C], start, length, cache,
      page_table [P]) -> (next_token [1], cache)``;
    - ``decode_paged(params, tokens [B], positions [B], cache,
      page_tables [B,P]) -> (next_token [B], cache)`` with ``B == n_slots``.

    ``eos_id``: generation stops when emitted (None = length-only);
    ``max_len``: the model's positional ceiling; ``fp_cache_dtype``: the fp
    page dtype that int8 pages are priced against.
    """

    init_paged_cache: Callable[..., Any]
    prefill_chunk: Callable[..., Tuple[Any, Any]]
    decode_paged: Callable[..., Tuple[Any, Any]]
    eos_id: Optional[int] = None
    max_len: Optional[int] = None
    fp_cache_dtype: Any = torch.bfloat16


@dataclass(frozen=True)
class Slot:
    """One occupied decode row — index into the static decode batch."""

    index: int


@dataclass(frozen=True)
class AdmissionDenied:
    """Typed admission outcome: WHY a request was not placed, and whether
    waiting can ever help (``retryable``: pool or rows exhausted — the
    batcher keeps it queued; not retryable: over the static ceiling — the
    batcher finishes it REJECTED)."""

    reason: str
    retryable: bool


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


class InferenceEngine:
    """Serve a model with paged continuous-batching decode:
    ``admit``/``prefill_step``/``step``/``release``.

    Scheduler-free by design: the
    :class:`~autodist_tpu_torch.serve.batcher.ContinuousBatcher` owns
    queueing, deadlines, prefill/decode interleaving and retirement; the
    engine owns device state. All decode-state methods must be called from
    one scheduler thread (the page pool itself is locked so accounting reads
    from other threads stay coherent).
    """

    def __init__(
        self,
        params: Any,
        decode_model: DecodeModel,
        n_slots: int = 8,
        page_len: int = serve_pages.DEFAULT_PAGE_LEN,
        n_pages: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        max_len: Optional[int] = None,
        serve_hbm_frac: float = 0.5,
        device=None,
    ):
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.decode_model = decode_model
        self.n_slots = int(n_slots)
        self.page_len = int(page_len)
        self.prefill_chunk = int(prefill_chunk or page_len)
        # Static timeline ceiling: the positional limit rounded DOWN to a
        # multiple of lcm(page_len, chunk) — every chunk's pad positions stay
        # inside the static page-table width.
        ceiling = min(
            x for x in (max_len, decode_model.max_len) if x is not None
        ) if (max_len or decode_model.max_len) else 1024
        quantum = math.lcm(self.page_len, self.prefill_chunk)
        self.max_len = (int(ceiling) // quantum) * quantum
        if self.max_len <= 0:
            raise ValueError(
                f"max_len {ceiling} cannot fit one page_len={page_len} x "
                f"prefill_chunk={self.prefill_chunk} quantum ({quantum})")
        self.max_pages = self.max_len // self.page_len

        # Pool sizing: explicit n_pages wins; on CUDA the card's memory funds
        # it (capped at every row at the full timeline). Per-page bytes come
        # from the model's own cache on the meta device (nothing allocated).
        page_shaped = decode_model.init_paged_cache(1, self.page_len, device="meta")
        page_bytes = _tree_bytes(page_shaped)
        self.page_bytes = page_bytes
        self.kv_quant = "k_scale" in page_shaped
        if self.kv_quant:
            fp_itemsize = torch.empty((), dtype=decode_model.fp_cache_dtype).element_size()
            self.page_fp_equiv_bytes = sum(
                leaf.numel() * fp_itemsize for name, leaf in page_shaped.items()
                if not name.endswith("_scale"))
        else:
            self.page_fp_equiv_bytes = page_bytes
        max_useful = self.n_slots * self.max_pages
        if n_pages is None:
            if self.device.type == "cuda":
                n_pages = serve_pages.pool_size_from_device(
                    self.device, page_bytes, params_bytes=_tree_bytes(self.params),
                    serve_frac=serve_hbm_frac, max_useful_pages=max_useful,
                    min_useful_pages=self.max_pages)
            else:
                n_pages = max_useful + 1
        n_pages = max(int(n_pages), self.max_pages + 1)
        self.pool = serve_pages.build_pool(
            n_pages, self.page_len, quantized=self.kv_quant,
            bytes_per_page=float(page_bytes),
            fp_equiv_bytes_per_page=float(self.page_fp_equiv_bytes))
        self._cache = decode_model.init_paged_cache(
            n_pages, self.page_len, device=self.device)

        # Host-side slot tables (single scheduler-thread writer).
        self._phase = np.full(n_slots, _FREE, np.int8)
        self._tables: List[Optional[serve_pages.PageTable]] = [None] * n_slots
        # Per-slot full table (prefill reads its row); decode sees a row only
        # once the slot ENTERS decode — a prefilling slot's pages must never
        # take decode-step scatter writes.
        self._table_np = np.full(
            (n_slots, self.max_pages), serve_pages.SCRATCH_PAGE, np.int32)
        self._decode_table_np = np.full(
            (n_slots, self.max_pages), serve_pages.SCRATCH_PAGE, np.int32)
        self._lengths = np.zeros(n_slots, np.int32)
        self._last_token = np.zeros(n_slots, np.int32)
        self._prompts: List[Optional[np.ndarray]] = [None] * n_slots
        self._prefill_pos = np.zeros(n_slots, np.int32)
        # Program invocations: decode steps and prefill chunks run so far.
        self.decode_invocations = 0
        self.prefill_invocations = 0

    # -------------------------------------------------------------- accounting
    @property
    def free_slots(self) -> int:
        return int((self._phase == _FREE).sum())

    @property
    def active_slots(self) -> int:
        return int((self._phase != _FREE).sum())

    @property
    def active_tokens(self) -> int:
        """Timeline tokens reserved across active requests."""
        return self.pool.allocated_tokens

    @property
    def written_tokens(self) -> int:
        """Tokens actually resident in reserved pages."""
        total = 0
        for idx in np.flatnonzero(self._phase != _FREE):
            idx = int(idx)
            if self._phase[idx] == _PREFILL:
                prompt = self._prompts[idx]
                total += min(int(self._prefill_pos[idx]),
                             len(prompt) if prompt is not None else 0)
            else:
                total += int(self._lengths[idx])
        return total

    @property
    def page_utilization(self) -> float:
        return self.pool.utilization

    @property
    def page_fragmentation(self) -> float:
        return self.pool.fragmentation(self.written_tokens)

    @property
    def page_pool_bytes(self) -> int:
        """Device bytes of the static page pool."""
        return int(self.page_bytes) * self.pool.n_pages

    @property
    def page_pool_fp_equiv_bytes(self) -> int:
        """What the pool's KV capacity would cost in fp pages."""
        return int(self.page_fp_equiv_bytes) * self.pool.n_pages

    @property
    def quant_capacity_x(self) -> float:
        """Effective-capacity multiplier from int8 KV pages (1.0 fp)."""
        if not self.kv_quant or self.page_bytes <= 0:
            return 1.0
        return float(self.page_fp_equiv_bytes) / float(self.page_bytes)

    @property
    def prefilling_slots(self) -> int:
        return int((self._phase == _PREFILL).sum())

    @property
    def decoding_slots(self) -> int:
        return int((self._phase == _DECODE).sum())

    # --------------------------------------------------------------- admission
    def check_admissible(self, prompt_len: int,
                         max_new_tokens: int) -> Optional[AdmissionDenied]:
        """The static (never-serveable) admission checks shared by
        :meth:`admit` and the batcher's ``submit`` edge."""
        total = int(prompt_len) + int(max_new_tokens)
        if prompt_len < 1:
            return AdmissionDenied("empty prompt", retryable=False)
        if total > self.max_len:
            return AdmissionDenied(
                f"request needs a {total}-token timeline; engine ceiling is "
                f"{self.max_len} (prompt {prompt_len} + max_new_tokens "
                f"{max_new_tokens})", retryable=False)
        return None

    def admit(self, prompt: np.ndarray, max_new_tokens: int,
              sampling: Optional[serve_sampling.SamplingParams] = None,
              ) -> Union[Slot, AdmissionDenied]:
        """Reserve a decode row + pages for ``prompt`` — host bookkeeping
        only (prefill runs chunk by chunk via :meth:`prefill_step`). Returns
        a :class:`Slot` or a typed :class:`AdmissionDenied`; raises
        :class:`~autodist_tpu_torch.serve.sampling.InvalidSamplingParams`
        for params this port cannot serve (``temperature > 0``)."""
        serve_sampling.check_supported(sampling)
        prompt = np.asarray(prompt, np.int32).ravel()
        total = len(prompt) + int(max_new_tokens)
        unservable = self.check_admissible(len(prompt), max_new_tokens)
        if unservable is not None:
            return unservable
        free = np.flatnonzero(self._phase == _FREE)
        if not len(free):
            return AdmissionDenied(
                f"no free decode row ({self.n_slots} active)", retryable=True)
        table = self.pool.alloc(total)
        if table is None:
            return AdmissionDenied(
                f"page pool exhausted ({self.pool.free_pages} of "
                f"{self.pool.usable_pages} pages free; need "
                f"{serve_pages.pages_for_tokens(total, self.page_len)})",
                retryable=True)
        idx = int(free[0])
        self._phase[idx] = _PREFILL
        self._tables[idx] = table
        self._table_np[idx] = table.padded(self.max_pages)
        self._decode_table_np[idx] = serve_pages.SCRATCH_PAGE
        self._lengths[idx] = 0
        self._last_token[idx] = 0
        self._prompts[idx] = prompt
        self._prefill_pos[idx] = 0
        return Slot(idx)

    def prefill_pending(self) -> List[Slot]:
        """Slots mid-prefill, in row order."""
        return [Slot(int(i)) for i in np.flatnonzero(self._phase == _PREFILL)]

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr).to(self.device, non_blocking=False)

    def prefill_step(self, slot: Slot) -> Optional[int]:
        """Run ONE prefill chunk for ``slot``. Returns the first generated
        token when the prompt is fully prefilled (the slot then joins the
        decode batch next :meth:`step`), else None."""
        idx = slot.index
        if self._phase[idx] != _PREFILL:
            raise ValueError(f"slot {idx} is not prefilling")
        prompt = self._prompts[idx]
        start = int(self._prefill_pos[idx])
        c = self.prefill_chunk
        chunk = np.zeros((1, c), np.int32)
        valid = prompt[start:start + c]
        chunk[0, : len(valid)] = valid
        self.prefill_invocations += 1
        with torch.no_grad():
            first, self._cache = self.decode_model.prefill_chunk(
                self.params, self._dev(chunk), start, len(prompt), self._cache,
                self._dev(self._table_np[idx]))
        start += c
        self._prefill_pos[idx] = start
        if start < len(prompt):
            return None
        first = int(first.cpu()[0])
        self._phase[idx] = _DECODE
        self._lengths[idx] = len(prompt)
        self._last_token[idx] = first
        self._decode_table_np[idx] = self._table_np[idx]
        return first

    def step(self) -> Dict[Slot, int]:
        """One decode step over the full slot batch: feeds each decoding row
        its last emitted token at its current position and returns
        ``{slot: next_token}`` for decoding rows only (idle and prefilling
        rows ride along against the scratch page — finite garbage, ignored)."""
        out: Dict[Slot, int] = {}
        decoding = np.flatnonzero(self._phase == _DECODE)
        if not len(decoding):
            return out
        self.decode_invocations += 1
        with torch.no_grad():
            tokens, self._cache = self.decode_model.decode_paged(
                self.params, self._dev(self._last_token), self._dev(self._lengths),
                self._cache, self._dev(self._decode_table_np))
        tokens = tokens.cpu().numpy()
        for idx in decoding:
            idx = int(idx)
            self._lengths[idx] += 1
            self._last_token[idx] = tokens[idx]
            out[Slot(idx)] = int(tokens[idx])
        return out

    def step_many(self) -> Dict[Slot, List[int]]:
        """One decode round, multi-token surface: ``{slot: [token]}`` (the
        batcher's interface; a speculative engine emits several)."""
        return {slot: [tok] for slot, tok in self.step().items()}

    def release(self, slot: Slot) -> None:
        """Retire a row: its pages recycle into the pool immediately."""
        idx = slot.index
        table = self._tables[idx]
        if table is not None:
            self.pool.release(table)
        self._tables[idx] = None
        self._phase[idx] = _FREE
        self._table_np[idx] = serve_pages.SCRATCH_PAGE
        self._decode_table_np[idx] = serve_pages.SCRATCH_PAGE
        self._lengths[idx] = 0
        self._last_token[idx] = 0
        self._prompts[idx] = None
        self._prefill_pos[idx] = 0

    # ------------------------------------------------------------- generation
    def generate(self, prompt: np.ndarray, max_new_tokens: int,
                 sampling: Optional[serve_sampling.SamplingParams] = None,
                 ) -> List[int]:
        """Single-request greedy decode — the sequential baseline. Production
        traffic goes through the batcher."""
        admitted = self.admit(prompt, max_new_tokens, sampling=sampling)
        if isinstance(admitted, AdmissionDenied):
            raise RuntimeError(
                f"single-request generate() not admitted: {admitted.reason}")
        slot = admitted
        try:
            first = None
            while first is None:
                first = self.prefill_step(slot)
            tokens = [first]
            eos = self.decode_model.eos_id
            while len(tokens) < max_new_tokens and (
                    eos is None or tokens[-1] != eos):
                for tok in self.step_many()[slot]:
                    tokens.append(tok)
                    if len(tokens) >= max_new_tokens or tok == eos:
                        break
        finally:
            self.release(slot)
        return tokens


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
