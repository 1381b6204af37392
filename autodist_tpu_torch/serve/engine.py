"""Inference engines of the PyTorch port (one card): paged KV-cache decode,
the one-shot forward and the bucketed baseline.

Ports the JAX package's ``serve/engine.py``. Decode state is ONE fixed pool of ``[layers, n_pages,
page_len, heads, head_dim]`` device pages, sized from the card's memory,
with per-request page tables (host int32 rows, ``serve/pages.py``) padded to
a static width. Two programs serve every request-length mix: one decode step
over every slot row, and one fixed-size prefill chunk — long prompts prefill
chunk by chunk, interleaved with decode ticks by the batcher. Admission
reserves pages all-or-nothing; retirement recycles them in the same tick.

Each slot carries its request id and sampling params (``serve/sampling.py``):
the stream of a request is a pure function of ``(request_id, seed,
position)``. With ``prefix_cache=True`` admissions map cached prompt blocks
onto shared pages (``serve/prefix.py``), copy the partially matched frontier
page (copy-on-write) and resume prefill mid-page.

Observability and fault injection follow the JAX engine: the spans
``serve.cow_copy``, ``serve.prefill_chunk`` and ``serve.decode_step`` (host
wall of each call, tagged with request ids), the ``serve`` step records
``admit``, ``prefilled`` and (one in 64 decode steps) ``decode``, and the
chaos seams ``SEAM_SERVE_ADMIT`` (``"defer"`` becomes a retryable
:class:`AdmissionDenied`) and ``SEAM_SERVE_STEP`` (may raise
:class:`EngineDeadError`), carrying ``chaos_host``. No span or record reads
a tensor back.

What differs from the JAX engine: there is no mesh to shard over — on one
card the params are a dict of tensors on ``device``, which is what
``AllReduce`` gives on one chip; :attr:`plan` builds that one-device
``AllReduce`` plan on first read, for the memory pass
(``analysis/passes.py::hbm_budget``) to price. PyTorch runs eagerly, so
nothing compiles: :attr:`compiled_programs` counts the distinct (program
kind, argument shapes) the serving forwards have run — shapes, not
compiles, the eager counterpart of the JAX engine's pin (2 plain, 5
speculative, for any request-length mix). The cache is updated in place by
the forwards (the JAX engine donates it through its compiled programs to
the same effect).

``infer(batch)`` is the one-shot forward (``apply_fn(params, batch)`` under
``torch.inference_mode()``). :class:`BucketedInferenceEngine` keeps the
length-bucketed stacked slot pools that came before paging: the baseline
the serve selftest measures the paged engine against (>=2x concurrency at
equal KV bytes, bit-identical greedy streams) and a second, independent
decode oracle.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from autodist_tpu_torch.chaos import hooks as chaos_hooks
from autodist_tpu_torch.obs import recorder as obs_recorder
from autodist_tpu_torch.obs import spans as obs_spans
from autodist_tpu_torch.serve import pages as serve_pages
from autodist_tpu_torch.serve import prefix as serve_prefix
from autodist_tpu_torch.serve import sampling as serve_sampling
from autodist_tpu_torch.utils.device import resolve_device

#: The bucketed engine's default timeline buckets (the JAX engine's).
DEFAULT_BUCKET_LENS = (32, 64, 128, 256, 512, 1024)

#: Slot phases (host bookkeeping; single scheduler-thread writer).
_FREE, _PREFILL, _DECODE = 0, 1, 2


class EngineDeadError(RuntimeError):
    """The inference engine can no longer decode. The batcher catches this
    specifically and sheds all load with typed REJECTED results instead of
    hanging clients."""


@dataclass
class DecodeModel:
    """Model adapter for autoregressive decode — functions bound to one
    config.

    Paged surface (:class:`InferenceEngine`; all three required there):

    - ``init_paged_cache(n_pages, page_len, device) -> cache`` dict of
      tensors carrying the page dim at dim 1;
    - ``prefill_chunk(params, tokens [1,C], start, length, cache,
      page_table [P], samp=None) -> (next_token [1], cache)``;
    - ``decode_paged(params, tokens [B], positions [B], cache,
      page_tables [B,P], samp=None) -> (next_token [B], cache)`` with
      ``B == n_slots``;
    - ``verify_paged(params, tokens [B, K+1], positions [B], cache,
      page_tables [B,P], samp=None) -> (accept [B], out_tokens [B, K+1],
      cache)``: the speculative engine's batched verify (optional).

    ``samp`` is None (greedy) or the per-slot sampling tensors
    ``(temperature, top_k, top_p, key_hi, key_lo)``.

    Bucketed surface (:class:`BucketedInferenceEngine`; greedy):
    ``init_cache(n_slots, max_len, device) -> cache`` with the slot dim at
    dim 1, ``prefill(params, tokens [1,S], length, cache, slot) ->
    (next_token [1], cache)`` and ``decode_step(params, tokens [B],
    positions [B], cache) -> (next_token [B], cache)``.

    ``eos_id``: generation stops when emitted (None = length-only);
    ``max_len``: the model's positional ceiling; ``fp_cache_dtype``: the fp
    page dtype that int8 pages are priced against.
    """

    init_cache: Optional[Callable[..., Any]] = None
    prefill: Optional[Callable[..., Tuple[Any, Any]]] = None
    decode_step: Optional[Callable[..., Tuple[Any, Any]]] = None
    init_paged_cache: Optional[Callable[..., Any]] = None
    prefill_chunk: Optional[Callable[..., Tuple[Any, Any]]] = None
    decode_paged: Optional[Callable[..., Tuple[Any, Any]]] = None
    verify_paged: Optional[Callable[..., Tuple[Any, Any, Any]]] = None
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


class _EngineBase:
    """Params on the engine's device, the one-shot forward and the plan."""

    def __init__(self, params: Any, apply_fn: Optional[Callable] = None, device=None):
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self._apply_fn = apply_fn
        self._plan = None

    def _dev(self, arr) -> torch.Tensor:
        return torch.as_tensor(arr).to(self.device)

    @property
    def plan(self):
        """The one-device ``AllReduce`` :class:`~autodist_tpu_torch.kernel.
        lowering.ShardingPlan` of the params, built on first read as the JAX
        engine's ``build`` builds its plan (``ModelItem`` → ``AllReduce().
        build`` → ``StrategyCompiler`` → ``GraphTransformer``). It shards
        nothing on one card; the memory pass prices from it."""
        if self._plan is None:
            from autodist_tpu_torch.kernel import GraphTransformer, build_mesh
            from autodist_tpu_torch.model_item import ModelItem
            from autodist_tpu_torch.resource_spec import ResourceSpec
            from autodist_tpu_torch.strategy import AllReduce, StrategyCompiler

            item = ModelItem.from_params(self.params)
            spec = ResourceSpec.from_local_devices(self.device)
            compiled = StrategyCompiler(item).compile(AllReduce().build(item, spec))
            self._plan = GraphTransformer(
                compiled, item, build_mesh(spec, device=self.device)).transform()
        return self._plan

    @staticmethod
    def restore_params(checkpoint: str, params_template: Any, device=None) -> Any:
        """A ``Saver`` checkpoint's params as the engine serves them: every
        leaf whole on ``device`` (default: the card; the port's engine
        serves on one device, so there is no plan to place by), in the
        template's dtypes. ``checkpoint`` is a ``ckpt-N`` directory or a
        Saver directory (its newest ``ckpt-*``); the template (tensors, meta
        ones included) gives the names and logical shapes. A training
        checkpoint (``step.save``: the whole logical state) keeps its
        parameters under ``params/``: then only that subtree is read, never
        the optimizer's slots."""
        import os

        from autodist_tpu_torch.checkpoint.saver import Saver, flatten_with_names

        device = resolve_device(device)
        if os.path.exists(os.path.join(checkpoint, "metadata.json")):
            saver, path = Saver(os.path.dirname(checkpoint)), checkpoint
        else:
            saver = Saver(checkpoint)
            path = saver.latest_checkpoint()
            if path is None:
                raise FileNotFoundError(f"no ckpt-* under {checkpoint!r}")
        leaves = flatten_with_names(params_template)
        probe = leaves[0][0] if leaves else ""
        entries = Saver.read_metadata(path)["entries"]
        if probe and probe not in entries and f"params/{probe}" in entries:
            return saver.restore_subtree(path, "params", params_template, device=device)
        return saver.restore(path, target=params_template, device=device)

    # --------------------------------------------------------------- one-shot
    def infer(self, batch: Any) -> Any:
        """One-shot forward (classification, scoring): ``apply_fn(params,
        batch)`` on the engine's device under ``torch.inference_mode()``;
        the output stays on the device."""
        if self._apply_fn is None:
            raise ValueError("engine built without apply_fn; one-shot "
                             "inference unavailable")
        with torch.inference_mode():
            return self._apply_fn(self.params, _to_device(batch, self.device))


class InferenceEngine(_EngineBase):
    """Serve a model: ``infer`` for one-shot batches (``apply_fn``), and
    ``admit``/``prefill_step``/``step``/``release`` for paged
    continuous-batching decode (``decode_model``); at least one of the two.

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
        decode_model: Optional[DecodeModel] = None,
        n_slots: int = 8,
        page_len: int = serve_pages.DEFAULT_PAGE_LEN,
        n_pages: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        max_len: Optional[int] = None,
        serve_hbm_frac: float = 0.5,
        device=None,
        prefix_cache: Union[bool, "serve_prefix.PrefixCache", None] = None,
        apply_fn: Optional[Callable] = None,
    ):
        if apply_fn is None and decode_model is None:
            raise ValueError(
                "InferenceEngine needs apply_fn (one-shot), decode_model "
                "(autoregressive), or both")
        super().__init__(params, apply_fn=apply_fn, device=device)
        self.decode_model = decode_model
        self._programs: set = set()
        if decode_model is None:
            return
        for fn in ("init_paged_cache", "prefill_chunk", "decode_paged"):
            if getattr(decode_model, fn) is None:
                raise ValueError(
                    f"decode_model lacks the paged surface ({fn}); the paged "
                    f"engine needs init_paged_cache + prefill_chunk + "
                    f"decode_paged (see DecodeModel)")
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
        # Under prefix sharing, pages past every-row-at-max-timeline still
        # help: they hold cold cached prefixes (pages.pool_size_from_device).
        sharing_factor = 2.0 if prefix_cache else 1.0
        if n_pages is None:
            if self.device.type == "cuda":
                n_pages = serve_pages.pool_size_from_device(
                    self.device, page_bytes, params_bytes=_tree_bytes(self.params),
                    serve_frac=serve_hbm_frac, max_useful_pages=max_useful,
                    min_useful_pages=self.max_pages,
                    sharing_factor=sharing_factor)
            else:
                n_pages = int(max_useful * sharing_factor) + 1
        n_pages = max(int(n_pages), self.max_pages + 1)
        self.pool = serve_pages.build_pool(
            n_pages, self.page_len, quantized=self.kv_quant,
            bytes_per_page=float(page_bytes),
            fp_equiv_bytes_per_page=float(self.page_fp_equiv_bytes))
        self._cache = decode_model.init_paged_cache(
            n_pages, self.page_len, device=self.device)
        # Copy-on-write prefix sharing: True builds the radix cache over this
        # pool; an already-built PrefixCache is used as given (the spec
        # engine hands one spanning both its pools); None/False is off.
        if isinstance(prefix_cache, serve_prefix.PrefixCache):
            self._prefix_cache: Optional[serve_prefix.PrefixCache] = prefix_cache
        elif prefix_cache:
            self._prefix_cache = serve_prefix.build_prefix_cache(
                self.pool, self.page_len)
        else:
            self._prefix_cache = None

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
        self._request_ids: List[str] = [""] * n_slots
        self._prefill_pos = np.zeros(n_slots, np.int32)
        self._prefill_start = np.zeros(n_slots, np.int32)
        # Prefix sharing: the slot's lease on tree pages, and whether its
        # admission matched a cached prefix (the cached/uncached TTFT split).
        self._leases: List[Optional[serve_prefix.Lease]] = [None] * n_slots
        self._cached = np.zeros(n_slots, bool)
        # Per-slot sampling params; greedy defaults (temperature 0).
        self._samp = serve_sampling.slot_arrays(n_slots)
        # Admission time of each slot (the ``prefilled`` record's prefill_s).
        self._prefill_t0 = np.zeros(n_slots, np.float64)
        # Program invocations by kind: decode steps and prefill chunks run
        # so far (compiled_programs counts their distinct argument shapes).
        self.decode_invocations = 0
        self.prefill_invocations = 0
        # Decode rounds (plain steps or spec rounds): every 64th is
        # flight-recorded.
        self._decode_step_count = 0
        # Replica identity carried into the chaos seams, so a schedule can
        # target one replica of a fleet (serve/replica.py sets it).
        self.chaos_host = 0

    # ------------------------------------------------------------ construction
    @classmethod
    def build(cls, params: Any, decode_model: Optional[DecodeModel] = None, *,
              apply_fn: Optional[Callable] = None, checkpoint: Optional[str] = None,
              **engine_kwargs) -> "InferenceEngine":
        """Standalone construction for a script without an
        :class:`~autodist_tpu_torch.api.AutoDist` (whose ``build_inference``
        does the same): ``apply_fn`` alone gives a one-shot engine;
        ``checkpoint`` restores the params from a ``Saver`` checkpoint
        (:meth:`restore_params`) onto the engine's device; ``params`` may
        then be a template of meta tensors."""
        if checkpoint is not None:
            params = cls.restore_params(checkpoint, params, engine_kwargs.get("device"))
        return cls(params, decode_model, apply_fn=apply_fn, **engine_kwargs)

    @property
    def compiled_programs(self) -> int:
        """The distinct (program kind, argument shapes) the serving forwards
        have run — the eager counterpart of the JAX engine's count of
        compiled programs, pinned to exactly 2 (one decode step over every
        row, one fixed-size prefill chunk) for any request-length mix. It
        counts shapes, not compiles: nothing compiles here. The sampling
        tensors ride as values, as the JAX programs' traced per-slot arrays
        do."""
        return len(self._programs)

    def _note_program(self, kind: str, *args) -> None:
        self._programs.add((kind, *(tuple(a.shape) for a in args)))

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

    @property
    def prefix_cache(self) -> Optional["serve_prefix.PrefixCache"]:
        return self._prefix_cache

    def slot_cached(self, slot: Slot) -> bool:
        """Whether this slot's admission matched a cached prefix."""
        return bool(self._cached[slot.index])

    def _logical_physical_pages(self) -> Tuple[int, int]:
        """(logical, physical) pages across live tables: logical counts
        every table entry, physical distinct pages."""
        logical, phys = 0, set()
        for t in self._tables:
            if t is None:
                continue
            logical += len(t.pages)
            phys.update(t.pages)
        return logical, len(phys)

    @property
    def sharing_ratio(self) -> float:
        """Logical / physical pages across live tables: 1.0 with sharing
        off (or idle), above 1.0 when admissions share pages."""
        logical, phys = self._logical_physical_pages()
        return logical / phys if phys else 1.0

    @property
    def shared_fraction(self) -> float:
        """Fraction of the live logical timeline served by deduplicated
        pages, 0..1."""
        logical, phys = self._logical_physical_pages()
        return 1.0 - phys / logical if logical else 0.0

    def prefix_stats(self) -> Dict[str, float]:
        """The prefix tree's counters (zeros when sharing is off)."""
        if self._prefix_cache is None:
            return {"hit_rate": 0.0, "hits": 0, "lookups": 0,
                    "cached_pages": 0, "shared_pages": 0, "evictions": 0,
                    "inserts": 0, "cow_copies": 0, "live_refcount": 0}
        return self._prefix_cache.stats()

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
              request_id: str = "",
              sampling: Optional[serve_sampling.SamplingParams] = None,
              ) -> Union[Slot, AdmissionDenied]:
        """Reserve a decode row + pages for ``prompt`` — host bookkeeping
        (plus, on a prefix-cache frontier hit, one device page copy);
        prefill runs chunk by chunk via :meth:`prefill_step`. Returns a
        :class:`Slot` or a typed :class:`AdmissionDenied`; raises
        :class:`~autodist_tpu_torch.serve.sampling.InvalidSamplingParams`
        for malformed params. ``request_id`` with ``sampling`` keys the
        counter-based stream: a pure function of ``(request_id, seed,
        position)``, whichever slot, batch or cache state serves it."""
        sp = (sampling or serve_sampling.SamplingParams()).validate()
        prompt = np.asarray(prompt, np.int32).ravel()
        total = len(prompt) + int(max_new_tokens)
        unservable = self.check_admissible(len(prompt), max_new_tokens)
        if unservable is not None:
            return unservable
        # Chaos seam: "defer" behaves as no free capacity (the batcher keeps
        # the request queued); the hook may also raise EngineDeadError.
        if chaos_hooks.fire(chaos_hooks.SEAM_SERVE_ADMIT,
                            prompt_len=len(prompt),
                            max_new_tokens=max_new_tokens) == "defer":
            return AdmissionDenied("admission deferred (chaos)", retryable=True)
        free = np.flatnonzero(self._phase == _FREE)
        if not len(free):
            return AdmissionDenied(
                f"no free decode row ({self.n_slots} active)", retryable=True)
        lease: Optional[serve_prefix.Lease] = None
        start_pos = 0
        if self._prefix_cache is None:
            table = self.pool.alloc(total)
        else:
            # Matched full blocks ride the SAME physical pages (refcount++
            # under the lease); only the unmatched suffix reserves fresh
            # pages, evicting cold cached prefixes under pressure.
            m = self._prefix_cache.match(prompt)
            lease = self._prefix_cache.acquire(m)
            table = self._alloc_with_evict(total - m.n_full * self.page_len)
            if table is None:
                self._prefix_cache.cancel(lease)
            else:
                start_pos = m.n_full * self.page_len
                if m.tail_len:
                    # COW frontier: copy the partially matched page into the
                    # first exclusive page and resume prefill mid-page. The
                    # source stays pinned on the lease until release (the
                    # spec engine's draft-side copy reads it after this).
                    self._cow_page(m.tail_node.page, table.pages[0])
                    start_pos += m.tail_len
                else:
                    self._prefix_cache.unpin_tail(lease)
                table.pages[:0] = [nd.page for nd in lease.nodes]
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
        self._request_ids[idx] = str(request_id or "")
        self._prefill_pos[idx] = start_pos
        self._prefill_start[idx] = start_pos
        self._leases[idx] = lease
        self._cached[idx] = start_pos > 0
        hi, lo = serve_sampling.request_key(self._request_ids[idx], sp.seed)
        for key, value in zip(serve_sampling.SAMP_KEYS,
                              (sp.temperature, sp.top_k, sp.top_p, hi, lo)):
            self._samp[key][idx] = value
        self._prefill_t0[idx] = time.perf_counter()
        # Non-critical (batched fsync): bounded by admissions, not tokens.
        obs_recorder.record_step(
            surface="serve", event="admit", prompt_len=len(prompt),
            request_id=self._request_ids[idx], pages=len(table.pages),
            cached_tokens=start_pos,
            pool_used=self.pool.used_pages, pool_free=self.pool.free_pages)
        return Slot(idx)

    def _alloc_with_evict(self, n_tokens: int) -> Optional[serve_pages.PageTable]:
        """Pool allocation that, when the pool cannot cover ``n_tokens``,
        evicts cold cached prefixes (LRU refcount-0 leaves) and tries again;
        None once the tree has nothing left to give."""
        table = self.pool.alloc(n_tokens)
        need = serve_pages.pages_for_tokens(n_tokens, self.page_len)
        while table is None and self._prefix_cache is not None:
            if self._prefix_cache.evict(need) == 0:
                return None
            table = self.pool.alloc(n_tokens)
        return table

    @staticmethod
    def _copy_page(cache, src_page: int, dst_page: int) -> None:
        """Every cache leaf's ``src`` page row into ``dst`` (int8 scales
        included), in place on the cache's device."""
        with torch.no_grad():
            for leaf in cache.values():
                leaf[:, dst_page].copy_(leaf[:, src_page])

    def _cow_page(self, src_page: int, dst_page: int) -> None:
        """The copy-on-write at the divergence frontier: a device copy of
        one KV page (never a shared write)."""
        with obs_spans.span("serve.cow_copy", src=int(src_page), dst=int(dst_page)):
            self._copy_page(self._cache, src_page, dst_page)
        if self._prefix_cache is not None:
            self._prefix_cache.cow_copies += 1

    def prefill_pending(self) -> List[Slot]:
        """Slots mid-prefill, in row order."""
        return [Slot(int(i)) for i in np.flatnonzero(self._phase == _PREFILL)]

    def _samp_dev(self, rows) -> Optional[tuple]:
        """The sampling tensors of slot rows ``rows`` (an index array or a
        slice) on the device, keys as int64. Callers pass None instead when
        :meth:`_stochastic` finds every emitting row greedy: the forwards
        then take the argmax, which is what
        :func:`~autodist_tpu_torch.serve.sampling.sample_tokens` returns for
        greedy rows, without drawing noise."""
        s = self._samp
        return tuple(self._dev(s[k][rows].astype(np.int64) if k.startswith("key")
                               else s[k][rows])
                     for k in serve_sampling.SAMP_KEYS)

    def _stochastic(self, rows) -> bool:
        return bool((self._samp["temperature"][rows] > 0.0).any())

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
        last = start + c >= len(prompt)
        # Only the final chunk's token is read: earlier chunks skip the draw.
        row = slice(idx, idx + 1)
        samp = self._samp_dev(row) if last and self._stochastic(row) else None
        self.prefill_invocations += 1
        with obs_spans.span("serve.prefill_chunk", start=start,
                            prompt_len=len(prompt),
                            request_id=self._request_ids[idx]), torch.no_grad():
            tokens, table = self._dev(chunk), self._dev(self._table_np[idx])
            self._note_program("prefill_chunk", tokens, table)
            first, self._cache = self.decode_model.prefill_chunk(
                self.params, tokens, start, len(prompt), self._cache, table, samp=samp)
        start += c
        self._prefill_pos[idx] = start
        if not last:
            return None
        first = int(first.cpu()[0])
        self._phase[idx] = _DECODE
        self._lengths[idx] = len(prompt)
        self._last_token[idx] = first
        self._decode_table_np[idx] = self._table_np[idx]
        if self._leases[idx] is not None:
            # Adopt the prompt's novel full blocks into the prefix tree.
            self._insert_prefix(idx, prompt)
        prefilled = len(prompt) - int(self._prefill_start[idx])
        obs_recorder.record_step(
            surface="serve", event="prefilled", prompt_len=len(prompt),
            chunks=-(-prefilled // c), cached=bool(self._cached[idx]),
            prefill_s=round(time.perf_counter() - self._prefill_t0[idx], 6))
        return first

    def _insert_prefix(self, idx: int, prompt: np.ndarray) -> None:
        """Prefix-tree adoption at prefill completion (the spec engine
        adopts target and draft pages as one node per block)."""
        self._prefix_cache.insert(prompt, self._tables[idx].pages,
                                  self._leases[idx])

    def step(self) -> Dict[Slot, int]:
        """One decode step over the full slot batch: feeds each decoding row
        its last emitted token at its current position and returns
        ``{slot: next_token}`` for decoding rows only (idle and prefilling
        rows ride along against the scratch page — finite garbage, ignored)."""
        out: Dict[Slot, int] = {}
        # Chaos seam: may raise EngineDeadError (an engine death mid-decode);
        # host names this engine's replica.
        chaos_hooks.fire(chaos_hooks.SEAM_SERVE_STEP,
                         active=self.active_slots, host=self.chaos_host)
        decoding = np.flatnonzero(self._phase == _DECODE)
        if not len(decoding):
            return out
        samp = self._samp_dev(slice(None)) if self._stochastic(decoding) else None
        self.decode_invocations += 1
        with obs_spans.span("serve.decode_step", active=int(len(decoding)),
                            request_ids=self._span_request_ids(decoding)):
            args = (self._dev(self._last_token), self._dev(self._lengths))
            tables = self._dev(self._decode_table_np)
            self._note_program("decode_paged", *args, tables)
            with torch.no_grad():
                tokens, self._cache = self.decode_model.decode_paged(
                    self.params, *args, self._cache, tables, samp=samp)
            tokens = tokens.cpu().numpy()
        for idx in decoding:
            idx = int(idx)
            self._lengths[idx] += 1
            self._last_token[idx] = tokens[idx]
            out[Slot(idx)] = int(tokens[idx])
        self._record_decode(len(out))
        return out

    def _span_request_ids(self, rows) -> List[str]:
        """The request ids riding a batched step, for its span (bounded: a
        trace viewer needs identity, not an unbounded argument)."""
        return [self._request_ids[int(i)] for i in rows[:16] if self._request_ids[int(i)]]

    def _record_decode(self, active: int, **fields) -> None:
        """The sampled (one in 64) ``decode`` flight record of a round."""
        self._decode_step_count += 1
        if self._decode_step_count % 64 == 1:
            obs_recorder.record_step(
                surface="serve", event="decode",
                decode_steps=self._decode_step_count, active_slots=active,
                **fields, pool_utilization=round(self.page_utilization, 4))

    def step_many(self) -> Dict[Slot, List[int]]:
        """One decode round, multi-token surface: ``{slot: [token]}`` (the
        batcher's interface; a speculative engine emits several)."""
        return {slot: [tok] for slot, tok in self.step().items()}

    def release(self, slot: Slot) -> None:
        """Retire a row: its exclusive pages recycle into the pool
        immediately; shared (tree-owned) pages only drop a refcount and stay
        cached for the next admission."""
        idx = slot.index
        table = self._tables[idx]
        lease = self._leases[idx]
        if table is not None:
            if lease is not None:
                shared = set(lease.pages)
                exclusive = [p for p in table.pages if p not in shared]
                self._prefix_cache.release(lease)
                if exclusive:
                    self.pool.reclaim(exclusive)
                table.pages = []
            else:
                self.pool.release(table)
        self._leases[idx] = None
        self._cached[idx] = False
        self._prefill_start[idx] = 0
        self._request_ids[idx] = ""
        for key, fresh in serve_sampling.slot_arrays(1).items():
            self._samp[key][idx] = fresh[0]
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
                 request_id: str = "",
                 sampling: Optional[serve_sampling.SamplingParams] = None,
                 ) -> List[int]:
        """Single-request decode — the sequential baseline (greedy unless
        ``sampling`` is given; ``request_id`` keys its stream). Production
        traffic goes through the batcher."""
        admitted = self.admit(prompt, max_new_tokens, request_id=request_id,
                              sampling=sampling)
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


@dataclass(frozen=True)
class BucketSlot:
    """One occupied bucketed-engine slot: (bucket timeline length, row)."""

    bucket: int
    index: int


@dataclass
class _Bucket:
    """Host-side bookkeeping for one bucket's stacked device cache."""

    length: int                 # timeline capacity per slot
    n_slots: int
    cache: Any                  # dict of device tensors, updated in place
    lengths: np.ndarray         # [slots] int32 — next write position
    active: np.ndarray          # [slots] bool
    last_token: np.ndarray      # [slots] int32 — token to feed next step


class BucketedInferenceEngine(_EngineBase):
    """The pre-paging design, kept as the measured baseline: preallocated
    length-bucketed stacked slot pools (one cache and one decode step per
    bucket; a request goes to the smallest bucket fitting ``prompt +
    max_new``, spilling to larger ones when it is full). The serve selftest
    proves the paged engine holds >=2x the concurrent requests of this one
    at equal KV bytes with bit-identical greedy streams; it stays for that
    proof and as a second, independent decode oracle — production serving
    is :class:`InferenceEngine`. The JAX engine rounds ``n_slots`` up to
    its mesh's data degree; on one card that degree is 1."""

    def __init__(
        self,
        params: Any,
        decode_model: DecodeModel,
        n_slots: int = 8,
        bucket_lens: Optional[Sequence[int]] = None,
        max_len: Optional[int] = None,
        device=None,
    ):
        super().__init__(params, device=device)
        for fn in ("init_cache", "prefill", "decode_step"):
            if getattr(decode_model, fn) is None:
                raise ValueError(f"decode_model lacks the bucketed surface ({fn})")
        self.decode_model = decode_model
        self.n_slots = int(n_slots)
        ceiling = min(
            x for x in (max_len, decode_model.max_len) if x is not None
        ) if (max_len or decode_model.max_len) else None
        lens = list(bucket_lens or DEFAULT_BUCKET_LENS)
        if ceiling is not None:
            lens = [n for n in lens if n < ceiling] + [ceiling]
        self._bucket_lens = tuple(sorted(set(lens)))
        self.max_len = self._bucket_lens[-1]
        self._buckets: Dict[int, _Bucket] = {
            length: _Bucket(
                length=length, n_slots=self.n_slots,
                cache=decode_model.init_cache(self.n_slots, length, device=self.device),
                lengths=np.zeros(self.n_slots, np.int32),
                active=np.zeros(self.n_slots, bool),
                last_token=np.zeros(self.n_slots, np.int32))
            for length in self._bucket_lens}

    def bucket_for(self, total_len: int) -> Optional[int]:
        """Smallest bucket whose timeline fits ``total_len``; None = too
        long."""
        for length in self._bucket_lens:
            if total_len <= length:
                return length
        return None

    @property
    def free_slots(self) -> int:
        return sum(int((~b.active).sum()) for b in self._buckets.values())

    @property
    def active_slots(self) -> int:
        return sum(int(b.active.sum()) for b in self._buckets.values())

    @property
    def active_tokens(self) -> int:
        """Allocated timeline tokens across active slots (capacity reserved,
        not yet-decoded length)."""
        return sum(int(b.active.sum()) * b.length for b in self._buckets.values())

    @property
    def kv_pool_tokens(self) -> int:
        """Total timeline tokens the stacked pools hold on the device — the
        equal-memory axis the selftest sizes the paged pool against."""
        return sum(b.n_slots * b.length for b in self._buckets.values())

    def admit(self, prompt: np.ndarray, max_new_tokens: int,
              token_budget: Optional[int] = None,
              ) -> Optional[Tuple[BucketSlot, int]]:
        """Prefill ``prompt`` into a free slot of the smallest fitting bucket
        (spilling to larger ones when full; none longer than
        ``token_budget``). Returns ``(slot, first_token)`` or None when every
        fitting bucket is full; raises ValueError past the largest bucket."""
        prompt = np.asarray(prompt, np.int32).ravel()
        total = len(prompt) + int(max_new_tokens)
        fit = self.bucket_for(total)
        if fit is None:
            raise ValueError(
                f"request needs a {total}-token timeline; largest bucket is "
                f"{self._bucket_lens[-1]} (prompt {len(prompt)} + "
                f"max_new_tokens {max_new_tokens})")
        for length in self._bucket_lens:
            if length < fit:
                continue
            if token_budget is not None and length > token_budget:
                break  # every later bucket is bigger still
            bucket = self._buckets[length]
            free = np.flatnonzero(~bucket.active)
            if not len(free):
                continue
            idx = int(free[0])
            padded = np.zeros((1, length), np.int32)
            padded[0, : len(prompt)] = prompt
            with torch.no_grad():
                first, bucket.cache = self.decode_model.prefill(
                    self.params, self._dev(padded), len(prompt), bucket.cache, idx)
            first = int(first.cpu()[0])
            bucket.active[idx] = True
            bucket.lengths[idx] = len(prompt)
            bucket.last_token[idx] = first
            return BucketSlot(length, idx), first
        return None

    def step(self) -> Dict[BucketSlot, int]:
        """One decode step over every bucket with active slots (one decode
        program per bucket — the per-length-mix cost the paged engine
        exists to delete)."""
        out: Dict[BucketSlot, int] = {}
        for length, bucket in self._buckets.items():
            if not bucket.active.any():
                continue
            with torch.no_grad():
                tokens, bucket.cache = self.decode_model.decode_step(
                    self.params, self._dev(bucket.last_token),
                    self._dev(bucket.lengths), bucket.cache)
            tokens = tokens.cpu().numpy()
            for idx in np.flatnonzero(bucket.active):
                idx = int(idx)
                bucket.lengths[idx] += 1
                bucket.last_token[idx] = tokens[idx]
                out[BucketSlot(length, idx)] = int(tokens[idx])
        return out

    def release(self, slot: BucketSlot) -> None:
        bucket = self._buckets[slot.bucket]
        bucket.active[slot.index] = False
        bucket.lengths[slot.index] = 0
        bucket.last_token[slot.index] = 0

    def generate(self, prompt: np.ndarray, max_new_tokens: int) -> List[int]:
        """Single-request greedy decode."""
        admitted = self.admit(prompt, max_new_tokens)
        if admitted is None:
            raise RuntimeError("no free slot for a single-request generate()")
        slot, first = admitted
        tokens = [first]
        eos = self.decode_model.eos_id
        try:
            while len(tokens) < max_new_tokens and (
                    eos is None or tokens[-1] != eos):
                tokens.append(self.step()[slot])
        finally:
            self.release(slot)
        return tokens


def _to_device(tree, device):
    """A nested dict (or list/tuple) of tensors or arrays on ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return torch.as_tensor(tree).to(device)
