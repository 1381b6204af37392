"""Speculative decode over the paged KV cache: draft-propose, target-verify.

Ports the JAX package's ``serve/spec.py``. Plain decode pays one full
target forward per emitted token; a speculative round instead

1. runs a small **draft model** (same transformer family, its own paged KV
   pool) ``k + 1`` times over every decoding slot: feed ``j`` writes its
   token's KV at ``pos + j`` and proposes the next (the last feed only
   completes the draft cache for a fully accepted round);
2. scores the pending token and the ``k`` proposals in ONE batched target
   forward, ``models.transformer.forward_paged_verify``, whose attention is
   the paged CUDA kernel at ``Q = k + 1`` on the card;
3. accepts on the device the leading proposals that equal the target's
   own token at that position, and emits the accepted prefix plus the
   target's bonus/correction token: 1 to ``k + 1`` tokens a slot a round,
   read back to the host in one copy.

**Lossless.** The query at offset ``j`` attends exactly the timeline plain
decode sees before emitting token ``j``, and every emitted token is the
target's (argmax, or the counter-keyed sample at the same ``(key,
position)`` as plain stochastic decode, ``serve/sampling.py``); the draft
only decides how many of them one target forward reveals. The draft
samples with the same noise, so stochastic streams equal plain ones for any
draft, and a same-weights draft accepts everything.

**Page rollback.** The target keeps the all-or-nothing admission
reservation; verify writes only into the request's own timeline, with
positions past the table going to the scratch page. The draft pool is
best effort: a draft table grows with ``PagePool.extend`` as the timeline
advances and rewinds after a rejection to the accepted length + 1
(``PagePool.rewind``), so rejected speculation never holds pages. A slot
whose draft table cannot grow keeps serving at plain-decode cadence.

A prefix cache spans both pools through one tree: each cached block holds
a target and a draft page, so a hit skips both prefills, with the draft-side
copy-on-write mirroring the target's.

The JAX package's ``build_draft_plan`` (the draft's sharding plan) has no
counterpart: the port's engines take no plan (one card, params as tensors
on the device), and the draft's params sit beside the target's. Its
compiled-program pin (5) has ``compiled_programs`` as its counterpart: the
distinct (program kind, argument shapes) run, 4 for any length mix (target
prefill, draft prefill, draft decode, verify; a spec round never runs the
target's plain decode). JAX's 5 holds the same four programs, its draft
decode compiled twice (its first feed a host array, the others device
outputs). Beside it, invocation counts per program kind:
``prefill_invocations``, ``decode_invocations``, ``verify_invocations``,
``draft_invocations``.

A round fires the chaos seams ``SEAM_SERVE_STEP`` (as plain decode does)
and ``SEAM_SERVE_DRAFT`` (``"garbage"`` garbles the proposals the verifier
sees; the output stays the target's), opens the span ``serve.spec_verify``
(the draft-side frontier copy opens ``serve.cow_copy_draft``) and writes
the sampled ``decode`` flight record with the round's spec fields.

``python -m autodist_tpu_torch.serve --selftest-spec`` is the CPU proof.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from autodist_tpu_torch.chaos import hooks as chaos_hooks
from autodist_tpu_torch.obs import spans as obs_spans
from autodist_tpu_torch.serve import pages as serve_pages
from autodist_tpu_torch.serve import prefix as serve_prefix
from autodist_tpu_torch.serve import sampling as serve_sampling
from autodist_tpu_torch.serve.engine import (
    _DECODE,
    _PREFILL,
    AdmissionDenied,
    DecodeModel,
    InferenceEngine,
    Slot,
    _to_device,
    _tree_bytes,
)

__all__ = ["SelftestRig", "SpecDecodeEngine", "selftest_spec"]


class SpecDecodeEngine(InferenceEngine):
    """A paged :class:`InferenceEngine` with a draft model riding along.

    The target half is the plain engine unchanged (admission, chunked
    prefill, page pool, release). The speculative half adds the draft's
    params on the same device, a second paged pool with incrementally grown
    per-slot tables, and the target's verify forward. :meth:`step_many`
    replaces the one-token decode round with a speculative round; the
    inherited :meth:`step` (plain decode) shares all slot state."""

    def __init__(
        self,
        params: Any,
        decode_model: DecodeModel,
        draft_params: Any,
        draft_decode_model: DecodeModel,
        spec_k: int = 4,
        draft_n_pages: Optional[int] = None,
        **engine_kwargs,
    ):
        super().__init__(params, decode_model, **engine_kwargs)
        if decode_model.verify_paged is None:
            raise ValueError(
                "SpecDecodeEngine needs decode_model.verify_paged (see "
                "models.transformer.forward_paged_verify)")
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        self.spec_k = int(spec_k)
        self.draft_decode_model = draft_decode_model
        self.draft_params = _to_device(draft_params, self.device)
        # The draft pool defaults to the target pool's page count: enough to
        # shadow every target timeline. Exhaustion starves drafting only.
        dn = max(int(draft_n_pages) if draft_n_pages else self.pool.n_pages, 2)
        draft_shaped = draft_decode_model.init_paged_cache(1, self.page_len,
                                                           device="meta")
        self.draft_page_bytes = _tree_bytes(draft_shaped)
        self.draft_pool = serve_pages.build_pool(
            dn, self.page_len, quantized="k_scale" in draft_shaped,
            bytes_per_page=float(self.draft_page_bytes))
        self._draft_cache = draft_decode_model.init_paged_cache(
            dn, self.page_len, device=self.device)
        self._draft_tables: List[Optional[serve_pages.PageTable]] = [None] * self.n_slots
        self._draft_table_np = np.full((self.n_slots, self.max_pages),
                                       serve_pages.SCRATCH_PAGE, np.int32)
        # Decode view of the draft tables: a row appears only once the slot
        # ENTERS decode, so the round's k+1 feeds (over the whole batch) never
        # write through a mid-prefill slot's real draft table.
        self._draft_decode_np = np.full((self.n_slots, self.max_pages),
                                        serve_pages.SCRATCH_PAGE, np.int32)
        # One tree over both pools: rebuild the target-only cache the base
        # constructor made (still empty).
        if self._prefix_cache is not None:
            self._prefix_cache = serve_prefix.build_prefix_cache(
                self.pool, self.page_len, draft_pool=self.draft_pool)
        # Cumulative spec accounting (the batcher reads spec_stats()).
        self.verify_invocations = 0
        self.draft_invocations = 0
        self.spec_rounds = 0
        self.proposed_total = 0
        self.accepted_total = 0
        self.spec_tokens_emitted = 0
        self.draft_starved_total = 0
        self.bucket_proposed: Dict[str, int] = {}
        self.bucket_accepted: Dict[str, int] = {}

    @classmethod
    def build(cls, params: Any, draft_params: Any, decode_model: DecodeModel,
              draft_decode_model: DecodeModel, *, checkpoint: Optional[str] = None,
              draft_checkpoint: Optional[str] = None, **engine_kwargs
              ) -> "SpecDecodeEngine":
        """Standalone two-model construction: ``checkpoint`` and
        ``draft_checkpoint`` restored onto the engine's device through
        :meth:`InferenceEngine.restore_params` (a training checkpoint's
        ``params/`` subtree only)."""
        device = engine_kwargs.get("device")
        if checkpoint is not None:
            params = cls.restore_params(checkpoint, params, device)
        if draft_checkpoint is not None:
            draft_params = cls.restore_params(draft_checkpoint, draft_params, device)
        return cls(params, decode_model, draft_params, draft_decode_model, **engine_kwargs)

    @property
    def page_pool_bytes(self) -> int:
        """Target pool + draft pool device bytes."""
        return (super().page_pool_bytes
                + int(self.draft_page_bytes) * self.draft_pool.n_pages)

    # --------------------------------------------------------------- admission
    def admit(self, prompt: np.ndarray, max_new_tokens: int,
              request_id: str = "",
              sampling: Optional[serve_sampling.SamplingParams] = None):
        got = super().admit(prompt, max_new_tokens, request_id=request_id,
                            sampling=sampling)
        if isinstance(got, AdmissionDenied):
            return got
        idx = got.index
        # Best effort and incremental: the prompt + the pending token now,
        # grown each round. A starved draft never blocks admission.
        table = self._build_draft_table(idx, len(self._prompts[idx]))
        if table is None:
            self.draft_starved_total += 1
        self._draft_tables[idx] = table
        self._draft_table_np[idx] = (table.padded(self.max_pages) if table is not None
                                     else serve_pages.SCRATCH_PAGE)
        self._draft_decode_np[idx] = serve_pages.SCRATCH_PAGE
        return got

    def _build_draft_table(self, idx: int,
                           prompt_len: int) -> Optional[serve_pages.PageTable]:
        """The draft-side reservation of a freshly admitted slot: with a
        prefix lease, the SAME shared prefix (the leased nodes' draft pages)
        plus the suffix, with the draft copy-on-write mirroring the target's
        frontier copy; None (starved) when a leased block lacks a draft page
        or the pool is dry."""
        lease = self._leases[idx]
        if lease is None:
            return self.draft_pool.alloc(prompt_len + 1)
        n_full = len(lease.nodes)
        tail_len = int(self._prefill_start[idx]) - n_full * self.page_len
        draft_shared = [nd.draft_page for nd in lease.nodes]
        tail = lease.tail_node
        if any(p is None for p in draft_shared) or (
                tail_len and (tail is None or tail.draft_page is None)):
            return None
        table = self._draft_alloc_with_evict(prompt_len + 1 - n_full * self.page_len)
        if table is None:
            return None
        if tail_len:
            with obs_spans.span("serve.cow_copy_draft", src=int(tail.draft_page),
                                dst=int(table.pages[0])):
                self._copy_page(self._draft_cache, tail.draft_page, table.pages[0])
        table.pages[:0] = draft_shared
        return table

    def _draft_alloc_with_evict(self, n_tokens: int) -> Optional[serve_pages.PageTable]:
        """Draft-pool allocation with tree eviction retry (cold cached
        prefixes hold draft pages too)."""
        table = self.draft_pool.alloc(n_tokens)
        need = serve_pages.pages_for_tokens(n_tokens, self.page_len)
        while table is None and self._prefix_cache is not None:
            if self._prefix_cache.evict(need) == 0:
                return None
            table = self.draft_pool.alloc(n_tokens)
        return table

    def _insert_prefix(self, idx: int, prompt: np.ndarray) -> None:
        """Adopt target AND draft pages as one node per novel block (the
        draft side only when this slot's draft table holds the prompt)."""
        draft_table = self._draft_tables[idx]
        self._prefix_cache.insert(
            prompt, self._tables[idx].pages, self._leases[idx],
            draft_pages=draft_table.pages if draft_table is not None else None)

    def _sync_draft_row(self, idx: int) -> None:
        """Refresh both table views after the draft table changed; the
        decode view follows only while the slot decodes."""
        self._draft_table_np[idx] = self._draft_tables[idx].padded(self.max_pages)
        if self._phase[idx] == _DECODE:
            self._draft_decode_np[idx] = self._draft_table_np[idx]

    def release(self, slot: Slot) -> None:
        idx = slot.index
        table = self._draft_tables[idx]
        lease = self._leases[idx]
        if table is not None:
            if lease is not None:
                # Tree-owned draft pages only drop the node's refcount (the
                # base release does that once for both pools).
                shared = {nd.draft_page for nd in lease.nodes
                          if nd.draft_page is not None}
                exclusive = [p for p in table.pages if p not in shared]
                if exclusive:
                    self.draft_pool.reclaim(exclusive)
                table.pages = []
            else:
                self.draft_pool.release(table)
        self._draft_tables[idx] = None
        self._draft_table_np[idx] = serve_pages.SCRATCH_PAGE
        self._draft_decode_np[idx] = serve_pages.SCRATCH_PAGE
        super().release(slot)

    # ----------------------------------------------------------------- prefill
    def prefill_step(self, slot: Slot) -> Optional[int]:
        """Advance BOTH prefills one chunk: the draft shadows the target's
        chunking (same start, same window) through its own table; its token
        is discarded — the first generated token is the target's."""
        idx = slot.index
        if self._phase[idx] == _PREFILL and self._draft_tables[idx] is not None:
            prompt = self._prompts[idx]
            start = int(self._prefill_pos[idx])
            c = self.prefill_chunk
            chunk = np.zeros((1, c), np.int32)
            valid = prompt[start:start + c]
            chunk[0, : len(valid)] = valid
            self.draft_invocations += 1
            tokens, table = self._dev(chunk), self._dev(self._draft_table_np[idx])
            self._note_program("draft_prefill_chunk", tokens, table)
            with torch.no_grad():
                _, self._draft_cache = self.draft_decode_model.prefill_chunk(
                    self.draft_params, tokens, start, len(prompt),
                    self._draft_cache, table)
        first = super().prefill_step(slot)
        if first is not None:
            self._draft_decode_np[idx] = self._draft_table_np[idx]
        return first

    # -------------------------------------------------------------- spec round
    def step_many(self) -> Dict[Slot, List[int]]:
        """One speculative round over the full slot batch: k+1 draft decode
        steps, one target verify, the accepted tokens and the draft rewind.
        Idle and prefilling rows ride both forwards against scratch."""
        out: Dict[Slot, List[int]] = {}
        # The plain decode step's seam: engine-death schedules target spec
        # replicas alike.
        chaos_hooks.fire(chaos_hooks.SEAM_SERVE_STEP,
                         active=self.active_slots, host=self.chaos_host)
        decoding = np.flatnonzero(self._phase == _DECODE)
        if not len(decoding):
            return out
        k = self.spec_k
        for i in decoding:
            idx = int(i)
            table = self._draft_tables[idx]
            if table is None:
                continue
            # Capped at the static ceiling: a window hanging off the end of
            # the timeline writes its overhang to scratch instead.
            need = min(int(self._lengths[idx]) + k + 1, self.max_len)
            if table.capacity < need:
                if self.draft_pool.extend(table, need):
                    self._sync_draft_row(idx)
                else:
                    self.draft_starved_total += 1
        positions = self._lengths.copy()
        pos_dev = self._dev(positions)
        draft_tables = self._dev(self._draft_decode_np)
        pending = self._dev(self._last_token)
        # The draft samples with the target's per-slot keys at the same
        # counters: the coupling that keeps stochastic spec lossless.
        samp = self._samp_dev(slice(None)) if self._stochastic(decoding) else None
        cur, proposals = pending, []
        with torch.no_grad():
            self._note_program("draft_decode_paged", pending, pos_dev, draft_tables)
            for j in range(k + 1):
                self.draft_invocations += 1
                cur, self._draft_cache = self.draft_decode_model.decode_paged(
                    self.draft_params, cur, pos_dev + j, self._draft_cache,
                    draft_tables, samp=samp)
                if j < k:
                    proposals.append(cur)
            # Chaos seam: a draft-divergence window garbles the proposals the
            # verifier sees (a deterministic offset); the emitted tokens stay
            # the target's, only acceptance drops.
            if chaos_hooks.fire(chaos_hooks.SEAM_SERVE_DRAFT,
                                host=self.chaos_host) == "garbage":
                proposals = [p + (j + 1) for j, p in enumerate(proposals)]
            self.verify_invocations += 1
            with obs_spans.span("serve.spec_verify", active=int(len(decoding)), k=k,
                                request_ids=self._span_request_ids(decoding)):
                window = torch.stack([pending] + proposals, dim=1)
                tables = self._dev(self._decode_table_np)
                self._note_program("verify_paged", window, pos_dev, tables)
                acc, out_tok, self._cache = self.decode_model.verify_paged(
                    self.params, window, pos_dev, self._cache, tables, samp=samp)
                # One host read a round: accept counts beside the tokens.
                got = torch.cat([acc[:, None], out_tok], dim=1).cpu().numpy()
        self.spec_rounds += 1
        for i in decoding:
            idx = int(i)
            m = int(got[idx, 0])
            emit = [int(t) for t in got[idx, 1: m + 2]]
            self._lengths[idx] = int(positions[idx]) + m + 1
            self._last_token[idx] = emit[-1]
            out[Slot(idx)] = emit
            self.proposed_total += k
            self.accepted_total += m
            self.spec_tokens_emitted += len(emit)
            bucket = serve_sampling.temperature_bucket(
                float(self._samp["temperature"][idx]))
            self.bucket_proposed[bucket] = self.bucket_proposed.get(bucket, 0) + k
            self.bucket_accepted[bucket] = self.bucket_accepted.get(bucket, 0) + m
            # Rollback: the draft reservation back to the accepted timeline
            # (+1 pending slot); pages past it return to the pool now.
            table = self._draft_tables[idx]
            if table is not None and self.draft_pool.rewind(
                    table, int(self._lengths[idx]) + 1):
                self._sync_draft_row(idx)
        self._record_decode(len(out), spec_rounds=self.spec_rounds,
                            acceptance_rate=round(self.acceptance_rate, 4))
        return out

    # -------------------------------------------------------------- accounting
    @property
    def acceptance_rate(self) -> float:
        """Accepted / proposed draft tokens, cumulative (0..1)."""
        return self.accepted_total / max(self.proposed_total, 1)

    @property
    def target_invocations(self) -> int:
        """Target forwards spent on decode: plain decode steps + verify
        rounds (prefill excluded on both sides: it is the same work)."""
        return self.decode_invocations + self.verify_invocations

    def spec_stats(self) -> Dict[str, Any]:
        """Cumulative speculative-decode counters (the batcher's gauges)."""
        return {
            "k": self.spec_k,
            "rounds": self.spec_rounds,
            "proposed": self.proposed_total,
            "accepted": self.accepted_total,
            "emitted": self.spec_tokens_emitted,
            "acceptance_rate": self.acceptance_rate,
            "tokens_per_round": self.spec_tokens_emitted / max(self.spec_rounds, 1),
            "verify_invocations": self.verify_invocations,
            "draft_invocations": self.draft_invocations,
            "target_decode_invocations": self.decode_invocations,
            "draft_starved": self.draft_starved_total,
            "draft_pool_free_pages": self.draft_pool.free_pages,
            "draft_pool_used_pages": self.draft_pool.used_pages,
            "by_temperature": {
                b: {"proposed": self.bucket_proposed.get(b, 0),
                    "accepted": self.bucket_accepted.get(b, 0),
                    "acceptance_rate": (self.bucket_accepted.get(b, 0)
                                        / max(self.bucket_proposed.get(b, 0), 1))}
                for b in sorted(self.bucket_proposed)},
        }


def pools_balanced(engine: InferenceEngine) -> bool:
    """Every pool of ``engine`` back to zero used pages (target, and the
    draft's on a speculative engine)."""
    pools = [engine.pool] + ([engine.draft_pool]
                             if isinstance(engine, SpecDecodeEngine) else [])
    return all(p.used_pages == 0 and p.free_pages == p.usable_pages for p in pools)


# ------------------------------------------------------------------ selftest
class SelftestRig:
    """The CPU selftests' models: a tiny fp32 target (vocab 128, 2 layers,
    d 32, ``max_seq_len``) and a 1-layer draft of another seed, on
    ``device``; plain and
    speculative engines over them (page_len 8, chunk 8, 8 slots)."""

    def __init__(self, n_pages: int = 49, draft_n_pages: int = 25,
                 max_seq_len: int = 64, device="cpu"):
        from autodist_tpu_torch.models import get_model
        from autodist_tpu_torch.models.transformer import init_params

        base = dict(vocab_size=128, d_model=32, num_heads=2, d_ff=64,
                    max_seq_len=max_seq_len, dtype="float32")
        self.target_cfg = get_model("transformer", num_layers=2, **base)
        self.draft_cfg = get_model("transformer", num_layers=1, **base)
        self.device = device
        self.params = init_params(self.target_cfg, seed=0, device=device)
        self.draft_params = init_params(self.draft_cfg, seed=7, device=device)
        self.n_pages, self.draft_n_pages = n_pages, draft_n_pages
        self.plain = self.engine()

    def _kw(self, **kw):
        return dict(dict(n_slots=8, page_len=8, n_pages=self.n_pages,
                         prefill_chunk=8, device=self.device), **kw)

    def engine(self, **kw) -> InferenceEngine:
        from autodist_tpu_torch.models.transformer import decode_model

        return InferenceEngine(self.params, decode_model(self.target_cfg),
                               **self._kw(**kw))

    def spec_engine(self, spec_k: int, same_draft: bool, **kw) -> SpecDecodeEngine:
        from autodist_tpu_torch.models.transformer import decode_model

        cfg = self.target_cfg if same_draft else self.draft_cfg
        return SpecDecodeEngine(
            self.params, decode_model(self.target_cfg),
            self.params if same_draft else self.draft_params, decode_model(cfg),
            spec_k=spec_k, draft_n_pages=self.draft_n_pages, **self._kw(**kw))


def selftest_spec(max_new: int = 12, seed: int = 0) -> int:
    """The ``--selftest-spec`` CPU proof; returns an exit code. Bars:
    spec streams equal plain greedy for prompts across page and chunk
    boundaries, k in {1, 2, 4, 8} with the same-weights draft and k in
    {2, 4} with the 1-layer draft, also through the continuous batcher;
    at k = 4 with the same-weights draft at most half the target forwards a
    token of plain decode; both pools back to zero after the run, including
    >= 1000 accept/reject cycles against the rejecting draft."""
    from autodist_tpu_torch import metrics as M
    from autodist_tpu_torch.serve.batcher import ContinuousBatcher, RequestState

    rng = np.random.default_rng(seed)
    t0 = time.monotonic()
    prompts = [np.array([5, 17, 3, 88, 2], np.int32)] + [
        rng.integers(1, 127, size=n).astype(np.int32) for n in (8, 16, 21, 11)]
    rig = SelftestRig()
    expected = [rig.plain.generate(p, max_new) for p in prompts]
    plain_per_token = rig.plain.decode_invocations / sum(len(e) for e in expected)
    parity, balanced = {}, True
    per_token = friendly = divergent = None
    for same, ks in ((True, (1, 2, 4, 8)), (False, (2, 4))):
        for k in ks:
            spec = rig.spec_engine(k, same_draft=same)
            got = [spec.generate(p, max_new) for p in prompts]
            parity[f"{'same' if same else 'divergent'}_draft_k{k}"] = got == expected
            balanced &= pools_balanced(spec)
            if k == 4 and same:
                per_token = spec.target_invocations / sum(len(g) for g in got)
                friendly = spec.acceptance_rate
            elif k == 4:
                divergent = spec.acceptance_rate

    spec = rig.spec_engine(4, same_draft=True)
    with ContinuousBatcher(spec, registry=M.MetricsRegistry()) as batcher:
        reqs = [batcher.submit(p, max_new) for p in prompts * 4]
        done = all(r.wait(120.0).state is RequestState.DONE for r in reqs)
    batch_parity = all(r.tokens == expected[i % len(prompts)]
                       for i, r in enumerate(reqs))
    balanced &= pools_balanced(spec)

    rejecter = rig.spec_engine(4, same_draft=False)
    soak_ok = True
    with ContinuousBatcher(rejecter, max_queue=256,
                           registry=M.MetricsRegistry()) as batcher:
        while soak_ok and rejecter.proposed_total // rejecter.spec_k < 1000:
            wave = [batcher.submit(prompts[i % len(prompts)], max_new)
                    for i in range(48)]
            soak_ok = all(r.wait(120.0).state is RequestState.DONE
                          and r.tokens == expected[i % len(prompts)]
                          for i, r in enumerate(wave))
    soak_cycles = rejecter.proposed_total // rejecter.spec_k
    ok = (all(parity.values()) and done and batch_parity and soak_ok
          and per_token is not None and per_token <= 0.5 * plain_per_token
          and balanced and pools_balanced(rejecter))
    print(json.dumps({
        "selftest": "autodist_tpu_torch.serve.spec", "ok": bool(ok),
        "parity": parity, "batch_done": done, "batch_parity": batch_parity,
        "plain_target_invocations_per_token": plain_per_token,
        "spec_target_invocations_per_token": per_token,
        "acceptance_rate_friendly": friendly,
        "acceptance_rate_divergent": divergent,
        "soak_cycles": soak_cycles, "soak_ok": soak_ok,
        "pools_balanced": bool(balanced and pools_balanced(rejecter)),
        "duration_s": round(time.monotonic() - t0, 1)}))
    return 0 if ok else 1
