"""Graceful serve degradation: drain in-flight work, persist the rest,
replay on restart (the port's copy of the JAX package's ``ft/drain.py``,
in its journal format: a journal written by either package replays in the
other).

A SIGTERM'd server that hard-stops loses two kinds of work: decodes that
were seconds from finishing, and queued requests nobody started. The
:class:`DrainController` closes both holes around one
:class:`~autodist_tpu_torch.serve.batcher.ContinuousBatcher`:

1. **quiesce** — the batcher stops admitting (new ``submit``s are refused
   with :class:`~autodist_tpu_torch.serve.batcher.Backpressure`, queued
   entries stop being promoted to slots);
2. **finish in-flight** — active decodes keep stepping until done, bounded
   by ``drain_deadline_s``;
3. **persist** — whatever is still undone (the untouched queue + any
   decode the deadline cut off) is written atomically to the journal and
   each such request is finished terminally as ``PREEMPTED`` (no client
   ever blocks on work this process will not do);
4. **replay** — a restarted server calls :meth:`DrainController.replay`
   (or :func:`replay_requests`): persisted entries are resubmitted and the
   file consumed, so a request is served exactly once — completed work is
   never persisted, persisted work was never completed.

The journal is prompt-level (prompt tokens + ``max_new_tokens`` +
remaining deadline), not KV-cache state: replay re-decodes from scratch on
whatever engine the restarted server built. Format version 2 also
journals each request's identity and delivery watermark: a stable
``request_id``, the ``delivered`` token count and the delivered tokens
(``tokens``). :func:`merge_journal_entries` dedupes several journals by id,
keeping the entry that delivered furthest, so a request two journals both
hold replays once.
"""
from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import List, Optional, Sequence, Union

from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.utils import logging

__all__ = [
    "DrainController",
    "merge_journal_entries",
    "persist_requests",
    "replay_requests",
]


def persist_requests(path: str, requests) -> int:
    """Atomically write the replay file for ``requests`` (anything with
    ``prompt`` / ``max_new_tokens`` / ``deadline`` — i.e. ``GenRequest``).
    Deadlines are stored as remaining seconds (absolute monotonic times do
    not survive a process restart). A ``request_id`` and delivered
    ``tokens`` are journaled too (format version 2), and sampling params
    when the request has them. Returns the entry count."""
    now = time.monotonic()
    entries = []
    for r in requests:
        entry = {
            "prompt": [int(t) for t in r.prompt],
            "max_new_tokens": int(r.max_new_tokens),
            "timeout_s": (max(0.001, r.deadline - now)
                          if r.deadline is not None else None),
        }
        rid = getattr(r, "request_id", "")
        if rid:
            entry["request_id"] = str(rid)
        tokens = getattr(r, "tokens", None)
        if tokens:
            entry["delivered"] = len(tokens)
            entry["tokens"] = [int(t) for t in tokens]
        samp = getattr(r, "sampling", None)
        if samp is not None:
            # A replayed stream re-derives its counter-based draws from
            # (request_id, seed, position) alone (serve/sampling.py).
            entry["sampling"] = samp.to_dict()
        entries.append(entry)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"format_version": 2, "entries": entries}, f)
    os.replace(tmp, path)
    return len(entries)


def _load_entries(path: str) -> Optional[List[dict]]:
    """One journal's entries; None when missing or unreadable (a corrupt
    file is moved aside to ``<path>.corrupt``)."""
    try:
        with open(path, encoding="utf-8") as f:
            payload = json.load(f)
        return list(payload.get("entries", []))
    except OSError:
        return None
    except ValueError:
        logging.warning("replay file %s is corrupt; moving it aside", path)
        try:
            os.replace(path, path + ".corrupt")
        except OSError:
            pass
        return None


def merge_journal_entries(paths: Sequence[str]) -> List[dict]:
    """Merge entries from several journals, deduping by ``request_id``:
    the entry with the highest ``delivered`` watermark wins. Entries
    without a ``request_id`` (format v1) are all kept. Order: first-seen
    journal order, so FIFO fairness survives the merge."""
    merged: List[dict] = []
    by_id: dict = {}
    for path in paths:
        for e in _load_entries(path) or []:
            rid = e.get("request_id")
            if not rid:
                merged.append(e)
                continue
            seen = by_id.get(rid)
            if seen is None:
                by_id[rid] = e
                merged.append(e)
            elif int(e.get("delivered", 0)) > int(seen.get("delivered", 0)):
                merged[merged.index(seen)] = e
                by_id[rid] = e
    return merged


def replay_requests(path: Union[str, Sequence[str]], batcher) -> List:
    """Resubmit every persisted entry to ``batcher``; consume the file(s).

    ``path`` may be one journal or several (merged with
    :func:`merge_journal_entries`). Returns the new ``GenRequest`` list
    (empty when no replay file exists). Replay never crashes startup and
    never double-serves:

    - a corrupt file is renamed aside (``.corrupt``) and skipped;
    - an entry the server can never run (a typed unservable ``REJECTED``
      from ``submit``, or a malformed entry) is dropped with a warning;
    - :class:`~autodist_tpu_torch.serve.batcher.Backpressure` stops the
      replay and atomically re-persists the not-yet-submitted remainder
      into the first journal, so submitted entries are consumed and the
      rest survive for the next cycle.
    """
    from autodist_tpu_torch.serve.batcher import Backpressure
    from autodist_tpu_torch.serve.sampling import SamplingParams

    paths = [path] if isinstance(path, str) else list(path)
    entries = merge_journal_entries(paths)
    reqs = []
    remainder: List[dict] = []
    for i, e in enumerate(entries):
        try:
            req = batcher.submit(
                e["prompt"], max_new_tokens=e["max_new_tokens"],
                timeout_s=e.get("timeout_s"),
                request_id=e.get("request_id") or None,
                sampling=SamplingParams.from_dict(e.get("sampling")))
            if req.unservable:
                logging.warning(
                    "dropping unservable persisted entry %r (%s)",
                    e, req.error)
                continue
            reqs.append(req)
        except Backpressure:
            remainder = entries[i:]
            logging.warning(
                "replay hit backpressure after %d of %d entries; "
                "re-persisting the remaining %d", len(reqs), len(entries),
                len(remainder))
            break
        except (ValueError, KeyError) as err:
            logging.warning("dropping unservable persisted entry %r (%s)",
                            e, err)
    if remainder:
        tmp = f"{paths[0]}.tmp-{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"format_version": 2, "entries": remainder}, f)
        os.replace(tmp, paths[0])
    for p in paths[1 if remainder else 0:]:
        try:
            os.remove(p)
        except OSError:
            pass
    logging.info("replayed %d persisted serve requests from %s",
                 len(reqs), ", ".join(paths))
    return reqs


class DrainController:
    """SIGTERM-armed drain/persist/replay around one batcher."""

    def __init__(
        self,
        batcher,
        persist_path: str,
        drain_deadline_s: float = 30.0,
        registry: Optional[M.MetricsRegistry] = None,
    ):
        self.batcher = batcher
        self.persist_path = persist_path
        self.drain_deadline_s = drain_deadline_s
        self._prev_handler = None
        self._done = threading.Event()
        reg = registry or M.registry
        self._c_persisted = reg.counter("serve_requests_persisted_total")
        self._c_replayed = reg.counter("serve_requests_replayed_total")
        self._g_drain_s = reg.gauge("serve_last_drain_duration_s")

    def quiesce(self) -> None:
        """Phase 1 only: the batcher stops admitting while active decodes
        keep stepping."""
        self.batcher.quiesce()

    def shutdown(self) -> dict:
        """Run the full drain sequence; idempotent. Returns
        ``{"drained": n_finished_during_drain, "persisted": n}``."""
        if self._done.is_set():
            return {"drained": 0, "persisted": 0}
        self._done.set()
        t0 = time.monotonic()
        drained, leftovers = self.batcher.drain(self.drain_deadline_s)
        persisted = 0
        if leftovers:
            persisted = persist_requests(self.persist_path, leftovers)
            self._c_persisted.inc(persisted)
            logging.info(
                "drain: %d in-flight finished, %d undrained persisted -> %s",
                drained, persisted, self.persist_path)
        self._g_drain_s.set(time.monotonic() - t0)
        return {"drained": drained, "persisted": persisted}

    def replay(self) -> List:
        """Resubmit any previously persisted queue (restart path)."""
        reqs = replay_requests(self.persist_path, self.batcher)
        self._c_replayed.inc(len(reqs))
        return reqs

    def install_preempt_hook(self, signum: int = signal.SIGTERM) -> None:
        """Arm ``signum`` to run :meth:`shutdown`, then hand the signal on:
        a previous Python handler is called (a training snapshot hook on
        the same signal still fires), else the default disposition
        terminates the process once the queue is persisted. Main thread
        only (CPython's signal rule)."""
        if self._prev_handler is not None:
            return

        def handler(sig, frame):
            logging.info("signal %d: draining serve batcher", sig)
            try:
                self.shutdown()
            except Exception:  # noqa: BLE001 - exit path must not throw
                logging.warning("serve drain failed", exc_info=True)
            from autodist_tpu_torch.ft.snapshot import _chain_signal

            _chain_signal(sig, frame, self._prev_handler)

        self._prev_handler = signal.signal(signum, handler) or signal.SIG_DFL
