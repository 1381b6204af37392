"""Persistent plan cache: search once, reuse the winning Strategy (PyTorch
port of the JAX package's ``plan/cache.py``).

The cache keys the question — a model fingerprint (the serialized
:class:`~autodist_tpu_torch.model_item.ModelItem`: variable names, shapes,
dtypes and flags, the optimizer), the
:class:`~autodist_tpu_torch.resource_spec.ResourceSpec` digest and the
package version — and stores the answer: the winning Strategy JSON and its
search provenance. The same question again skips the search and returns
byte-identical Strategy JSON.

A cached plan is validated before it is believed:

- integrity: ``meta.json`` carries a sha256 of the strategy bytes; a
  mismatch (torn write, hand edit) is a loud warning and a fresh search,
  never a crash;
- lowering and analysis (:func:`dryrun_lowers`): when this process's group
  has the spec's GPU count, the plan is compiled against the current model,
  lowered to a ``ShardingPlan`` on the mesh and checked by
  :func:`~autodist_tpu_torch.analysis.analyze_plan` (degradation drift,
  per-GPU memory, the schedule screen); a plan that no longer lowers or
  trips the analyzer is evicted with the finding in the warning.

Layout: ``<dir>/<key>/{strategy.json, provenance.json, meta.json}``, written
to a temporary directory and renamed into place.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
from dataclasses import dataclass, field
from typing import Dict, Optional

from autodist_tpu_torch.model_item import ModelItem
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.ir import Strategy
from autodist_tpu_torch.utils import logging, retry

CACHE_FORMAT = 1


def default_cache_dir() -> str:
    from autodist_tpu_torch import const
    from autodist_tpu_torch.const import ENV

    return ENV.AUTODIST_PLAN_CACHE.val or os.path.join(const.DEFAULT_PLAN_DIR, "cache")


def model_fingerprint(model_item: ModelItem) -> str:
    """Digest of everything the planner's answer depends on in the model:
    the serialized ModelItem."""
    blob = json.dumps(model_item.to_json(), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


def plan_key(model_item: ModelItem, resource_spec: ResourceSpec,
             version: Optional[str] = None) -> str:
    """The cache key: (model fingerprint, resource digest, package
    version). A new version may change lowering or pricing, so an old
    winner searches again rather than loading."""
    if version is None:
        import autodist_tpu_torch

        version = autodist_tpu_torch.__version__
    blob = "\n".join([
        f"format={CACHE_FORMAT}",
        f"model={model_fingerprint(model_item)}",
        f"resources={resource_spec.fingerprint()}",
        f"version={version}",
    ]).encode()
    return hashlib.sha256(blob).hexdigest()[:32]


def dryrun_lowers(strategy: Strategy, model_item: ModelItem,
                  resource_spec: ResourceSpec) -> bool:
    """Lower ``strategy`` against the current model on the mesh and analyze
    the plan: ``StrategyCompiler`` validation, ``GraphTransformer.transform``
    into a ``ShardingPlan``, then :func:`analyze_plan` (degradation drift,
    per-GPU memory, the schedule screen). Raises on a plan that no longer
    lowers, and ``AnalysisError`` on one with an error finding.

    Returns True when it validated. It skips, returning False with a debug
    log, when this process's group (world size 1 without one) does not
    have the GPU count of the spec's mesh, which ``build_mesh`` demands: a
    chief planning offline for a bigger fleet is a legitimate caller. In a
    group the plan is lowered on a logical mesh of the spec's axes, the
    only part of the mesh the lowering reads: the live ``DeviceMesh`` is a
    collective of every rank, and only the planning rank is here."""
    import copy

    import torch

    from autodist_tpu_torch.analysis import AnalysisError, analyze_plan
    from autodist_tpu_torch.kernel import GraphTransformer
    from autodist_tpu_torch.kernel.mesh import AXES, Mesh, build_mesh
    from autodist_tpu_torch.strategy.base import StrategyCompiler

    shape = resource_spec.mesh_shape(AXES)
    want = math.prod(shape.values())
    dist = torch.distributed
    have = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if have != want:
        logging.debug("plan cache: dryrun validation skipped (runtime has %s devices, "
                      "spec wants %d)", have, want)
        return False
    device = "cuda" if torch.cuda.is_available() else "cpu"
    mesh = (build_mesh(resource_spec, device=device) if have == 1
            else Mesh.logical(shape, device=device))
    # StrategyCompiler prunes node_config in place: validate a copy.
    compiled = StrategyCompiler(model_item).compile(copy.deepcopy(strategy))
    plan = GraphTransformer(compiled, model_item, mesh).transform()
    report = analyze_plan(plan, strategy=compiled, resource_spec=resource_spec,
                          optimizer=model_item.optimizer_spec.name, program="plan-cache",
                          model_item=model_item)
    if not report.ok:
        raise AnalysisError(report)
    return True


@dataclass
class CacheEntry:
    strategy: Strategy
    provenance: Dict
    path: str
    key: str
    strategy_bytes: bytes = b""
    #: True when :func:`dryrun_lowers` lowered and analyzed the entry on
    #: this process's mesh; False when it skipped or did not run.
    validated: bool = False


@dataclass
class PlanCache:
    """Filesystem plan cache with hit/miss accounting."""

    cache_dir: str = field(default_factory=default_cache_dir)
    validate: bool = True
    stats: Dict[str, int] = field(default_factory=lambda: {
        "hits": 0, "misses": 0, "invalidated": 0})

    def _entry_dir(self, key: str) -> str:
        return os.path.join(self.cache_dir, key)

    def _read_files(self, key: str) -> Optional[CacheEntry]:
        """One integrity-checked read of an entry's files (no lowering):
        raises on any defect, None when the entry does not exist."""
        d = self._entry_dir(key)
        spath = os.path.join(d, "strategy.json")
        if not os.path.exists(spath):
            return None
        with open(spath, "rb") as f:
            raw = f.read()
        with open(os.path.join(d, "meta.json"), "r", encoding="utf-8") as f:
            meta = json.load(f)
        if meta.get("strategy_sha256") != hashlib.sha256(raw).hexdigest():
            raise ValueError("strategy.json checksum mismatch")
        strategy = Strategy.from_json(json.loads(raw.decode("utf-8")))
        if not strategy.node_config:
            raise ValueError("cached strategy has no node configs")
        try:
            with open(os.path.join(d, "provenance.json"), "r", encoding="utf-8") as f:
                provenance = json.load(f)
        except (OSError, ValueError):
            provenance = {}  # provenance is advisory; the plan's integrity is not
        return CacheEntry(strategy=strategy, provenance=provenance, path=d, key=key,
                          strategy_bytes=raw)

    def get(self, model_item: ModelItem, resource_spec: ResourceSpec,
            version: Optional[str] = None) -> Optional[CacheEntry]:
        """The validated cached winner for this (model, resources,
        version), or None (a miss). A defective entry is evicted with a
        warning and is a miss too; it never raises."""
        key = plan_key(model_item, resource_spec, version)
        d = self._entry_dir(key)
        try:
            # A same-key writer replacing the entry mid-read gives a mixed
            # view: one short retry of the file read sees the settled files
            # (the dry run below is deterministic and is not retried).
            try:
                entry = retry.retry_call(
                    lambda: self._read_files(key),
                    policy=retry.RetryPolicy(initial_s=0.05, max_s=0.05, max_attempts=2),
                    describe=f"plan cache read {key}")
            except retry.RetryError as e:
                raise e.__cause__ or e
            if entry is not None and self.validate:
                entry.validated = dryrun_lowers(entry.strategy, model_item, resource_spec)
        except Exception as e:  # noqa: BLE001 - any defect => fresh search
            logging.warning("plan cache: entry %s is invalid (%s); evicting and falling "
                            "back to a fresh search", key, e)
            self.stats["invalidated"] += 1
            self.stats["misses"] += 1
            shutil.rmtree(d, ignore_errors=True)
            return None
        if entry is None:
            self.stats["misses"] += 1
            return None
        self.stats["hits"] += 1
        # entry.strategy.path stays as serialized: the hit must re-serialize
        # byte for byte; the entry's location rides CacheEntry.path.
        logging.info("plan cache HIT %s (%s)", key, entry.path)
        return entry

    def put(self, model_item: ModelItem, resource_spec: ResourceSpec, strategy: Strategy,
            provenance: Optional[Dict] = None, version: Optional[str] = None) -> str:
        """Persist a winner; returns the entry directory. Files are staged
        in a temporary directory and renamed into place, so a killed writer
        never leaves a half-written entry; two same-key writers: the last
        wins (a lost rename is retried once, then the other's entry
        stands)."""
        key = plan_key(model_item, resource_spec, version)
        d = self._entry_dir(key)
        os.makedirs(self.cache_dir, exist_ok=True)
        tmp = os.path.join(self.cache_dir, f".tmp-{os.getpid()}-{key}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        if not strategy.id:
            strategy.id = Strategy.new_id(resource_spec.fingerprint())
        raw = json.dumps(strategy.to_json(), indent=2, sort_keys=True).encode("utf-8")
        with open(os.path.join(tmp, "strategy.json"), "wb") as f:
            f.write(raw)
        with open(os.path.join(tmp, "provenance.json"), "w", encoding="utf-8") as f:
            json.dump(provenance or {}, f, indent=2, sort_keys=True, default=float)
        with open(os.path.join(tmp, "meta.json"), "w", encoding="utf-8") as f:
            json.dump({
                "format": CACHE_FORMAT,
                "key": key,
                "strategy_id": strategy.id,
                "strategy_sha256": hashlib.sha256(raw).hexdigest(),
                "model_fingerprint": model_fingerprint(model_item),
                "resource_fingerprint": resource_spec.fingerprint(),
            }, f, indent=2, sort_keys=True)
        shutil.rmtree(d, ignore_errors=True)
        try:
            os.replace(tmp, d)
        except OSError:
            shutil.rmtree(d, ignore_errors=True)
            try:
                os.replace(tmp, d)
            except OSError as e:
                shutil.rmtree(tmp, ignore_errors=True)
                logging.warning("plan cache: concurrent writer won entry %s (%s); "
                                "keeping theirs", key, e)
                return d
        logging.info("plan cache STORE %s -> %s", key, d)
        return d
