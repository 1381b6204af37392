"""Beam search over the per-variable strategy space (PyTorch port of the
JAX package's ``plan/search.py``).

``Auto`` ranks a fixed slate of whole-model policies; the real decision
space is per variable — each trainable variable chooses a synchronizer
(AllReduce, ZeRO-1, a PS residency), a partition axis and a fusion group,
and the plan chooses a gradient bucket size. The search scores candidates
with :class:`~autodist_tpu_torch.strategy.cost_model.CostModel`
(optionally through a fitted
:class:`~autodist_tpu_torch.plan.calibrate.TopologyCalibration`); no
candidate is lowered or run, so hundreds of plans cost milliseconds. The
winner is an ordinary Strategy that lowers through ``kernel/lowering.py``
like any builder's.

Genome (one :class:`VarGene` per trainable variable, model order):

- ``kind``: ``"ar"`` (AllReduce), ``"zero1"`` (AllReduce with
  ``shard_update``), ``"ps1"`` (PS with a local proxy), ``"ps3"`` (PS
  without);
- ``axis``: partition axis (``None``: unpartitioned), its shard count the
  largest divisor of the axis length up to the mesh degree;
- ``group``: fusion group id (AllReduce only);
- ``dest``: index into the PS reduction destinations;

plus the genome-wide ``bucket_bytes`` (:data:`BUCKET_GENE_CHOICES`), the
gradient bucketing target ``kernel/bucketing.py`` renders.

Seeds come from ``candidate_slate()``, so the search starts from every
policy ``Auto`` knows and never returns worse than the best of them. The
draws of ``random.Random(seed)`` are the JAX package's, in its order, so
one seed visits the same candidates in both packages.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from autodist_tpu_torch.model_item import ModelItem
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.base import reduction_devices, replica_devices
from autodist_tpu_torch.strategy.cost_model import CostModel, StrategyCost, candidate_slate
from autodist_tpu_torch.strategy.ir import (
    AllReduceSynchronizer,
    NodeConfig,
    PSSynchronizer,
    Strategy,
)
from autodist_tpu_torch.utils import logging

KINDS = ("ar", "ps1", "ps3", "zero1")
CHUNK_SIZES = (1, 32, 128, 512)

#: The bucket-size gene: 0 keeps the one sync after the backward; a target
#: buckets the gradient collectives inside it (``kernel/bucketing.py``).
BUCKET_GENE_CHOICES = (0, 1 << 20, 4 << 20, 16 << 20, 64 << 20)


@dataclass(frozen=True)
class VarGene:
    """One variable's slot in the genome."""

    kind: str = "ar"
    axis: Optional[int] = None
    group: int = 0
    dest: int = 0


@dataclass(frozen=True, eq=False)
class PlanGenome:
    """A candidate plan: per-variable genes and the genome-wide bucket
    size. Hashable (the beam's key); an unbucketed genome equals, and
    hashes like, the tuple of its genes."""

    genes: Tuple[VarGene, ...]
    bucket_bytes: int = 0

    def __len__(self) -> int:
        return len(self.genes)

    def __iter__(self):
        return iter(self.genes)

    def __eq__(self, other):
        if isinstance(other, PlanGenome):
            return self.genes == other.genes and self.bucket_bytes == other.bucket_bytes
        if isinstance(other, tuple):
            return self.bucket_bytes == 0 and self.genes == other
        return NotImplemented

    def __hash__(self):
        if self.bucket_bytes == 0:
            return hash(self.genes)
        return hash((self.genes, self.bucket_bytes))


Genome = PlanGenome


def _as_genome(genome) -> PlanGenome:
    return genome if isinstance(genome, PlanGenome) else PlanGenome(genes=tuple(genome))


def _shard_count(dim: int, degree: int) -> int:
    """The largest divisor of ``dim`` up to the mesh shard ``degree``."""
    for k in range(min(dim, degree), 1, -1):
        if dim % k == 0:
            return k
    return 1


def genome_to_strategy(genome, model_item: ModelItem,
                       resource_spec: ResourceSpec) -> Strategy:
    """Render a genome as a Strategy (node configs only, no per-shard
    tables); the bucket gene lands on ``graph_config.bucket_bytes``."""
    genome = _as_genome(genome)
    variables = model_item.trainable_variables
    if len(genome.genes) != len(variables):
        raise ValueError(f"genome length {len(genome.genes)} != {len(variables)} "
                         f"trainable vars")
    dests = reduction_devices(resource_spec)
    mesh_shape = resource_spec.mesh_shape(("data", "model"))
    n_model = max(int(mesh_shape.get("model", 1)), 1)
    n_data = max(int(mesh_shape.get("data", 1)), 1)
    degree = n_model if n_model > 1 else n_data

    strategy = Strategy(id=Strategy.new_id(resource_spec.fingerprint()))
    strategy.graph_config.replicas = replica_devices(resource_spec)
    strategy.graph_config.bucket_bytes = int(genome.bucket_bytes)
    for var, gene in zip(variables, genome.genes):
        partitioner = ""
        # A zero1 gene renders unpartitioned: a partitioned variable
        # already shards its update.
        if gene.axis is not None and gene.axis < len(var.shape) and gene.kind != "zero1":
            k = _shard_count(int(var.shape[gene.axis]), degree)
            if k > 1:
                parts = [1] * len(var.shape)
                parts[gene.axis] = k
                partitioner = ",".join(map(str, parts))
        if gene.kind == "ar":
            sync = AllReduceSynchronizer(group=gene.group)
        elif gene.kind == "zero1":
            sync = AllReduceSynchronizer(group=gene.group, shard_update=True)
        else:
            sync = PSSynchronizer(reduction_destination=dests[gene.dest % len(dests)],
                                  local_replication=(gene.kind == "ps1"))
        strategy.node_config.append(
            NodeConfig(var_name=var.name, synchronizer=sync, partitioner=partitioner))
    return strategy


def strategy_to_genome(strategy: Strategy, model_item: ModelItem,
                       resource_spec: ResourceSpec) -> PlanGenome:
    """Project a built Strategy onto the genome space (seeding): per-shard
    tables collapse to their node settings, unknown destinations map to
    index 0, ``bucket_bytes`` to the bucket gene."""
    dests = {d: i for i, d in enumerate(reduction_devices(resource_spec))}
    genes: List[VarGene] = []
    for var in model_item.trainable_variables:
        node = strategy.node_config_for(var.name)
        if node is None:
            genes.append(VarGene())
            continue
        sync = node.synchronizer
        try:
            axis = node.active_partition_axis
        except ValueError:
            axis = None  # a table with several active axes has no gene
        if isinstance(sync, AllReduceSynchronizer):
            kind = "zero1" if (sync.shard_update and axis is None) else "ar"
            genes.append(VarGene(kind=kind, axis=axis, group=sync.group))
        else:
            genes.append(VarGene(kind="ps1" if sync.local_replication else "ps3", axis=axis,
                                 dest=dests.get(sync.reduction_destination, 0)))
    return PlanGenome(genes=tuple(genes),
                      bucket_bytes=int(getattr(strategy.graph_config, "bucket_bytes", 0) or 0))


def _objective(cost: StrategyCost, calibration=None) -> Tuple[bool, float]:
    """Feasible first, lower better (``CostModel.rank``'s shape): an
    infeasible candidate compares on footprint, so a model too big to
    replicate still gets the least-over-budget plan."""
    if not cost.feasible:
        return (True, cost.per_chip_bytes)
    if calibration is not None:
        return (False, calibration.predict_s(cost))
    return (False, cost.total_s)


@dataclass
class SearchConfig:
    """Search knobs. The defaults visit about a hundred candidates of cost
    model arithmetic."""

    beam_width: int = 4
    generations: int = 4
    mutations_per_survivor: int = 8
    seed: int = 0
    include_sparse_seeds: bool = True
    # Also price the winner under other (data, model) factorizations of
    # the GPU count: advisory, in the provenance.
    search_mesh: bool = False
    max_mesh_candidates: int = 6


@dataclass
class SearchResult:
    strategy: Strategy
    cost: StrategyCost
    genome: PlanGenome
    n_visited: int
    provenance: Dict = field(default_factory=dict)


class PlanSearch:
    """Beam search seeded by the Auto slate, scored by the cost model."""

    def __init__(self, model_item: ModelItem, resource_spec: ResourceSpec,
                 config: Optional[SearchConfig] = None, calibration=None):
        self.model_item = model_item
        self.spec = resource_spec
        self.config = config or SearchConfig()
        self.calibration = calibration
        self.cost_model = CostModel(model_item, resource_spec)
        self._rng = random.Random(self.config.seed)
        # Candidate partition axes: every axis of length >= 2, and none.
        self._axes_by_var = [[None] + [i for i, d in enumerate(v.shape) if int(d) >= 2]
                             for v in self.model_item.trainable_variables]
        self._n_dests = max(len(reduction_devices(resource_spec)), 1)
        # Seeds the static screens rejected before pricing: {name: [codes]}.
        self._screen_rejected: Dict[str, List[str]] = {}

    # ------------------------------------------------------------------ seeds
    def _seed_slate(self) -> Tuple[Dict[str, Strategy], Dict[str, PlanGenome]]:
        """(the built lossless slate strategies, every seed's genome).

        The built strategies compete directly, so the winner is never worse
        than what Auto would emit (a genome projection can lose per-shard
        details). Compressed slate members only seed mutation, through
        their projection (compressor dropped). A seed the static screens
        reject (SLS001: cannot lower; SLO001/SLM003: its bucketing cannot
        overlap or its peak cannot fit) is never priced."""
        from autodist_tpu_torch.analysis import screen_schedule, screen_strategy
        from autodist_tpu_torch.strategy.explain import _lossy

        built: Dict[str, Strategy] = {}
        genomes: Dict[str, PlanGenome] = {}
        for name, builder in candidate_slate(include_sparse=self.config.include_sparse_seeds,
                                             full=True):
            try:
                strategy = builder.build(self.model_item, self.spec)
            except Exception as e:  # noqa: BLE001 - skip unbuildable seeds
                logging.debug("plan search: seed %s failed to build (%s)", name, e)
                continue
            findings = [f for f in (screen_strategy(strategy, self.model_item, self.spec)
                                    + screen_schedule(strategy, self.model_item, self.spec))
                        if f.severity == "error"]
            if findings:
                self._screen_rejected[name] = [f.code for f in findings]
                logging.warning("plan search: seed %s rejected by the static screen (%s)",
                                name, "; ".join(f.render() for f in findings))
                continue
            if not _lossy(strategy):
                built[name] = strategy
            genomes[name] = strategy_to_genome(strategy, self.model_item, self.spec)
        if not genomes:
            # Degenerate fallback: all-AllReduce (always buildable).
            genomes["AllReduce"] = PlanGenome(genes=tuple(
                VarGene() for _ in self.model_item.trainable_variables))
        return built, genomes

    # -------------------------------------------------------------- mutation
    def _mutate(self, genome) -> PlanGenome:
        genome = _as_genome(genome)
        genes = list(genome.genes)
        bucket = genome.bucket_bytes
        if not genes:
            return genome
        if self._rng.random() < 0.12:
            return PlanGenome(genes=tuple(genes),
                              bucket_bytes=self._rng.choice(BUCKET_GENE_CHOICES))
        i = self._rng.randrange(len(genes))
        g = genes[i]
        move = self._rng.random()
        if move < 0.4:
            g = VarGene(kind=self._rng.choice(KINDS), axis=g.axis, group=g.group, dest=g.dest)
        elif move < 0.7:
            g = VarGene(kind=g.kind, axis=self._rng.choice(self._axes_by_var[i]),
                        group=g.group, dest=g.dest)
        elif move < 0.85 and g.kind != "ar":
            g = VarGene(kind=g.kind, axis=g.axis, group=g.group,
                        dest=self._rng.randrange(self._n_dests))
        else:
            # Re-chunk the whole genome's fusion groups.
            chunk = self._rng.choice(CHUNK_SIZES)
            genes = [VarGene(kind=x.kind, axis=x.axis, group=j // chunk, dest=x.dest)
                     for j, x in enumerate(genes)]
            return PlanGenome(genes=tuple(genes), bucket_bytes=bucket)
        genes[i] = g
        return PlanGenome(genes=tuple(genes), bucket_bytes=bucket)

    # ----------------------------------------------------------------- score
    def _score(self, genome) -> Tuple[Tuple[bool, float], StrategyCost]:
        strategy = genome_to_strategy(genome, self.model_item, self.spec)
        cost = self.cost_model.strategy_cost(strategy)
        return _objective(cost, self.calibration), cost

    def _screen_genome(self, genome) -> List[str]:
        """The schedule screen of a mutated child before pricing (a rendered
        genome is well formed, so SLS001 is not run)."""
        from autodist_tpu_torch.analysis import screen_schedule

        strategy = genome_to_strategy(genome, self.model_item, self.spec)
        return sorted({f.code for f in screen_schedule(strategy, self.model_item, self.spec)
                       if f.severity == "error"})

    # ------------------------------------------------------------------- run
    def run(self) -> SearchResult:
        cfg = self.config
        slate, seeds = self._seed_slate()
        scored: Dict[PlanGenome, Tuple[Tuple[bool, float], StrategyCost]] = {}
        origin: Dict[PlanGenome, str] = {}

        def row(cost: StrategyCost) -> dict:
            return {"predicted_s": cost.total_s, "feasible": cost.feasible,
                    "per_chip_gb": cost.per_chip_bytes / 1e9}

        # Direct slate candidates: the exact strategies Auto's builders emit.
        slate_scored = {}
        for name, s in slate.items():
            cost = self.cost_model.strategy_cost(s)
            slate_scored[name] = (_objective(cost, self.calibration), cost)
        seed_rows = {name: row(cost) for name, (_, cost) in slate_scored.items()}
        for name, genome in seeds.items():
            if genome not in scored:
                scored[genome] = self._score(genome)
                origin[genome] = f"seed:{name}"
            seed_rows.setdefault(name, row(scored[genome][1]))
        # The bound the winner must meet: the best direct slate strategy
        # (projections stand in only when the whole slate failed to build).
        pool = slate_scored or {n: scored[g] for n, g in seeds.items()}
        best_seed = min(pool, key=lambda n: pool[n][0])
        best_seed_obj, best_seed_cost = pool[best_seed]

        beam = sorted(set(seeds.values()), key=lambda g: scored[g][0])[: cfg.beam_width]
        trajectory = [{"generation": 0, "best_predicted_s": scored[beam[0]][1].total_s,
                       "visited": len(scored) + len(slate_scored)}]
        screened_bad: set = set()
        for gen in range(1, cfg.generations + 1):
            for parent in list(beam):
                for _ in range(cfg.mutations_per_survivor):
                    child = self._mutate(parent)
                    if child in scored or child in screened_bad:
                        continue
                    codes = self._screen_genome(child)
                    if codes:
                        screened_bad.add(child)
                        merged = self._screen_rejected.setdefault("mutations", [])
                        self._screen_rejected["mutations"] = sorted(set(merged) | set(codes))
                        continue
                    scored[child] = self._score(child)
                    origin.setdefault(child, f"{origin.get(parent, '?')}+g{gen}")
            beam = sorted(scored, key=lambda g: scored[g][0])[: cfg.beam_width]
            trajectory.append({"generation": gen,
                               "best_predicted_s": scored[beam[0]][1].total_s,
                               "visited": len(scored) + len(slate_scored)})

        winner = beam[0]
        win_obj, win_cost = scored[winner]
        n_visited = len(scored) + len(slate_scored)
        if win_obj <= best_seed_obj or best_seed not in slate:
            strategy = genome_to_strategy(winner, self.model_item, self.spec)
            winner_origin = origin.get(winner, "?")
        else:
            # A projection can price above the slate strategy it came from:
            # the best slate member wins outright, reported by its
            # projection's genome.
            strategy = slate[best_seed]
            win_obj, win_cost = best_seed_obj, best_seed_cost
            winner_origin = f"slate:{best_seed}"
            winner = seeds.get(best_seed, winner)

        # The sweep prices the emitted strategy, the plan the caller gets.
        mesh_info = self._mesh_sweep(strategy) if cfg.search_mesh else None

        improvement = 0.0
        best_seed_s = seed_rows[best_seed]["predicted_s"]
        if best_seed_s > 0:
            improvement = 1.0 - win_cost.total_s / best_seed_s
        why = (f"predicted {win_cost.total_s * 1e3:.3f} ms/step vs best seed "
               f"{best_seed} at {best_seed_s * 1e3:.3f} ms "
               f"({improvement * 100:+.1f}%), "
               f"{'fits' if win_cost.feasible else 'OVER'} "
               f"{win_cost.per_chip_bytes / 1e9:.2f} GB/chip")
        win_genome = _as_genome(winner)
        provenance = {
            "n_visited": n_visited,
            "beam_width": cfg.beam_width,
            "generations": cfg.generations,
            "search_seed": cfg.seed,
            "seeds": seed_rows,
            "best_seed": best_seed,
            "winner": {
                "origin": winner_origin,
                "predicted_s": win_cost.total_s,
                "comm_s": win_cost.comm_s,
                "update_s": win_cost.update_s,
                "latency_s": win_cost.latency_s,
                "act_sync_s": win_cost.act_sync_s,
                "gather_s": win_cost.gather_s,
                "overlap_s": win_cost.overlap_s,
                "per_chip_gb": win_cost.per_chip_bytes / 1e9,
                "opt_gb_per_chip": win_cost.opt_bytes / 1e9,
                "n_shard_update": sum(1 for g in win_genome.genes if g.kind == "zero1"),
                "bucket_bytes": win_genome.bucket_bytes,
                "feasible": win_cost.feasible,
            },
            "improvement_vs_best_seed": improvement,
            "trajectory": trajectory,
            "bucket_sizes_visited": sorted({_as_genome(g).bucket_bytes for g in scored}),
            "screen_rejected": dict(self._screen_rejected),
            "why": why,
        }
        if self.calibration is not None:
            provenance["calibration"] = {
                "applied": True,
                "predicted_calibrated_s": self.calibration.predict_s(win_cost),
                **self.calibration.describe(),
            }
        if mesh_info is not None:
            provenance["mesh"] = mesh_info
        logging.info("plan search: %s (visited %d candidates)", why, n_visited)
        return SearchResult(strategy=strategy, cost=win_cost, genome=winner,
                            n_visited=n_visited, provenance=provenance)

    # ------------------------------------------------------------------ mesh
    def _mesh_factorizations(self) -> List[Dict[str, int]]:
        """(data, model) factorizations of the GPU count, data at least 2
        on more than one GPU (the cost model leaves out compute, so pure
        model parallelism would look free), modest model degrees first."""
        n = max(self.spec.num_gpus, 1)
        shapes = [{"data": n // model, "model": model} for model in range(1, n + 1)
                  if n % model == 0 and (n // model >= 2 or n == 1)]
        shapes.sort(key=lambda s: s["model"])
        return shapes[: self.config.max_mesh_candidates]

    def _mesh_sweep(self, strategy: Strategy) -> Dict:
        """Price ``strategy`` under other mesh factorizations: a
        recommendation for the spec's ``mesh:`` block (the Strategy itself
        is mesh-agnostic)."""
        rows = {}
        base = dict(self.spec.mesh_shape(("data", "model")))
        for shape in self._mesh_factorizations():
            try:
                variant = ResourceSpec(resource_dict={**self.spec.to_dict(), "mesh": shape})
                cost = CostModel(self.model_item, variant).strategy_cost(strategy)
            except Exception as e:  # noqa: BLE001 - skip invalid shapes
                logging.debug("plan search: mesh %s skipped (%s)", shape, e)
                continue
            rows[f"data={shape['data']},model={shape['model']}"] = {
                "predicted_s": cost.total_s, "feasible": cost.feasible,
                "per_chip_gb": cost.per_chip_bytes / 1e9}
        if not rows:
            return {"searched": True, "candidates": {}}
        feasible = {k: v for k, v in rows.items() if v["feasible"]} or rows
        chosen = min(feasible, key=lambda k: feasible[k]["predicted_s"])
        return {"searched": True, "current": {k: int(v) for k, v in base.items()},
                "chosen": chosen, "candidates": rows}


def search(model_item: ModelItem, resource_spec: ResourceSpec,
           config: Optional[SearchConfig] = None, calibration=None) -> SearchResult:
    """One call over :class:`PlanSearch`."""
    return PlanSearch(model_item, resource_spec, config, calibration).run()
