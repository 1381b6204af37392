"""Strategy choice on both packages, for the port's cost-model, Auto and
explain tests.

- ``ZOO``: the zoo models at small widths (bert_base, ResNet-18, LM1B's
  ``lstm_lm``, NCF, the MoE, the causal transformer, the MLP).
- ``items(model)``: (JAX ModelItem, port ModelItem) of the same numpy
  parameters and example batch, the loss traced on both sides, the zoo's
  sparse and expert names given, Adam's slots.
- ``EQUAL``: one set of constants in both packages' spelling: the JAX
  package's default ICI / DCN bandwidths and latencies and a v5e's HBM, as
  the port's node model (``gpu:``) and as the JAX package's (``tpu:``), so
  the two cost models price with the same numbers.
- ``specs(name)``: (JAX ResourceSpec, port ResourceSpec) of one cluster
  (``MESHES``: one node of 8, four nodes of 4, a {data 2, model 4} mesh on
  8) under ``EQUAL``.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import torch

from autodist_tpu import model_item as jmi
from autodist_tpu.models import get_model as jax_get_model
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu_torch import model_item as tmi
from autodist_tpu_torch.models import get_model_spec
from autodist_tpu_torch.models.convert import params_from_jax
from autodist_tpu_torch.resource_spec import ResourceSpec

ZOO = {
    "bert_base": dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4, d_ff=64,
                      max_seq_len=16),
    "resnet": dict(depth=18, num_classes=10, image_size=32),
    "lstm_lm": dict(vocab_size=50, embed_dim=16, hidden=32, num_layers=2, seq_len=8),
    "ncf": dict(num_users=50, num_items=40, mf_dim=8, mlp_dims=(16, 16, 8)),
    "moe_transformer": dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4, d_ff=64,
                            max_seq_len=16, num_experts=4),
    "transformer": dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4, d_ff=64,
                        max_seq_len=16),
    "mlp": {},
}
BATCH = 8

EQUAL = {
    "tpu": {"ici_bandwidth_gbps": 900.0, "dcn_bandwidth_gbps": 50.0, "hbm_gb": 16.0,
            "hbm_gb_per_s": 819.0},
    "gpu": {"nvlink_gbps": 900.0, "network_gbps": 50.0, "hbm_gb": 16.0,
            "hbm_gb_per_s": 819.0, "intra_latency_us": 5.0, "inter_latency_us": 100.0},
}

MESHES = {
    "1x8": {"nodes": [{"address": "localhost", "chips": 8, "chief": True}]},
    "4x4": {"nodes": [{"address": f"10.0.0.{i}", "chips": 4, "chief": i == 1}
                      for i in range(1, 5)]},
    "data2xmodel4": {"nodes": [{"address": "localhost", "chips": 8, "chief": True}],
                     "mesh": {"data": 2, "model": 4}},
}


def specs(mesh: str, **gpu):
    """(JAX ResourceSpec, port ResourceSpec) of ``MESHES[mesh]`` under
    ``EQUAL`` (``gpu`` overrides both blocks' matching figures)."""
    d = dict(MESHES[mesh], tpu=dict(EQUAL["tpu"]), gpu=dict(EQUAL["gpu"], **gpu))
    if "hbm_gb" in gpu:
        d["tpu"]["hbm_gb"] = gpu["hbm_gb"]
    return JResourceSpec(resource_dict=d), ResourceSpec(resource_dict=d)


@functools.lru_cache(maxsize=None)
def items(model: str, opt: str = "adam"):
    """(JAX ModelItem, port ModelItem) of a zoo model at ``ZOO``'s widths."""
    js, ts = jax_get_model(model, **ZOO[model]), get_model_spec(model, **ZOO[model])
    rng = np.random.default_rng(0)
    jparams = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(s.dtype),
                           jax.eval_shape(js.init, jax.random.PRNGKey(0)))
    jbatch = js.example_batch(BATCH)
    jbatch = ({k: np.asarray(v) for k, v in jbatch.items()} if isinstance(jbatch, dict)
              else jax.tree.map(np.asarray, jbatch))
    tbatch = jax.tree.map(lambda v: torch.from_numpy(np.array(v)), jbatch)
    jitem = jmi.ModelItem.from_params(
        jparams, optimizer_spec=jmi.OptimizerSpec(opt), loss_fn=js.loss_fn,
        example_batch=jbatch, sparse_names=tuple(js.sparse_names or ()),
        expert_names=tuple(getattr(js, "expert_names", ()) or ()))
    titem = tmi.ModelItem.from_params(
        params_from_jax(jparams, device="cpu"), optimizer_spec=tmi.OptimizerSpec(opt),
        loss_fn=ts.loss_fn, example_batch=tbatch, sparse_names=tuple(ts.sparse_names),
        expert_names=tuple(ts.expert_names or ()))
    return jitem, titem


def slates(full: bool = True):
    """(JAX slate, port slate) of ``candidate_slate(full=full)``, with
    RandomAxisPartitionAR seeded alike on both sides (its default seed is
    the process's draw)."""
    from autodist_tpu.strategy import cost_model as jcm
    from autodist_tpu.strategy.random_axis_partition_all_reduce_strategy import (
        RandomAxisPartitionAR as JRandomAxis)
    from autodist_tpu_torch.strategy import cost_model as tcm
    from autodist_tpu_torch.strategy.random_axis_partition_all_reduce_strategy import (
        RandomAxisPartitionAR)

    def seeded(slate, cls):
        return [(n, cls(chunk_size=128, seed=3) if n == "RandomAxisPartitionAR" else b)
                for n, b in slate]

    return (seeded(jcm.candidate_slate(full=full), JRandomAxis),
            seeded(tcm.candidate_slate(full=full), RandomAxisPartitionAR))
