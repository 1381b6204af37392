"""The port's cost model (``autodist_tpu_torch/strategy/cost_model.py``)
against the JAX package's, and its GPU node model.

- The closed forms of ``tests/test_cost_model.py`` (ring and hierarchical
  all-reduce, one device free, a compressor halving the wire) on the port's
  node model.
- Under equal constants (``helpers/torch_auto.py``'s ``EQUAL``: the same
  bandwidths, latencies and HBM in both packages' spelling), every
  ``StrategyCost`` field of every candidate of the full slate equals JAX's
  ``CostModel``'s (relative 1e-9) in the same rank order, for bert_base,
  ResNet-18, LM1B, NCF, the MoE and the causal transformer on one node of
  8, four nodes of 4 and a {data 2, model 4} mesh.
- Sparse tables priced as touched rows; a compressed sparse table at table
  scale; feasibility; the tie break; ``Calibration`` fit / save / load in
  the port's working directory; the H100 node model (HBM table, ``gpu:``
  block, ``from_local_devices`` on a card).
"""
import dataclasses

import numpy as np
import pytest
import torch

from autodist_tpu.strategy import cost_model as jcm
from autodist_tpu_torch import const
from autodist_tpu_torch import resource_spec as trs
from autodist_tpu_torch.model_item import ModelItem, OptimizerSpec
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import (PS, AllReduce, CostModel, Parallax,
                                         PSLoadBalancing)
from autodist_tpu_torch.strategy import cost_model as tcm
from helpers import torch_auto as ta

MODELS = ("bert_base", "resnet", "lstm_lm", "ncf", "moe_transformer", "transformer")


def _item(shapes, opt="sgd", sparse=()):
    params = {k: torch.zeros(s) for k, s in shapes.items()}
    return ModelItem.from_params(params, optimizer_spec=OptimizerSpec(opt),
                                 sparse_names=sparse)


def _single(gpus=8, **gpu):
    d = {"nodes": [{"address": "localhost", "gpus": gpus, "chief": True}]}
    return ResourceSpec(resource_dict=dict(d, gpu=gpu) if gpu else d)


def _multi(nodes=4, gpus=4, **gpu):
    d = {"nodes": [{"address": f"10.0.0.{i}", "gpus": gpus, "chief": i == 1}
                   for i in range(1, nodes + 1)]}
    return ResourceSpec(resource_dict=dict(d, gpu=gpu) if gpu else d)


# ---------------------------------------------------------------- primitives
def test_single_node_ring_allreduce_closed_form():
    cm = CostModel(_item({"w": (4, 4)}), _single(8, nvlink_gbps=800.0))
    bw = 800.0e9 / 8.0
    assert cm.allreduce_s(1e9) == pytest.approx(2.0 * 1e9 * 7 / 8 / bw)


def test_node_without_nvlink_rides_pcie():
    cm = CostModel(_item({"w": (4, 4)}), _single(8, nvlink_gbps=0.0, pcie_gbps=512.0))
    assert cm.allreduce_s(1e9) == pytest.approx(2.0 * 1e9 * 7 / 8 / (512.0e9 / 8))


def test_hierarchical_allreduce_crosses_the_network():
    cm = CostModel(_item({"w": (4, 4)}), _multi(4, 4, nvlink_gbps=800.0,
                                                 network_gbps=100.0))
    intra = 2 * 1e9 * 3 / 4 / (800.0e9 / 8)
    inter = 2 * (1e9 / 4) * 3 / 4 / (100.0e9 / 8)
    assert cm.allreduce_s(1e9) == pytest.approx(intra + inter)
    assert cm.latency == pytest.approx(trs.DEFAULT_INTER_LATENCY_US * 1e-6)


def test_one_gpu_is_free():
    cm = CostModel(_item({"w": (4, 4)}), _single(1))
    assert cm.allreduce_s(1e9) == 0.0 and cm.latency == 0.0


def test_compressor_halves_wire_bytes():
    item, spec = _item({"w": (1024, 1024)}), _single()
    cm = CostModel(item, spec)
    plain = cm.strategy_cost(AllReduce().build(item, spec))
    comp = cm.strategy_cost(AllReduce(compressor="HorovodCompressor").build(item, spec))
    assert tcm.compressor_wire_factor("HorovodCompressor", (1024, 1024)) == 0.5
    assert comp.comm_s == pytest.approx(plain.comm_s * 0.5)


def test_policy_constants_equal_jax():
    """The figures the port keeps as JAX's policy, not measured on the card."""
    for name in ("OVERLAP_EXPOSED_FRACTION", "NEAR_TIE_REL", "NEAR_TIE_REL_MULTI",
                 "HBM_USABLE_FRACTION", "DEFAULT_SPARSE_TOUCH", "OPTIMIZER_SLOT_FACTOR"):
        assert getattr(tcm, name) == getattr(jcm, name), name


# ------------------------------------------------------------ JAX parity
@pytest.mark.parametrize("mesh", sorted(ta.MESHES))
@pytest.mark.parametrize("model", MODELS)
def test_every_cost_field_and_rank_equal_jax(model, mesh):
    jitem, titem = ta.items(model)
    jrs, trs_ = ta.specs(mesh)
    jm, tm = jcm.CostModel(jitem, jrs), CostModel(titem, trs_)
    jslate, tslate = ta.slates()
    jr = jm.rank([(n, b.build(jitem, jrs)) for n, b in jslate])
    tr = tm.rank([(n, b.build(titem, trs_)) for n, b in tslate])
    assert [n for n, _ in tr] == [n for n, _ in jr]
    for (name, jc), (_, tc) in zip(jr, tr):
        for f in dataclasses.fields(jc):
            np.testing.assert_allclose(getattr(tc, f.name), getattr(jc, f.name), rtol=1e-9,
                                       atol=0, err_msg=f"{model} {mesh} {name} {f.name}")
        np.testing.assert_allclose(tc.total_s, jc.total_s, rtol=1e-9, atol=0)
        assert tc.feasible == jc.feasible


def test_slate_and_preference_equal_jax():
    assert tcm.SLATE_PREFERENCE == jcm.SLATE_PREFERENCE
    for full in (False, True):
        assert [n for n, _ in tcm.candidate_slate(full=full)] == \
            [n for n, _ in jcm.candidate_slate(full=full)]
    assert [n for n in tcm.SLATE_PREFERENCE if n in dict(tcm.candidate_slate(full=True))] \
        == [n for n, _ in tcm.candidate_slate(full=True)]
    for table in ({"TensorParallel": 0.000879, "AllReduce": 0.000884,
                   "PartitionedAR": 0.000889, "PS(zero1)": 0.00248},
                  {"TensorParallel": 0.00060, "AllReduce": 0.000884}):
        assert tcm.preferred_prediction(table) == jcm.preferred_prediction(table)


def test_bucket_exclusion_reasons_equal_jax():
    from autodist_tpu.kernel.bucketing import bucket_exclusion_reasons as jreasons
    from autodist_tpu_torch.kernel.bucketing import bucket_exclusion_reasons

    for shape in ((), (7,), (8, 4), (26, 8), (3, 5)):
        for kw in (dict(), dict(trainable=False), dict(is_ps=True),
                   dict(sparse_update=True), dict(expert=True, n_expert=2),
                   dict(part_axis=0), dict(compressor="bf16")):
            for n_data, n_model in ((1, 1), (4, 1), (2, 2), (8, 1)):
                kw2 = dict(kw, n_data=n_data, n_model=n_model)
                if shape == () and "part_axis" in kw2:
                    continue
                assert bucket_exclusion_reasons(shape, **kw2) == jreasons(shape, **kw2)


# ----------------------------------------------------------------- sparse
def test_sparse_sync_priced_as_touched_rows_not_table():
    item = _item({"emb": (1 << 20, 128), "w": (128, 128)}, sparse=("emb",))
    spec = _single()
    cm = CostModel(item, spec)
    parallax = cm.strategy_cost(Parallax().build(item, spec))
    ar = cm.strategy_cost(AllReduce().build(item, spec))
    dense = cm.allreduce_s(float((1 << 20) * 128 * 4))
    assert ar.comm_s < dense / 4 and parallax.comm_s < dense / 4
    assert abs(ar.comm_s - parallax.comm_s) < dense / 100
    # Touched rows: 2 one-way passes of sparse_touch x the table.
    table = float((1 << 20) * 128 * 4)
    sparse_only = CostModel(_item({"emb": (1 << 20, 128)}, sparse=("emb",)), spec)
    cost = sparse_only.strategy_cost(AllReduce().build(sparse_only.model_item, spec))
    assert cost.comm_s == pytest.approx(2 * cm._oneway_s(table * tcm.DEFAULT_SPARSE_TOUCH))


def test_compressed_sparse_allreduce_priced_table_scale():
    item = _item({"emb": (1 << 18, 64), "w": (64, 64)}, sparse=("emb",))
    spec = _single()
    cm = CostModel(item, spec)
    plain = cm.strategy_cost(AllReduce().build(item, spec))
    compressed = cm.strategy_cost(AllReduce(compressor="HorovodCompressor").build(item, spec))
    assert compressed.comm_s > plain.comm_s * 5


# ------------------------------------------------------------ feasibility
def test_replicated_overflows_sharded_fits():
    item = _item({"w": (8192, 8192)}, opt="adam")
    spec = _single(8, hbm_gb=1.0)
    cm = CostModel(item, spec)
    ar = cm.strategy_cost(AllReduce().build(item, spec))
    z3 = cm.strategy_cost(PS(local_proxy_variable=False).build(item, spec))
    assert not ar.feasible and z3.feasible
    assert ar.hbm_bytes == pytest.approx(1.0e9 * tcm.HBM_USABLE_FRACTION)
    ranked = cm.rank([("AR", AllReduce().build(item, spec)),
                      ("PS3", PS(local_proxy_variable=False).build(item, spec))])
    assert ranked[0][0] == "PS3" and ranked[0][1].feasible


def test_ps_zero3_memory_below_zero1_below_allreduce():
    item, spec = _item({"w": (4096, 4096)}, opt="adam"), _single()
    cm = CostModel(item, spec)
    ar, z1, z3 = (cm.strategy_cost(b.build(item, spec)) for b in (
        AllReduce(), PS(local_proxy_variable=True), PS(local_proxy_variable=False)))
    assert z3.per_chip_bytes < z1.per_chip_bytes < ar.per_chip_bytes


# ------------------------------------------------------------------- ties
def test_rank_winner_is_caller_order_invariant():
    item, spec = _item({"w": (64, 64), "b": (64,)}), _single(1)
    cm = CostModel(item, spec)
    cands = [("AllReduce", AllReduce().build(item, spec)),
             ("PS(zero1)", PS(local_proxy_variable=True).build(item, spec)),
             ("PSLoadBalancing", PSLoadBalancing().build(item, spec))]
    winners = {cm.rank(list(p))[0][0]
               for p in (cands, cands[::-1], [cands[1], cands[2], cands[0]])}
    assert winners == {"AllReduce"}


def test_unknown_names_prefer_lower_memory_then_name():
    item, spec = _item({"w": (64, 64), "b": (64,)}, opt="adam"), _single(8)
    cm = CostModel(item, spec)
    lean = PS(local_proxy_variable=False).build(item, spec)
    fat = PS(local_proxy_variable=True).build(item, spec)
    for perm in ([("plan:a", fat), ("plan:b", lean)], [("plan:b", lean), ("plan:a", fat)]):
        assert cm.rank(perm)[0][0] == "plan:b"
    for perm in ([("plan:x", lean), ("plan:c", lean)], [("plan:c", lean), ("plan:x", lean)]):
        assert cm.rank(perm)[0][0] == "plan:c"


# ------------------------------------------------------------ calibration
def test_calibration_fit_save_load(tmp_path, monkeypatch):
    pred = [1e-3, 2e-3, 4e-3, 8e-3]
    c = tcm.Calibration.fit(pred, [5e-3 + 2.0 * p for p in pred], device="NVIDIA H100")
    assert c.base_s == pytest.approx(5e-3, rel=1e-6)
    assert c.scale == pytest.approx(2.0, rel=1e-6) and c.n_points == 4
    j = jcm.Calibration.fit(pred, [5e-3 + 2.0 * p for p in pred])
    assert (c.base_s, c.scale) == pytest.approx((j.base_s, j.scale), rel=1e-12)
    one = tcm.Calibration.fit([1e-3], [6e-3])
    assert one.scale == 1.0 and one.base_s == pytest.approx(5e-3)
    assert tcm.Calibration.fit([1e-3, 2e-3], [9e-3, 3e-3]).scale == 1.0
    path = c.save(str(tmp_path / "cal.json"))
    back = tcm.Calibration.load(path)
    assert (back.base_s, back.scale, back.device, back.n_points) == \
        (c.base_s, c.scale, "NVIDIA H100", 4)
    assert tcm.Calibration.load(str(tmp_path / "missing.json")) is None
    # The default location is the port's working directory.
    monkeypatch.setattr(const, "DEFAULT_WORKING_DIR", str(tmp_path / "wd"))
    assert tcm.Calibration.load() is None
    c.save()
    assert (tmp_path / "wd" / "calibration.json").exists()
    assert tcm.Calibration.load().scale == c.scale


# ------------------------------------------------------------ node model
def test_h100_hbm_lookup():
    assert trs.hbm_spec_for_name("NVIDIA H100 80GB HBM3") == (80 * trs.GIB, 3350.0)
    assert trs.hbm_spec_for_name("NVIDIA H100 PCIe") == (80 * trs.GIB, 2000.0)
    assert trs.hbm_spec_for_name("NVIDIA A100-SXM4-80GB") == (80 * trs.GIB, 2039.0)
    assert trs.hbm_spec_for_name("NVIDIA L40S") == (48 * trs.GIB, 864.0)
    assert trs.hbm_spec_for_name("NVIDIA L4") == (24 * trs.GIB, 300.0)
    assert trs.hbm_spec_for_name("some future card") == trs.DEFAULT_HBM \
        == min(trs.HBM_BY_DEVICE.values())
    spec = _single(device="NVIDIA H100 80GB HBM3")
    assert spec.gpu.hbm_bytes == pytest.approx(80 * 2 ** 30)
    assert spec.gpu.hbm_bandwidth_bytes == pytest.approx(3350e9)
    assert _single().gpu.hbm_bytes == pytest.approx(trs.DEFAULT_HBM[0] * 1e9)


def test_gpu_block_overrides_and_round_trips():
    spec = _single(hbm_gb=32.0, hbm_gb_per_s=1000.0, nvlink_gbps=1.0, intra_latency_us=7.0)
    assert spec.gpu.hbm_bytes == pytest.approx(32e9)
    assert spec.gpu.hbm_bandwidth_bytes == pytest.approx(1000e9)
    assert spec.gpu.intra_node_gbps == 1.0
    back = ResourceSpec(resource_dict=spec.to_dict())
    assert back.gpu == spec.gpu and back.fingerprint() == spec.fingerprint()
    assert back.fingerprint() != _single().fingerprint()
    net = ResourceSpec(resource_dict={"nodes": [{"address": "localhost", "gpus": 2}],
                                      "network_bandwidth": 25})
    assert net.network_bandwidth == 25.0
    with pytest.raises(ValueError, match="unknown gpu"):
        _single(hbm=1)
    assert CostModel(_item({"w": (4, 4)}), spec).intra_latency == pytest.approx(7e-6)


def test_from_local_devices_reads_the_card(monkeypatch):
    class Props:
        name = "NVIDIA H100 80GB HBM3"
        total_memory = 85_045_870_592

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: Props())
    spec = ResourceSpec.from_local_devices("cuda")
    assert spec.num_gpus == 1 and spec.gpu.device == Props.name
    assert spec.gpu.hbm_bytes == pytest.approx(Props.total_memory)
    assert spec.gpu.hbm_bandwidth_bytes == pytest.approx(3350e9)
    # The table and the card's own reading agree in one unit.
    assert spec.gpu.hbm_bytes == pytest.approx(trs.hbm_spec_for_name(Props.name)[0] * 1e9,
                                               rel=0.02)
    cpu = ResourceSpec.from_local_devices("cpu")
    assert cpu.gpu.device is None and cpu.num_gpus == 0
