"""Port parity: the plan-level memory pass (``analysis/passes.py::hbm_budget``)
and the findings report.

The JAX package's serving selftest engine (``serve/server.py::_tiny_engine``:
fp32 transformer, vocab 128, 2 layers, d 32, 56 pages of 8) and the port's
(same shapes, ``device="cpu"``) give the pool bytes. The plans hold the same
variables: the port's ``engine.plan`` (the one-device AllReduce plan, built
when read) and JAX's AllReduce plan of the JAX engine's params on one
device of the test mesh, the lowering JAX's ``InferenceEngine.build`` runs.
``hbm_budget`` of the two must agree, every summary value within 1e-12
relative and every finding's rendered line equal, for:

- the state sum (params + optimizer slots + gradient transient), with and
  without a resource spec of 16 GB (JAX's ``tpu: hbm_gb``, the port's
  ``gpu: hbm_gb``);
- the page-pool tenant: its bytes in the state sum and the summary, and a
  pool past capacity raising SLM001 with ``serve.page_pool`` heading the
  blame line (``tests/test_serve_paged.py``'s case);
- the int8 pool's summary keys (``tests/test_paged_kernel.py``'s case): the
  PHYSICAL bytes priced, the capacity multiplier (3.2) and the
  fp-equivalent figure beside them;
- an offloaded variable left out of the sum;
- SLM002 when the state fits but state + ``temp_bytes`` does not;
- a Zero1 plan at data 4 (optimizer slots sharded four ways), the port's
  on ``Mesh.logical`` against JAX's on four of the test mesh's devices.

The report's render, JSON and text forms are held to JAX's on the same
findings.
"""
import copy
from dataclasses import replace

import jax
import numpy as np
import pytest

from autodist_tpu import analysis as janalysis
from autodist_tpu import model_item as jmi
from autodist_tpu import strategy as jstrat
from autodist_tpu.analysis.report import dumps as jdumps
from autodist_tpu.kernel import GraphTransformer as JGraphTransformer
from autodist_tpu.kernel import build_mesh as jbuild_mesh
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.serve import server as jserver
from autodist_tpu_torch import analysis
from autodist_tpu_torch import model_item as tmi
from autodist_tpu_torch import strategy as tstrat
from autodist_tpu_torch.kernel import GraphTransformer, Mesh
from autodist_tpu_torch.models.convert import params_from_jax
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.serve import server
from helpers.torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-12
NODE = [{"address": "localhost", "chips": 1, "chief": True}]


def _specs(hbm_gb=16.0):
    return (JResourceSpec(resource_dict={"nodes": NODE, "tpu": {"hbm_gb": hbm_gb}}),
            ResourceSpec(resource_dict={"nodes": NODE, "gpu": {"hbm_gb": hbm_gb}}))


@pytest.fixture(scope="module")
def engines():
    """{kv_quant: (JAX engine, port engine)} of the selftest's geometry."""
    out = {}
    for quant in (False, True):
        jeng, _, _ = jserver._tiny_engine(n_slots=8, kv_quant=quant)
        teng, _, _ = server._tiny_engine(n_slots=8, kv_quant=quant, device="cpu")
        out[quant] = (jeng, teng)
    return out


def _jax_params(jeng):
    return jax.tree.map(np.asarray, jeng.plan.unpad_params(jeng.params))


def _plans(jparams, builder="AllReduce", n=1):
    """(JAX plan on ``n`` devices of the test mesh, port plan on
    ``Mesh.logical({"data": n})``) of ``builder`` over the same params."""
    nodes = {"nodes": [{"address": "localhost", "chips": n, "chief": True}]}
    jrs, trs = JResourceSpec(resource_dict=nodes), ResourceSpec(resource_dict=nodes)
    jitem = jmi.ModelItem.from_params(jparams)
    titem = tmi.ModelItem.from_params(params_from_jax(jparams, device="cpu"))
    jplan = JGraphTransformer(
        jstrat.StrategyCompiler(jitem).compile(jstrat.from_name(builder).build(jitem, jrs)),
        jitem, jbuild_mesh(jrs, devices=jax.devices()[:n])).transform()
    tplan = GraphTransformer(
        tstrat.StrategyCompiler(titem).compile(tstrat.from_name(builder).build(titem, trs)),
        titem, Mesh.logical({"data": n})).transform()
    return jplan, tplan


@pytest.fixture(scope="module")
def jplan(engines):
    """JAX's one-device AllReduce plan of the JAX engine's params."""
    jplan, tplan = _plans(_jax_params(engines[False][0]))
    assert tplan.describe() == engines[False][1].plan.describe()
    return jplan


def _same(jres, tres):
    (jf, js), (tf, ts) = jres, tres
    assert set(ts) == set(js)
    for key, want in js.items():
        if isinstance(want, float):
            assert ts[key] == pytest.approx(want, rel=RTOL, abs=0.0), key
        else:
            assert ts[key] == want, key
    assert [f.render() for f in tf] == [f.render() for f in jf]
    return ts, tf


def test_state_sum_matches_jax(engines, jplan):
    teng = engines[False][1]
    assert list(teng.plan.var_plans) == list(jplan.var_plans)
    ts, tf = _same(janalysis.hbm_budget(jplan), analysis.hbm_budget(teng.plan))
    n_params = sum(int(np.prod(p.var.shape)) for p in teng.plan.var_plans.values())
    # fp32 params + 2 Adam-like slots + one gradient transient.
    assert ts["state_gb_per_chip"] == pytest.approx(n_params * 4 * 4 / 1e9)
    assert not tf and ts["capacity_gb_per_chip"] == 0.0
    jrs, trs = _specs()
    ts, tf = _same(janalysis.hbm_budget(jplan, resource_spec=jrs),
                   analysis.hbm_budget(teng.plan, resource_spec=trs))
    assert ts["capacity_gb_per_chip"] == pytest.approx(16.0) and not tf
    ts, _ = _same(janalysis.hbm_budget(jplan, optimizer="sgd"),
                  analysis.hbm_budget(teng.plan, optimizer="sgd"))
    assert ts["state_gb_per_chip"] == pytest.approx(n_params * 4 * 2 / 1e9)


def test_page_pool_tenant_and_slm001(engines, jplan):
    jeng, teng = engines[False]
    assert teng.page_pool_bytes == jeng.page_pool_bytes > 0
    jrs, trs = _specs()
    base = analysis.hbm_budget(teng.plan, resource_spec=trs)[1]
    ts, tf = _same(
        janalysis.hbm_budget(jplan, resource_spec=jrs,
                             serve_pool_bytes=jeng.page_pool_bytes,
                             serve_shared_fraction=0.25),
        analysis.hbm_budget(teng.plan, resource_spec=trs,
                            serve_pool_bytes=teng.page_pool_bytes,
                            serve_shared_fraction=0.25))
    assert ts["serve_pool_gb_per_chip"] == pytest.approx(teng.page_pool_bytes / 1e9)
    assert ts["state_gb_per_chip"] == pytest.approx(
        base["state_gb_per_chip"] + teng.page_pool_bytes / 1e9)
    assert ts["serve_shared_fraction"] == 0.25 and not tf
    ts, tf = _same(
        janalysis.hbm_budget(jplan, resource_spec=jrs, serve_pool_bytes=32e9),
        analysis.hbm_budget(teng.plan, resource_spec=trs, serve_pool_bytes=32e9))
    assert [f.code for f in tf] == ["SLM001"]
    assert ts["top_vars"][0] == "serve.page_pool"
    assert "top contributors: serve.page_pool (32.000 GB)" in tf[0].message


def test_quantized_pool_summary(engines, jplan):
    jeng, teng = engines[True]
    assert teng.kv_quant and teng.quant_capacity_x == pytest.approx(3.2)
    assert teng.page_pool_bytes == jeng.page_pool_bytes
    assert teng.page_pool_fp_equiv_bytes == jeng.page_pool_fp_equiv_bytes
    ts, _ = _same(
        janalysis.hbm_budget(jplan, serve_pool_bytes=jeng.page_pool_bytes,
                             serve_quant_capacity_x=jeng.quant_capacity_x),
        analysis.hbm_budget(teng.plan, serve_pool_bytes=teng.page_pool_bytes,
                            serve_quant_capacity_x=teng.quant_capacity_x))
    assert ts["serve_pool_gb_per_chip"] * 1e9 == pytest.approx(teng.page_pool_bytes)
    assert ts["serve_quant_capacity_x"] == pytest.approx(teng.quant_capacity_x)
    assert ts["serve_pool_fp_equiv_gb_per_chip"] == pytest.approx(
        ts["serve_pool_gb_per_chip"] * teng.quant_capacity_x)


def _offloaded(plan, name):
    out = copy.copy(plan)
    out.var_plans = {n: replace(p, offload=(n == name)) for n, p in plan.var_plans.items()}
    return out


def test_offloaded_var_left_out(engines, jplan):
    teng = engines[False][1]
    name = "embed/embedding"
    full = analysis.hbm_budget(teng.plan)[1]
    ts, _ = _same(janalysis.hbm_budget(_offloaded(jplan, name)),
                  analysis.hbm_budget(_offloaded(teng.plan, name)))
    assert name in full["top_vars"] and name not in ts["top_vars"]
    assert ts["state_gb_per_chip"] == pytest.approx(
        full["state_gb_per_chip"] - 128 * 32 * 4 * 4 / 1e9)


def test_slm002_with_temp_bytes(engines, jplan):
    teng = engines[False][1]
    state = analysis.hbm_budget(teng.plan)[1]["state_gb_per_chip"] * 1e9
    hbm_gb = 2 * state / 0.75 / 1e9            # usable = twice the state
    jrs, trs = _specs(hbm_gb)
    _, tf = _same(janalysis.hbm_budget(jplan, resource_spec=jrs, temp_bytes=0.5 * state),
                  analysis.hbm_budget(teng.plan, resource_spec=trs, temp_bytes=0.5 * state))
    assert not tf
    _, tf = _same(janalysis.hbm_budget(jplan, resource_spec=jrs, temp_bytes=2 * state),
                  analysis.hbm_budget(teng.plan, resource_spec=trs, temp_bytes=2 * state))
    assert [f.code for f in tf] == ["SLM002"]
    assert "top state contributors: embed/embedding" in tf[0].message


def test_zero1_sharded_slots_match_jax(engines):
    jplan4, tplan4 = _plans(_jax_params(engines[False][0]), "Zero1", 4)
    assert any(p.update_dim is not None for p in tplan4.var_plans.values())
    ts, _ = _same(janalysis.hbm_budget(jplan4), analysis.hbm_budget(tplan4))
    one_device = analysis.hbm_budget(engines[False][1].plan)[1]
    assert ts["state_gb_per_chip"] < one_device["state_gb_per_chip"]


def test_report_matches_jax(engines, jplan):
    teng = engines[False][1]
    jrs, trs = _specs()
    jf, jsum = janalysis.hbm_budget(jplan, resource_spec=jrs, serve_pool_bytes=32e9)
    tf, tsum = analysis.hbm_budget(teng.plan, resource_spec=trs, serve_pool_bytes=32e9)
    jrep = janalysis.AnalysisReport(findings=list(jf), tables={"memory": jsum},
                                    program="serve")
    trep = analysis.AnalysisReport(findings=list(tf), tables={"memory": tsum},
                                   program="serve")
    assert not trep.ok and trep.codes() == jrep.codes() == ("SLM001",)
    assert trep.summary() == jrep.summary()
    assert trep.render() == jrep.render()
    assert analysis.report_to_text(trep) == janalysis.report_to_text(jrep)
    assert analysis.dumps(trep) == jdumps(jrep)
    assert analysis.FINDING_CODES == janalysis.FINDING_CODES
    with pytest.raises(analysis.AnalysisError) as e:
        raise analysis.AnalysisError(trep)
    assert e.value.report is trep
    with pytest.raises(ValueError, match="unknown finding code"):
        analysis.Finding(code="SLX999", severity="error", message="")
