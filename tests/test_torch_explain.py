"""The port's ``explain`` (``autodist_tpu_torch/strategy/explain.py``)
against the JAX package's.

- Under equal constants (``helpers/torch_auto.py``), the table (header,
  every row, the HBM warning) and the ``recommended:`` line equal JAX's
  ``explain`` on the same model and cluster, with the ``measured`` and
  ``calibration`` columns too; the lossless-first recommendation when a
  compressed wire prices fastest.
- ``python -m autodist_tpu_torch.strategy.explain`` runs with ``--device
  cpu``; without a card and without ``--device cpu`` it raises; its
  ``--measured-file`` and ``--calibration`` columns.
- ``lint``, ``wire_measured`` and ``explain_provenance`` (and their flags)
  raise ``NotImplementedError`` naming ROADMAP.md Queue 1 item 11.
"""
import io
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from autodist_tpu.strategy import cost_model as jcm
from autodist_tpu.strategy import explain as jexplain
from autodist_tpu_torch.strategy import cost_model as tcm
from autodist_tpu_torch.strategy import explain as texplain
from helpers import torch_auto as ta

REPO = Path(__file__).resolve().parents[1]


def _table(text: str):
    """The lines from the table's header on (the spec's repr above differs
    between the packages)."""
    lines = text.splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith("strategy"))
    return [line for line in lines[start:] if line.strip()]


def _both(model, mesh, **kwargs):
    jitem, titem = ta.items(model)
    jrs, trs = ta.specs(mesh, **kwargs.pop("gpu", {}))
    jslate, tslate = ta.slates()
    jout, tout = io.StringIO(), io.StringIO()
    jcal, tcal = kwargs.pop("calibration", (None, None))
    jr = jexplain.explain(jitem, jrs, candidates=jslate, out=jout, calibration=jcal,
                          **kwargs)
    tr = texplain.explain(titem, trs, candidates=tslate, out=tout, calibration=tcal,
                          **kwargs)
    return jr, tr, jout.getvalue(), tout.getvalue()


@pytest.mark.parametrize("mesh", sorted(ta.MESHES))
@pytest.mark.parametrize("model", ("bert_base", "resnet", "lstm_lm", "ncf",
                                   "moe_transformer"))
def test_table_and_recommendation_equal_jax(model, mesh):
    jr, tr, jtext, ttext = _both(model, mesh)
    assert [n for n, _ in tr] == [n for n, _ in jr]
    assert _table(ttext) == _table(jtext)
    assert [ln for ln in ttext.splitlines() if ln.startswith("recommended:")] == \
        [ln for ln in jtext.splitlines() if ln.startswith("recommended:")]
    model_line = next(ln for ln in jtext.splitlines() if ln.startswith("model:"))
    assert model_line in ttext


def test_measured_calibration_and_warning_columns_equal_jax():
    measured = {"AllReduce": 0.0123, "Zero1": 0.0119, "Parallax": 0.0131}
    cal = dict(base_s=4e-3, scale=1.7, device="NVIDIA H100 80GB HBM3", n_points=5)
    for gpu in ({}, {"hbm_gb": 1e-4}):
        _, _, jtext, ttext = _both("bert_base", "1x8", measured=measured, gpu=gpu,
                                   calibration=(jcm.Calibration(**cal),
                                                tcm.Calibration(**cal)))
        assert _table(ttext) == _table(jtext)
        assert "calibration: measured" in ttext and "measured" in _table(ttext)[0]
    assert "WARNING: no candidate fits" in ttext


def test_lossless_first_recommendation():
    # bert_base on one node: the bf16 wire prices fastest, AllReduce is
    # recommended (as JAX's explain does on the same numbers).
    jr, tr, jtext, ttext = _both("bert_base", "1x8")
    assert tr[0][0] == "AllReduce+bf16"
    rec = next(ln for ln in ttext.splitlines() if ln.startswith("recommended:"))
    assert rec.startswith("recommended: AllReduce (fastest priced: AllReduce+bf16")


def _cli(*args, timeout=300):
    return subprocess.run([sys.executable, "-m", "autodist_tpu_torch.strategy.explain",
                           *args], cwd=REPO, capture_output=True, text=True, timeout=timeout,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
                               "HOME": str(REPO), "OMP_NUM_THREADS": "1"})


def test_cli_runs_on_the_cpu(tmp_path):
    measured = tmp_path / "measured.json"
    measured.write_text(json.dumps({"AllReduce": {"measured_s": 0.01}, "Parallax": 0.02}))
    cal = tcm.Calibration(base_s=1e-3, scale=2.0, device="cpu", n_points=2)
    cal_path = cal.save(str(tmp_path / "cal.json"))
    out = io.StringIO()
    assert texplain.main(["--model", "ncf", "--model-kwargs",
                          "num_users=50,num_items=40,mf_dim=8", "--batch-size", "8",
                          "--device", "cpu", "--measured-file", str(measured),
                          "--calibration", cal_path], out=out) == 0
    text = out.getvalue()
    assert "recommended:" in text and "calibration: measured" in text
    assert "10.000ms" in text          # the measured column
    with pytest.raises(FileNotFoundError):
        texplain.main(["--model", "mlp", "--device", "cpu", "--calibration",
                       str(tmp_path / "none.json")], out=io.StringIO())
    spec = tmp_path / "spec.yml"
    spec.write_text("nodes:\n  - address: localhost\n    gpus: 8\ngpu:\n  hbm_gb: 80\n")
    proc = _cli("--model", "mlp", "--resource-spec", str(spec), "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "ResourceSpec(nodes=1, gpus=8" in proc.stdout
    assert "recommended:" in proc.stdout


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without CUDA")
def test_cli_without_a_card_needs_device_cpu():
    proc = _cli("--model", "mlp")
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr


@pytest.mark.parametrize("flag", (["--lint"], ["--wire-measured", "x.json"],
                                  ["--plan-provenance", "x"]))
def test_unported_modes_raise_naming_roadmap(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 11"):
        texplain.main(["--model", "mlp", "--device", "cpu", *flag], out=io.StringIO())
    for fn in (texplain.lint, texplain.wire_measured):
        with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
            fn()
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        texplain.explain_provenance({"n_visited": 1})
