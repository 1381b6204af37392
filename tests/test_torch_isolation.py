"""The port stands alone: no file of ``autodist_tpu_torch/``, neither
``chip_smoke.py`` nor the port's ``tools/torch_*.py`` scripts import ``jax``
or the JAX package ``autodist_tpu`` (an AST scan of every import statement,
lazy ones inside functions included).
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = (sorted((ROOT / "autodist_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "tools").glob("torch_*.py")))
BANNED = ("jax", "jaxlib", "autodist_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_whole_port():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert "chip_smoke.py" in names
    assert "tools/torch_flash_quick.py" in names
    assert "tools/torch_conv_quick.py" in names
    assert "tools/torch_paged_quick.py" in names
    assert "tools/torch_ab_profile.py" in names
    assert "tools/torch_dist_profile.py" in names
    assert "autodist_tpu_torch/ops/paged_attention.py" in names
    assert "autodist_tpu_torch/serve/engine.py" in names
    for new in ("ops/flash_attention.py", "models/spec.py", "const.py",
                "resource_spec.py", "model_item.py", "strategy/ir.py", "strategy/base.py",
                "strategy/all_reduce_strategy.py", "strategy/ps_strategy.py",
                "strategy/ps_lb_strategy.py", "strategy/__init__.py", "kernel/mesh.py",
                "kernel/lowering.py", "kernel/__init__.py", "api.py",
                "ops/fused_conv_stats.py", "models/resnet.py", "models/layers.py",
                "models/mlp.py", "models/ncf.py", "models/lstm_lm.py", "models/vgg.py",
                "models/densenet.py", "models/inception.py", "models/moe.py",
                "kernel/compressor.py", "runtime/async_ps.py", "runtime/process_group.py"):
        assert f"autodist_tpu_torch/{new}" in names, new
    for src in ("paged_attention.cu", "flash_attention.cu", "fused_conv_stats.cu"):
        assert (ROOT / "autodist_tpu_torch" / "csrc" / src).exists()
    # The scanner itself catches both spellings.
    probe = ROOT / "autodist_tpu_torch" / "__init__.py"
    assert list(_imported_modules(probe)) == []
