"""The port stands alone: no file of ``autodist_tpu_torch/``, neither
``chip_smoke.py`` nor the port's ``tools/torch_*.py`` scripts import ``jax``
or the JAX package ``autodist_tpu`` (an AST scan of every import statement,
lazy ones inside functions included), ``parallel/`` among them. Where the
JAX behaviour is not ported yet (the chaos harness), the port raises ``NotImplementedError`` naming
ROADMAP.md; the seam registry it did port keeps JAX's seam names.
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
    assert "tools/torch_serve_profile.py" in names
    assert "tools/torch_crossover_sweep.py" in names
    assert "tools/torch_sparse_wire_profile.py" in names
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
                "kernel/compressor.py", "runtime/async_ps.py", "runtime/process_group.py",
                "serve/sampling.py", "serve/spec.py", "serve/prefix.py",
                "ops/crossover.py", "ops/library.py", "utils/prng.py",
                "checkpoint/__init__.py", "checkpoint/saver.py", "checkpoint/names.py",
                "checkpoint/saved_model.py", "checkpoint/dcp_compat.py",
                "strategy/cost_model.py", "strategy/auto_strategy.py",
                "strategy/explain.py", "kernel/sparse.py", "kernel/bucketing.py",
                "chaos/__init__.py", "chaos/hooks.py", "obs/spans.py", "obs/recorder.py",
                "ft/__init__.py", "ft/config.py", "ft/heartbeat.py", "ft/snapshot.py",
                "ft/elastic.py", "ft/procdrain.py", "runtime/cluster.py",
                "runtime/coordinator.py", "runtime/launcher.py", "runtime/__init__.py",
                "obs/aggregate.py", "serve/router.py", "serve/replica.py", "serve/server.py",
                "analysis/__init__.py", "analysis/report.py", "analysis/passes.py",
                "serve/__main__.py", "serve/__init__.py", "models/transformer.py",
                "parallel/__init__.py", "parallel/ring_attention.py", "parallel/pipeline.py"):
        assert f"autodist_tpu_torch/{new}" in names, new
    for src in ("paged_attention.cu", "flash_attention.cu", "fused_conv_stats.cu"):
        assert (ROOT / "autodist_tpu_torch" / "csrc" / src).exists()
    # The scanner itself sees a module-level import (the package's
    # registration of its kernels' operators).
    probe = ROOT / "autodist_tpu_torch" / "__init__.py"
    assert list(_imported_modules(probe)) == ["autodist_tpu_torch.ops"]


@pytest.mark.parametrize("name", ["ChaosPlant", "ChaosSchedule", "ChaosEvent", "CATALOG",
                                  "FaultSpec", "harness"])
def test_unported_chaos_entry_points_name_the_roadmap(name):
    import autodist_tpu_torch.chaos as chaos

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        getattr(chaos, name)


def test_chaos_seams_equal_the_jax_packages():
    from autodist_tpu.chaos import hooks as jhooks
    from autodist_tpu_torch.chaos import hooks

    assert hooks.__all__ == jhooks.__all__
    for name in hooks.__all__:
        if name.startswith("SEAM_"):
            assert getattr(hooks, name) == getattr(jhooks, name)
    seen = []
    hooks.install(hooks.SEAM_HB_PUBLISH, lambda payload, **ctx: seen.append(ctx) or None)
    try:
        from autodist_tpu_torch.ft import MemoryTransport

        t = MemoryTransport()
        t.publish(3, {"time": 1.0})
        assert t.sweep() == {} and seen == [{"process_id": 3, "transport": "memory"}]
    finally:
        hooks.clear()
    assert not hooks.active()
