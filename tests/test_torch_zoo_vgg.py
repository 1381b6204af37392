"""Port parity: VGG-11 at 32 px, 10 classes (no BatchNorm), through the cases
of ``tests/test_torch_zoo.py``: the spec and example batch, the VarItems,
``Strategy.to_json()`` under AllReduce, PS and PSLoadBalancing, fp32 loss
within 1e-5 and gradients within 1e-5 absolute + 1e-4 relative, bf16 logits
within twice the JAX model's own bf16-vs-fp32 drift, and 3 AutoDist steps
(momentum, a piecewise schedule) against the JAX package's to 1e-5 / 1e-4.
"""
import pytest

from autodist_tpu import api as japi
from autodist_tpu_torch import api as tapi
from test_torch_zoo import (autodist_steps_case, bf16_drift_case, fp32_grads_case,
                            spec_and_batch_case, strategy_json_case, var_items_case)


@pytest.fixture(autouse=True)
def _fresh_autodist():
    japi.AutoDist.reset_default()
    tapi.AutoDist.reset_default()
    yield
    japi.AutoDist.reset_default()
    tapi.AutoDist.reset_default()


def test_vgg_spec_and_var_items_match_jax():
    spec_and_batch_case("vgg")
    var_items_case("vgg")


@pytest.mark.parametrize("builder", ["AllReduce", "PS", "PSLoadBalancing"])
def test_vgg_strategy_json_matches_jax(builder, tmp_path):
    strategy_json_case("vgg", builder, tmp_path)


def test_vgg_fp32_loss_grads_and_bf16_drift_match_jax():
    fp32_grads_case("vgg")
    bf16_drift_case("vgg")


def test_vgg_three_autodist_steps_match_jax():
    autodist_steps_case("vgg")
