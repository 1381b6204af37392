"""Port parity: Inception-V3 at ``width=1/16``, 32 px, batch 8, 10 classes,
through the cases of ``tests/test_torch_zoo_cnn.py`` (spec, VarItems and
strategy JSON equal; fp32 loss and gradients, bf16 and fp32 logits, and 3
AutoDist steps, each against JAX's step from the same parameters and
optimizer history; each within twice JAX's own spread over reordered
batches where that is larger than the plain bound).
"""
import pytest

from autodist_tpu import api as japi
from autodist_tpu_torch import api as tapi
from test_torch_zoo_cnn import (autodist_steps_case, bf16_spread_case, fp32_spread_case,
                                spec_json_case)


@pytest.fixture(autouse=True)
def _fresh_autodist():
    japi.AutoDist.reset_default()
    tapi.AutoDist.reset_default()
    yield
    japi.AutoDist.reset_default()
    tapi.AutoDist.reset_default()


def test_inception_spec_var_items_and_strategy_json_match_jax(tmp_path):
    spec_json_case("inception", tmp_path)


def test_inception_fp32_loss_and_grads_match_jax():
    fp32_spread_case("inception")


def test_inception_bf16_drift_from_fp32_is_the_jax_models():
    bf16_spread_case("inception")


def test_inception_three_autodist_steps_match_one_device_jax():
    autodist_steps_case("inception")
