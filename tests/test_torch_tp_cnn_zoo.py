"""Port parity of the zoo's other CNNs under a model axis (4 gloo ranks,
one process each, on the CPU; the harness and the bars of
``tests/test_torch_tp_models.py``).

DenseNet (blocks (2, 2), growth 8) and Inception-v3 (width 1/16) at 32 px,
batch 8, 10 classes, fp32, under ``TensorParallel`` and ``PartitionedAR``
at data 2 x model 2, one SGD step at 3e-3 each: DenseNet's channel
concatenation and Inception's branch concatenations meet activations split
on the channel, their pooling runs on a rank's channel block, and under
``PartitionedAR`` the BatchNorm scales and biases are split too; VGG-11
under ``PartitionedAR``, three steps at 1e-4. Each through
``AutoDist.build``, every rank's parameters bitwise equal, held to JAX's
4-device step as ``tests/test_torch_tp_models.py`` holds its CNNs: the
whole update (relative L2) within twice JAX's own spread under a
reordering of each data rank's rows or 1e-4 where that is larger, each
loss within twice the reorderings' change or rtol 1e-5.
"""
import pytest

from autodist_tpu_torch.models.convert import params_from_jax
from helpers import torch_dist as td
from test_torch_tp_models import DENSE, INCEPTION, VGG, case, check_cnn, inputs

CASES = [
    case("densenet/tp", "densenet", "TensorParallel", steps=1, overrides=DENSE, fp32=True),
    case("densenet/partitioned_ar", "densenet", "PartitionedAR", steps=1, overrides=DENSE,
         fp32=True),
    case("inception/tp", "inception", "TensorParallel", steps=1, overrides=INCEPTION,
         fp32=True),
    case("inception/partitioned_ar", "inception", "PartitionedAR", steps=1,
         overrides=INCEPTION, fp32=True),
    case("vgg/partitioned_ar", "vgg", "PartitionedAR", overrides=VGG, fp32=True),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    np_inputs = inputs(CASES)
    torch_inputs = {k: (params_from_jax(p, device="cpu"), td.to_torch(b))
                    for k, (p, b) in np_inputs.items()}
    return td.run_ranks(tmp_path_factory.mktemp("ranks"), torch_inputs, CASES), np_inputs


@pytest.mark.parametrize("c", CASES, ids=lambda c: c["id"])
def test_cnn_matches_jax_within_its_spread(c, runs):
    results, np_inputs = runs
    check_cnn(c, results, np_inputs)
    split = [n for n, (kind, _) in results[0][c["id"]]["renderings"].items()
             if kind == "partitioned"]
    assert split
    if c["builder"] == "PartitionedAR" and c["model"] != "vgg":
        assert any(n.endswith("/scale") for n in split), split
