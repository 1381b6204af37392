"""ResNet image classifiers of the PyTorch port.

Mirrors the JAX package's ``models/resnet.py``: ResNet-v1.5 (stride on the
3x3 conv of a bottleneck) with basic blocks at depths 18/34 and bottlenecks
at 50/101/152, NHWC activations, fp32 params, bf16 compute by default, the
space-to-depth stem, and fp32 logits. Params are a plain nested dict with
the JAX tree's keys and layouts (HWIO conv kernels), so
``models/convert.py`` carries JAX parameters over unchanged.

Every 1x1 conv is followed by a BatchNorm and runs as the fused product +
statistics op (``layers.conv_batchnorm`` → ``ops/fused_conv_stats.py``, the
CUDA kernel ``csrc/fused_conv_stats.cu`` on the card): ``conv1`` and
``conv3`` of every bottleneck and every ``proj``. ResNet-50 launches it 36
times a forward (16 blocks x 2 + 4 projections); depths 18/34 only for their
3 projections. The other convs go to ``F.conv2d`` (cuDNN on the card), as
the JAX package leaves them to XLA.

One difference from the JAX model: there, BatchNorm reduces the conv's
output after it was rounded to the compute dtype; here the statistics of a
fused 1x1 conv come from its fp32 product before the rounding. In fp32 the
two agree up to summation order; in bf16 the port's statistics are the
more exact.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.models.spec import (ModelSpec, image_example_batch,
                                            register_model, seeded_generator)

# depth -> (block kind, stage sizes, fwd FLOPs @ 224x224)
_CONFIGS: Dict[int, Tuple[str, List[int], float]] = {
    18: ("basic", [2, 2, 2, 2], 1.8e9),
    34: ("basic", [3, 4, 6, 3], 3.7e9),
    50: ("bottleneck", [3, 4, 6, 3], 4.1e9),
    101: ("bottleneck", [3, 4, 23, 3], 7.8e9),
    152: ("bottleneck", [3, 8, 36, 3], 11.6e9),
}


def _lookup(depth: int):
    if depth not in _CONFIGS:
        raise ValueError(f"unsupported resnet depth {depth}; valid: {sorted(_CONFIGS)}")
    return _CONFIGS[depth]


def _basic_block_init(gen, cin, cout, stride, dev):
    p = {
        "conv1": L.conv_init(gen, 3, 3, cin, cout, device=dev),
        "bn1": L.batchnorm_init(cout, device=dev),
        "conv2": L.conv_init(gen, 3, 3, cout, cout, device=dev),
        "bn2": L.batchnorm_init(cout, device=dev),
    }
    if stride != 1 or cin != cout:
        p["proj"] = L.conv_init(gen, 1, 1, cin, cout, device=dev)
        p["bn_proj"] = L.batchnorm_init(cout, device=dev)
    return p


def _bottleneck_init(gen, cin, cmid, stride, dev):
    cout = cmid * 4
    p = {
        "conv1": L.conv_init(gen, 1, 1, cin, cmid, device=dev),
        "bn1": L.batchnorm_init(cmid, device=dev),
        "conv2": L.conv_init(gen, 3, 3, cmid, cmid, device=dev),
        "bn2": L.batchnorm_init(cmid, device=dev),
        "conv3": L.conv_init(gen, 1, 1, cmid, cout, device=dev),
        "bn3": L.batchnorm_init(cout, device=dev),
    }
    if stride != 1 or cin != cout:
        p["proj"] = L.conv_init(gen, 1, 1, cin, cout, device=dev)
        p["bn_proj"] = L.batchnorm_init(cout, device=dev)
    return p


def _shortcut(p, x, stride, dtype):
    if "proj" not in p:
        return x
    return L.conv_batchnorm(p["proj"], p["bn_proj"], x, stride, compute_dtype=dtype)


def _basic_block(p, x, stride, dtype):
    y = torch.relu(L.conv_batchnorm(p["conv1"], p["bn1"], x, stride, compute_dtype=dtype))
    y = L.conv_batchnorm(p["conv2"], p["bn2"], y, compute_dtype=dtype)
    return torch.relu(y + _shortcut(p, x, stride, dtype))


def _bottleneck(p, x, stride, dtype):
    y = torch.relu(L.conv_batchnorm(p["conv1"], p["bn1"], x, compute_dtype=dtype))
    # ResNet-v1.5: stride lives on the 3x3 conv.
    y = torch.relu(L.conv_batchnorm(p["conv2"], p["bn2"], y, stride, compute_dtype=dtype))
    y = L.conv_batchnorm(p["conv3"], p["bn3"], y, compute_dtype=dtype)
    return torch.relu(y + _shortcut(p, x, stride, dtype))


def init_params(seed: int, depth: int, num_classes: int, width: int = 64,
                device=None) -> Dict[str, Any]:
    """Random fp32 params on ``device`` (default ``"cuda"``) from a
    ``torch.Generator`` seeded with ``seed``: He-normal conv kernels, unit
    BatchNorm scales, a Glorot head; the JAX package's tree."""
    kind, stages, _ = _lookup(depth)
    gen, dev = seeded_generator(seed, device)
    params: Dict[str, Any] = {
        "stem": {"conv": L.conv_init(gen, 7, 7, 3, width, device=dev),
                 "bn": L.batchnorm_init(width, device=dev)},
    }
    cin = width
    for si, n_blocks in enumerate(stages):
        cmid = width * (2 ** si)
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            if kind == "basic":
                params[f"stage{si}_block{bi}"] = _basic_block_init(gen, cin, cmid, stride,
                                                                   dev)
                cin = cmid
            else:
                params[f"stage{si}_block{bi}"] = _bottleneck_init(gen, cin, cmid, stride,
                                                                  dev)
                cin = cmid * 4
    params["head"] = L.dense_init(gen, cin, num_classes, device=dev)
    return params


def forward(params, images, depth: int, dtype=torch.bfloat16, stem_s2d: bool = True):
    """images [B, H, W, 3] -> fp32 logits [B, num_classes]."""
    kind, stages, _ = _lookup(depth)
    if stem_s2d and images.shape[1] % 2 == 0 and images.shape[2] % 2 == 0:
        x = L.space_to_depth_stem(params["stem"]["conv"], images, dtype)
    else:
        x = L.conv(params["stem"]["conv"], images, stride=2, compute_dtype=dtype)
    x = torch.relu(L.batchnorm(params["stem"]["bn"], x))
    x = L.max_pool(x, 3, 2)
    block = _basic_block if kind == "basic" else _bottleneck
    for si, n_blocks in enumerate(stages):
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            x = block(params[f"stage{si}_block{bi}"], x, stride, dtype)
    x = x.mean(dim=(1, 2))
    return L.dense(params["head"], x).to(torch.float32)


def fused_launches_per_forward(depth: int) -> int:
    """Fused 1x1-conv launches of one forward: 2 per bottleneck plus one per
    projection (the first block of every stage after the first, and stage
    0's first bottleneck, which widens 64 to 256)."""
    kind, stages, _ = _lookup(depth)
    if kind == "basic":
        return len(stages) - 1
    return 2 * sum(stages) + len(stages)


@register_model("resnet")
def resnet(depth: int = 50, num_classes: int = 1000, image_size: int = 224) -> ModelSpec:
    def loss_fn(params, batch):
        return L.softmax_xent(forward(params, batch["images"], depth), batch["labels"])

    _, _, fwd_flops = _lookup(depth)
    return ModelSpec(
        name=f"resnet{depth}",
        init=lambda seed=0, device=None: init_params(seed, depth, num_classes,
                                                     device=device),
        loss_fn=loss_fn,
        example_batch=image_example_batch(image_size, num_classes),
        apply=lambda p, x: forward(p, x, depth),
        flops_per_example=3.0 * fwd_flops * (image_size / 224.0) ** 2,
    )
