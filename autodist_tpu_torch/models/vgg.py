"""VGG image classifiers of the PyTorch port.

Mirrors the JAX package's ``models/vgg.py``: depths 11/16/19, 3x3 SAME convs
with ReLU, VALID 2x2 max pools, then ``fc0`` over the flattened NHWC map
(JAX's flatten order: rows, then columns, then channels), ``fc1`` and the
head; bf16 compute by default, fp32 params and logits. No BatchNorm, so no
conv goes through the fused conv-stats kernel: the convs are ``F.conv2d``
(cuDNN on the card), as the JAX package leaves them to XLA.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.models.spec import (ModelSpec, image_example_batch,
                                            register_model, seeded_generator)

# depth -> conv channels per stage ('M' = 2x2 max pool)
_CFG: Dict[int, List] = {
    11: [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}
# fwd FLOPs per 224x224 image (the JAX package's figures)
_FLOPS = {11: 7.6e9, 16: 15.5e9, 19: 19.6e9}


def _check(depth: int) -> None:
    if depth not in _CFG:
        raise ValueError(f"unsupported vgg depth {depth}; valid: {sorted(_CFG)}")


def init_params(seed: int, depth: int, num_classes: int, image_size: int,
                device=None) -> Dict[str, Any]:
    _check(depth)
    gen, dev = seeded_generator(seed, device)
    params: Dict[str, Any] = {}
    cin, spatial, conv_i = 3, image_size, 0
    for item in _CFG[depth]:
        if item == "M":
            spatial //= 2
            continue
        params[f"conv{conv_i}"] = L.conv_init(gen, 3, 3, cin, item, device=dev)
        cin, conv_i = item, conv_i + 1
    params["fc0"] = L.dense_init(gen, cin * spatial * spatial, 4096, device=dev)
    params["fc1"] = L.dense_init(gen, 4096, 4096, device=dev)
    params["head"] = L.dense_init(gen, 4096, num_classes, device=dev)
    return params


def forward(params, images, depth: int, dtype=torch.bfloat16):
    """images [B, H, W, 3] -> fp32 logits [B, num_classes]."""
    x = images.to(dtype)
    conv_i = 0
    for item in _CFG[depth]:
        if item == "M":
            x = L.max_pool(x, 2, 2, "VALID")
            continue
        x = torch.relu(L.conv(params[f"conv{conv_i}"], x, compute_dtype=dtype))
        conv_i += 1
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(L.dense(params["fc0"], x, compute_dtype=dtype))
    x = torch.relu(L.dense(params["fc1"], x, compute_dtype=dtype))
    return L.dense(params["head"], x, compute_dtype=dtype).to(torch.float32)


@register_model("vgg")
def vgg(depth: int = 16, num_classes: int = 1000, image_size: int = 224) -> ModelSpec:
    _check(depth)

    def loss_fn(params, batch):
        return L.softmax_xent(forward(params, batch["images"], depth), batch["labels"])

    return ModelSpec(
        name=f"vgg{depth}",
        init=lambda seed=0, device=None: init_params(seed, depth, num_classes, image_size,
                                                     device=device),
        loss_fn=loss_fn,
        example_batch=image_example_batch(image_size, num_classes),
        apply=lambda p, images: forward(p, images, depth),
        flops_per_example=3 * _FLOPS[depth] * (image_size / 224.0) ** 2,
    )
