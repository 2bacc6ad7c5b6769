"""CIFAR-10 CNN (port of ``deepspeed_tpu/models/cnn.py``; ref:
DeepSpeedExamples/training/cifar, the reference's ZeRO-0 smoke benchmark).

Two 3x3 convolutions ("SAME": padding 1 at stride 1) each with ReLU and a
2x2 max pool, then two dense layers.  The tree keeps the JAX layouts, HWIO
kernels and ``[in, out]`` matrices, and :func:`forward` takes NHWC images,
so the weight bridge is a plain copy; the permutes to PyTorch's NCHW / OIHW
happen inside :func:`forward`, and the flatten before ``fc1`` runs in NHWC
order, as the JAX model's reshape does.

The convolutions are ``torch.nn.functional.conv2d``: the JAX package
computes them in XLA (``lax.conv_general_dilated``), not in a Pallas
kernel, so there is no kernel of the repo to port here.  On the card a
float32 convolution runs in TF32 unless ``torch.backends.cudnn.allow_tf32``
is False; callers that hold it to the CPU set it so.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass
class CNNConfig:
    num_classes: int = 10
    channels: int = 32


def _conv(x, w, b):
    """NCHW x, HWIO w -> NCHW, "SAME" padding at stride 1."""
    return F.conv2d(x, w.permute(3, 2, 0, 1), b, padding=1)


def forward(params, images):
    """images [B, 32, 32, 3] (NHWC) -> logits [B, num_classes] f32."""
    dt = params["conv1"].dtype
    x = images.to(dt).permute(0, 3, 1, 2)
    x = F.max_pool2d(F.relu(_conv(x, params["conv1"], params["b1"])), 2, 2)
    x = F.max_pool2d(F.relu(_conv(x, params["conv2"], params["b2"])), 2, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(x @ params["fc1"] + params["fb1"])
    return (x @ params["fc2"] + params["fb2"]).float()


def loss_fn(params, batch):
    """Mean cross-entropy of ``batch["images"]`` against
    ``batch["labels"]`` [B] int."""
    logp = torch.log_softmax(forward(params, batch["images"]), dim=-1)
    return -logp.gather(1, batch["labels"].long()[:, None]).mean()
