"""Knowledge distillation (port of ``deepspeed_tpu/distill.py``; ref: the
DeepSpeed compression suite's KD flow, a teacher-student soft-label loss
used with ``layer_reduction``'s ``teacher_layer`` initialisation).

The teacher is a pure function over a frozen param tree, run inside the
student's loss under ``torch.no_grad()`` (the counterpart of JAX's
``stop_gradient`` on its logits): no second engine, no host round trip.

Loss (Hinton et al., the reference recipes' formulation)::

    L = (1 - alpha) * CE(student, targets)
      + alpha * T^2 * KL(softmax(teacher/T) || softmax(student/T))

The T^2 factor keeps soft-gradient magnitudes comparable across
temperatures.  All soft-label math runs in f32.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from deepspeed_tpu_torch.ops.losses import _masked_mean


def kd_kl_loss(student_logits, teacher_logits, temperature: float = 1.0,
               mask=None) -> torch.Tensor:
    """Masked mean KL(teacher || student) at ``temperature``, scaled by
    T^2.  logits: [..., V]; ``mask`` covers the leading dims."""
    t = float(temperature)
    slog = torch.log_softmax(student_logits.float() / t, dim=-1)
    tlog = torch.log_softmax(teacher_logits.float() / t, dim=-1)
    kl = torch.sum(torch.exp(tlog) * (tlog - slog), dim=-1)
    if mask is None:
        return kl.mean() * t * t
    return _masked_mean(kl.reshape(-1), mask.reshape(-1)) * t * t


def distillation_loss(student_logits, teacher_logits, targets, *,
                      alpha: float = 0.5, temperature: float = 1.0,
                      mask=None):
    """Hard CE + soft KL -> (loss, ``{"hard_loss", "kd_loss"}``).  The
    teacher logits carry no gradient (detached)."""
    logp = torch.log_softmax(student_logits.float(), dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    if mask is None:
        hard = nll.mean()
    else:
        hard = _masked_mean(nll.reshape(-1), mask.reshape(-1))
    soft = kd_kl_loss(student_logits, teacher_logits.detach(),
                      temperature=temperature, mask=mask)
    loss = (1.0 - alpha) * hard + alpha * soft
    return loss, {"hard_loss": hard, "kd_loss": soft}


class Distiller:
    """Wraps a student forward into an engine-ready distillation loss.

    ``teacher_fn(teacher_params, tokens) -> logits`` runs under
    ``torch.no_grad()`` inside the student's step; ``teacher_params`` are
    frozen tensors on the student's device.
    """

    def __init__(self, teacher_fn: Callable, teacher_params: Any,
                 alpha: float = 0.5, temperature: float = 2.0):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha must be in [0, 1], got {alpha}")
        if temperature <= 0:
            raise ValueError(f"temperature must be > 0, got {temperature}")
        self.teacher_fn = teacher_fn
        self.teacher_params = teacher_params
        self.alpha = float(alpha)
        self.temperature = float(temperature)

    def loss_fn(self, student_fn: Callable,
                has_aux: bool = False) -> Callable:
        """``student_fn(params, tokens) -> logits`` -> engine loss_fn over
        ``batch = {tokens, (loss_mask)}`` (next-token convention: inputs
        ``tokens[:, :-1]``, targets ``tokens[:, 1:]``)."""

        def f(params, batch):
            tokens = batch["tokens"]
            inputs, targets = tokens[:, :-1], tokens[:, 1:]
            mask = batch.get("loss_mask")
            if mask is not None:
                mask = mask[:, 1:]
            s_logits = student_fn(params, inputs)
            with torch.no_grad():
                t_logits = self.teacher_fn(self.teacher_params, inputs)
            loss, aux = distillation_loss(
                s_logits, t_logits, targets, alpha=self.alpha,
                temperature=self.temperature, mask=mask)
            return (loss, aux) if has_aux else loss

        return f


def init_distillation(config: Any, teacher_fn: Callable,
                      teacher_params: Any) -> Optional[Distiller]:
    """A Distiller from the ``compression_training.knowledge_distillation``
    block (``{enabled, alpha, temperature}``); None when absent or
    disabled."""
    if hasattr(config, "raw"):
        config = config.raw
    kd = (config.get("compression_training", {})
          .get("knowledge_distillation", {}))
    if not kd.get("enabled"):
        return None
    return Distiller(teacher_fn, teacher_params,
                     alpha=float(kd.get("alpha", 0.5)),
                     temperature=float(kd.get("temperature", 2.0)))
