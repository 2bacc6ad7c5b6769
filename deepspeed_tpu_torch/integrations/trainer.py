"""HF-Trainer-style bridge (port of ``deepspeed_tpu/integrations/
trainer.py``; ref: the reference's HuggingFace integration —
``TrainingArguments(deepspeed=<config>)`` + ``Trainer.train()`` driving
``deepspeed.initialize`` under the hood, and transformers'
``HfTrainerDeepSpeedConfig.trainer_config_process``, which fills the
config's ``"auto"`` values from the TrainingArguments).

The same three objects users know::

    args = TrainingArguments(output_dir=..., deepspeed={...}, ...)
    trainer = Trainer(model_dir="path/to/hf-llama", args=args,
                      train_dataset=[{"input_ids": [...]}, ...])
    trainer.train()
    trainer.save_model()          # HF-layout safetensors + config.json

``model_dir`` is an HF checkpoint directory; the weights go through
:mod:`deepspeed_tpu_torch.integrations.hf` and the policies of
:mod:`deepspeed_tpu_torch.inference.injection` and back.  One device: the
world size is 1 until the distributed slice (ROADMAP A9).  Each epoch's
row order is ``np.random.default_rng(seed + epoch).permutation``, so the
batches equal the JAX Trainer's.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainingArguments:
    """The TrainingArguments fields the reference's HF integration reads
    when resolving a DeepSpeed config."""

    output_dir: str = "output"
    deepspeed: Any = None                  # dict | path to a DS json
    per_device_train_batch_size: int = 8
    gradient_accumulation_steps: int = 1
    learning_rate: float = 5e-5
    weight_decay: float = 0.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    num_train_epochs: float = 1.0
    max_steps: int = -1                    # >0 overrides epochs
    warmup_steps: int = 0
    logging_steps: int = 10
    seed: int = 42


def _resolve_auto(ds: Dict[str, Any], args: TrainingArguments,
                  num_update_steps: int) -> Dict[str, Any]:
    """Fill ``"auto"`` leaves from TrainingArguments (ref: transformers
    HfTrainerDeepSpeedConfig.trainer_config_process /
    trainer_config_finalize — the same key -> argument mapping)."""
    ds = json.loads(json.dumps(ds))  # deep copy, keeps it JSON-clean
    fills = {
        "train_micro_batch_size_per_gpu": args.per_device_train_batch_size,
        "gradient_accumulation_steps": args.gradient_accumulation_steps,
        "gradient_clipping": args.max_grad_norm,
    }
    for key, val in fills.items():
        if ds.get(key) == "auto":
            ds[key] = val
    op = ds.get("optimizer", {}).get("params", {})
    for key, val in (("lr", args.learning_rate),
                     ("betas", [args.adam_beta1, args.adam_beta2]),
                     ("eps", args.adam_epsilon),
                     ("weight_decay", args.weight_decay)):
        if op.get(key) == "auto":
            op[key] = val
    sp = ds.get("scheduler", {}).get("params", {})
    for key, val in (("warmup_max_lr", args.learning_rate),
                     ("warmup_min_lr", 0.0),
                     ("warmup_num_steps", args.warmup_steps),
                     ("total_num_steps", num_update_steps)):
        if sp.get(key) == "auto":
            sp[key] = val
    leftovers = [k for k, v in {**ds, **op, **sp}.items() if v == "auto"]
    if leftovers:
        raise ValueError(
            f"unresolved 'auto' config values {leftovers} — no "
            f"TrainingArguments counterpart (the reference raises here too)")
    return ds


def _pad_batch(rows: Sequence[List[int]], pad_id: int,
               length: int) -> Dict[str, np.ndarray]:
    toks = np.full((len(rows), length), pad_id, np.int32)
    mask = np.zeros((len(rows), length), np.float32)
    for i, r in enumerate(rows):
        toks[i, :len(r)] = r[:length]
        mask[i, :min(len(r), length)] = 1.0
    return {"tokens": toks, "loss_mask": mask}


def causal_lm_loss(apply_fn):
    """Next-token CE over the forward's logits for ``batch = {tokens,
    loss_mask}``: the mean NLL over the masked target positions."""
    def loss_fn(p, batch):
        logits = apply_fn(p, batch["tokens"][:, :-1])
        targets = batch["tokens"][:, 1:]
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
        mask = batch["loss_mask"][:, 1:].float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    return loss_fn


class Trainer:
    """Minimal HF-Trainer facade over :func:`deepspeed_tpu_torch.
    initialize`.

    ``model_dir``: an HF checkpoint directory to fine-tune (loaded through
    :func:`~deepspeed_tpu_torch.integrations.hf.from_pretrained` on
    ``device``), or ``model``, the ``(apply_fn, params, cfg, specs)`` tuple
    itself.  ``args``: :class:`TrainingArguments`; ``args.deepspeed`` is
    required (the contract this bridge exists for).  ``train_dataset``:
    rows of ``{"input_ids": [...]}``.  ``device``: None = CUDA.
    """

    def __init__(self, model: Any = None, args: TrainingArguments = None,
                 train_dataset: Iterable = None, *,
                 model_dir: Optional[str] = None,
                 arch: Optional[str] = None,
                 max_seq_len: Optional[int] = None, device=None):
        if args is None or args.deepspeed is None:
            raise ValueError(
                "Trainer requires TrainingArguments with a `deepspeed` "
                "config (dict or json path) — that contract is the point "
                "of this bridge")
        if (model is None) == (model_dir is None):
            raise ValueError("pass exactly one of model / model_dir")
        from deepspeed_tpu_torch.integrations import hf as hf_io

        if model_dir is not None:
            model = hf_io.from_pretrained(model_dir, arch=arch, device=device)
        self.apply_fn, params, self.model_cfg, self.param_specs = model
        if params is None:
            raise ValueError("checkpoint had no weights to fine-tune")
        self.args = args
        self.train_dataset = list(train_dataset or [])
        if not self.train_dataset:
            raise ValueError("train_dataset is empty")
        ds = args.deepspeed
        if isinstance(ds, str):
            with open(ds) as f:
                ds = json.load(f)

        self._rows = [list(map(int, r["input_ids"]))
                      for r in self.train_dataset]
        self.max_seq_len = max_seq_len or min(
            self.model_cfg.max_seq_len, max(len(r) for r in self._rows))
        steps_per_epoch = self._steps_per_epoch(ds, args)
        num_update_steps = (args.max_steps if args.max_steps > 0 else
                            math.ceil(args.num_train_epochs
                                      * steps_per_epoch))
        ds = _resolve_auto(ds, args, num_update_steps)
        self.num_update_steps = num_update_steps

        # the JSON activation_checkpointing block reaches the built
        # forward: apply_fn closes over this (mutable) model config
        from deepspeed_tpu_torch.config import Config as _DsConfig

        ac_policy = _DsConfig.from_dict(ds).activation_checkpointing.policy
        if ac_policy != "none" and hasattr(self.model_cfg, "remat"):
            from deepspeed_tpu_torch.remat import check

            self.model_cfg.remat = check(ac_policy)

        from deepspeed_tpu_torch.engine import initialize

        self.engine, self.optimizer, _, self.lr_scheduler = initialize(
            loss_fn=causal_lm_loss(self.apply_fn), params=params, config=ds,
            param_specs=self.param_specs, device=device)
        self._pad_id = 0

    def _steps_per_epoch(self, ds: Dict[str, Any],
                         args: TrainingArguments) -> int:
        # the global batch is final only once the engine resolves it;
        # estimate it with the same arithmetic for total_num_steps (one
        # device: the world size is 1)
        micro = ds.get("train_micro_batch_size_per_gpu")
        if micro in (None, "auto"):
            micro = args.per_device_train_batch_size
        accum = ds.get("gradient_accumulation_steps")
        if accum in (None, "auto"):
            accum = args.gradient_accumulation_steps
        return max(1, len(self.train_dataset) // (micro * accum))

    # -------------------------------------------------------------- training
    def get_train_dataloader(self, epoch: int = 0):
        """Shuffled epoch iterator of padded ``{tokens, loss_mask}``
        batches (a fresh permutation per epoch, like the HF Trainer's
        sampler)."""
        B = self.engine.train_batch_size
        if len(self._rows) < B:
            raise ValueError(
                f"train_dataset has {len(self._rows)} rows but the global "
                f"batch is {B} (micro*accum*world) — not even one batch")
        rng = np.random.default_rng(self.args.seed + epoch)
        order = rng.permutation(len(self._rows))
        for i in range(0, len(order) - B + 1, B):
            rows = [self._rows[j] for j in order[i:i + B]]
            yield _pad_batch(rows, self._pad_id, self.max_seq_len)

    def train(self) -> Dict[str, float]:
        """Run the configured steps/epochs; returns the final metrics (the
        reference returns a TrainOutput; a plain dict here)."""
        args = self.args
        target = self.num_update_steps
        step = 0
        epoch = 0
        losses: List[float] = []
        while step < target:
            for batch in self.get_train_dataloader(epoch):
                loss = float(self.engine.train_batch(batch))
                losses.append(loss)
                step += 1
                if args.logging_steps and step % args.logging_steps == 0:
                    logger.info("trainer step %d/%d loss=%.4f lr=%.2e",
                                step, target, loss,
                                self.engine.get_lr()[0])
                if step >= target:
                    break
            epoch += 1
        return {"train_loss": float(np.mean(losses)) if losses else 0.0,
                "train_steps": step, "final_loss": losses[-1]}

    # ------------------------------------------------------------ save/export
    def save_model(self, output_dir: Optional[str] = None) -> str:
        """Export HF-layout safetensors (ref: Trainer.save_model)."""
        from deepspeed_tpu_torch.integrations import hf as hf_io

        out = output_dir or self.args.output_dir
        hf_io.save_pretrained(self.engine.module_params(), self.model_cfg,
                              out)
        return out

    def save_state(self, output_dir: Optional[str] = None) -> str:
        """Engine checkpoint (optimizer state included) for resumption."""
        out = os.path.join(output_dir or self.args.output_dir, "ds_ckpt")
        return self.engine.save_checkpoint(out)
