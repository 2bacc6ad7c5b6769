"""Training engine on one GPU (port of ``deepspeed_tpu/engine.py``; ref:
deepspeed/runtime/engine.py DeepSpeedEngine + deepspeed.initialize).

ZeRO stage 0 on one device.  The master params live in the config's
master dtype (f32).  Each step casts them once to the compute dtype (bf16,
or fp16 under the dynamic loss scaler) as a detached copy, so autograd
never holds the master, and runs the loss and its backward on that copy
once per microbatch; the gradients accumulate in f32 and are divided by
the accumulation count (the JAX step casts inside every microbatch, to the
same values).  Then come unscale/overflow check, global-norm clipping and
the optimizer, applied one leaf at a time in place (``p += u``), so
neither the update nor the new optimizer state is ever a whole-model tree
beside the old one.  On overflow the params and optimizer state are kept
and the step does not advance, as ``_finish_step`` does.

``train_batch`` first truncates the batch to the curriculum's current
sequence length when a ``curriculum_learning`` block is configured, as the
JAX engine does.  ``save_checkpoint`` / ``load_checkpoint`` /
``wait_for_checkpoint`` resume a run (:mod:`deepspeed_tpu_torch.checkpoint`).

DeepSpeed's three-call idiom is kept::

    loss = engine(batch)        # runs the whole step and commits it
    engine.backward(loss)       # no-op: the backward ran inside the step
    engine.step()               # bookkeeping

beside ``loss = engine.train_batch(batch)``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch import lr_schedules, precision
from deepspeed_tpu_torch._device import resolve_device
from deepspeed_tpu_torch._tree import tree_leaves, tree_map, \
    tree_unflatten_like
from deepspeed_tpu_torch.config import Config
from deepspeed_tpu_torch.data.curriculum import (CurriculumScheduler,
                                                 apply_seqlen_curriculum)
from deepspeed_tpu_torch.ops.optim import Optimizer, default_lr
from deepspeed_tpu_torch.ops.optim import from_config as opt_from_config
from deepspeed_tpu_torch.timers import ThroughputTimer

_MONITORS = ("tensorboard", "wandb", "csv_monitor", "comet")


class TrainState(NamedTuple):
    step: int                  # optimizer steps taken (skipped ones not)
    params: Any                # master params (master dtype)
    opt_state: Any
    scaler: precision.ScalerState


def accum_split(batch: Any, accum: int) -> Any:
    """[B, ...] -> [accum, B/accum, ...] microbatch split (one device: the
    JAX package's split with no data axis)."""
    return tree_map(
        lambda x: x.reshape((accum, x.shape[0] // accum) + tuple(x.shape[1:])),
        batch)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, accumulated in f32."""
    return torch.sqrt(torch.stack(
        [torch.sum(torch.square(l.float())) for l in tree_leaves(tree)]).sum())


def _clip_factor(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-6), max=1.0)


def clip_by_global_norm(tree: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """ref: deepspeed/runtime/utils.py clip_grad_norm_ -> (clipped tree,
    pre-clip norm).  The factor multiply keeps each leaf's dtype."""
    norm = global_norm(tree)
    factor = _clip_factor(norm, max_norm)
    return tree_map(lambda g: g * factor.to(g.dtype), tree), norm


def _to_device(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def _unsupported(config: Config, params, optimizer) -> Optional[str]:
    """The first configured feature this slice does not run, or None."""
    z = config.zero
    if z.stage > 0:
        return f"ZeRO stage {z.stage} (ROADMAP A9, distributed slice)"
    if z.offload_param or z.offload_optimizer:
        return "ZeRO offload (ROADMAP A9)"
    if z.zeropp_quantized_gradients or z.zeropp_quantized_weights:
        return "ZeRO++ qgZ/qwZ (ROADMAP A9)"
    name = optimizer.name if optimizer is not None else config.optimizer.type
    if name.startswith(("onebit", "zeroone")):
        return f"1-bit optimizer {name!r} (ROADMAP A9)"
    if config.pipeline.stages > 1:
        return "pipeline parallelism (ROADMAP A9)"
    if config.progressive_layer_drop:
        return "progressive_layer_drop (ROADMAP A11)"
    if config.eigenvalue:
        return "eigenvalue (ROADMAP A11)"
    if "telemetry" in config.raw and config.telemetry.enabled:
        return "the telemetry block (ROADMAP A10)"
    for key in _MONITORS:
        if (config.raw.get(key) or {}).get("enabled"):
            return f"the {key} monitor (ROADMAP A10)"
    if callable(params) or not isinstance(params, (dict, list, tuple)):
        return ("params that are not a tree of arrays (init thunks and "
                "LayeredModel param streaming, ROADMAP A9)")
    return None


class TrainingEngine:
    """The train step of one device at ZeRO stage 0 + host bookkeeping.

    ``loss_fn``: ``(params, batch) -> loss`` or ``-> (loss, aux)`` with
    ``has_aux``; ``params`` arrive cast to the compute dtype.  ``params``:
    the initial master tree (torch tensors or numpy arrays; copied, then
    cast to the master dtype on ``device``).  ``device``: None = CUDA.
    """

    def __init__(self, loss_fn: Callable, params: Any, config: Config,
                 optimizer: Optional[Optimizer] = None, lr_scheduler=None,
                 has_aux: bool = False, device=None):
        why = _unsupported(config, params, optimizer)
        if why is not None:
            raise NotImplementedError(
                f"{why} is not ported yet; this slice trains at ZeRO "
                "stage 0 on one GPU")
        self.config = config
        self.device = resolve_device(device)
        config.resolve_batch_sizes(1)
        self.loss_fn = loss_fn
        self.has_aux = has_aux

        opt_lr = float(config.optimizer.params.get(
            "lr", default_lr(config.optimizer.type)))
        self.lr_schedule = (
            lr_scheduler if callable(lr_scheduler)
            else lr_schedules.from_config(config.scheduler.type,
                                          config.scheduler.params,
                                          fallback_lr=opt_lr))
        if optimizer is None:
            oparams = dict(config.optimizer.params)
            oparams["lr"] = self.lr_schedule
            optimizer = opt_from_config(config.optimizer.type, oparams)
        self.optimizer = optimizer

        mdt = precision.master_dtype(config.precision)

        def master(p):
            t = _to_device(p, self.device)
            dt = mdt if t.is_floating_point() else t.dtype
            return t.to(device=self.device, dtype=dt, copy=True)

        params = tree_map(master, params)
        opt_state = self.optimizer.init(params)
        if not (isinstance(opt_state, tuple) and hasattr(opt_state, "_fields")
                and isinstance(opt_state[0], int)):
            raise ValueError(
                f"optimizer {self.optimizer.name!r}: the engine applies "
                "updates one leaf at a time and needs a NamedTuple state "
                "(step: int, then trees shaped like the params)")
        self.state = TrainState(step=0, params=params, opt_state=opt_state,
                                scaler=precision.scaler_init(config.precision))
        # curriculum (ref: engine.curriculum_scheduler): seqlen-type
        # curricula truncate each batch's sequence axis before the step
        self.curriculum_scheduler = (
            CurriculumScheduler(config.curriculum)
            if config.curriculum is not None and config.curriculum.enabled
            else None)
        # ref: ThroughputTimer in engine.train; the engine starts and stops
        # it only for the monitors and telemetry, which are not ported
        self.tput_timer = ThroughputTimer(
            batch_size=config.train_batch_size, device=self.device)
        self.global_steps = 0
        self.skipped_steps = 0
        self._pending: Optional[dict] = None
        self._last_metrics: dict = {}

    # ------------------------------------------------------------------ step
    def _compute_params(self):
        """A detached copy of the master params in the compute dtype whose
        float leaves require grad (a view of the master when the dtypes
        agree: nothing writes the master until the backward is done)."""
        dt = precision.compute_dtype(self.config.precision)

        def cast(p):
            if not p.is_floating_point():
                return p
            return p.detach().to(dt).requires_grad_(True)

        return tree_map(cast, self.state.params)

    def _loss_for(self, cparams, batch):
        out = self.loss_fn(cparams, batch)
        loss, aux = out if self.has_aux else (out, None)
        return loss.float(), aux

    def _batch(self, batch):
        return tree_map(lambda x: _to_device(x, self.device), batch)

    def _train_step(self, batch) -> dict:
        cfg = self.config
        accum = cfg.gradient_accumulation_steps
        batch = self._batch(batch)
        micro = (accum_split(batch, accum) if accum > 1 else None)
        cparams = self._compute_params()
        leaves = tree_leaves(cparams)
        live = [i for i, p in enumerate(leaves) if p.requires_grad]
        grads = [torch.zeros(p.shape, dtype=torch.float32,
                             device=self.device) for p in leaves]
        loss_sum, auxes = None, []
        for i in range(accum):
            mb = batch if micro is None else tree_map(lambda x: x[i], micro)
            loss, aux = self._loss_for(cparams, mb)
            scaled = precision.scale_loss(loss, self.state.scaler,
                                          cfg.precision)
            gs = torch.autograd.grad(scaled, [leaves[j] for j in live],
                                     allow_unused=True)
            for j, g in zip(live, gs):
                if g is not None:
                    grads[j].add_(g)        # f32 += the upcast gradient
            # the graph's root holds the compute copy: drop it with the
            # compute-dtype grads before the next microbatch or the update
            del gs, scaled
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            # detached, so the microbatch's graph is not kept alive
            auxes.append(tree_map(lambda t: t.detach(), aux))
        del cparams, leaves
        if accum > 1:
            for g in grads:
                g /= accum
        loss = loss_sum / accum if accum > 1 else loss_sum
        grads = tree_unflatten_like(self.state.params, grads)
        return self._finish_step(grads, loss, auxes)

    def _finish_step(self, grads, loss, auxes) -> dict:
        """Unscale/overflow-check, clip, update, commit (the JAX
        ``_finish_step``)."""
        cfg = self.config
        step = self.state.step
        grads, ok, scaler = precision.unscale_and_check(
            grads, self.state.scaler, cfg.precision)
        gnorm = global_norm(grads)
        if ok:
            if cfg.gradient_clipping > 0:
                factor = _clip_factor(gnorm, cfg.gradient_clipping)
                for g in tree_leaves(grads):
                    g.mul_(factor)
            self._apply_updates(grads)
        self.state = self.state._replace(
            step=self.state.step + int(ok), scaler=scaler)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "overflow": int(not ok), "lr": self.lr_schedule(step + 1),
                   "loss_scale": scaler.scale}
        if self.has_aux:
            metrics["aux"] = (auxes[0] if len(auxes) == 1 else
                              tree_map(lambda *a: torch.stack(a).mean(0),
                                       *auxes))
        return metrics

    def _apply_updates(self, grads) -> None:
        """``optimizer.update`` one leaf at a time, then ``p += u`` in
        place.  The old state's leaves are held only by ``cols``, so each
        is freed as soon as its replacement lands."""
        opt = self.state.opt_state
        kind, step = type(opt), opt[0]
        skeletons = [None if f is None else tree_map(lambda _: 0, f)
                     for f in opt[1:]]
        cols = [None if f is None else tree_leaves(f) for f in opt[1:]]
        self.state = self.state._replace(opt_state=None)
        del opt
        new_step = step
        try:
            for i, (p, g) in enumerate(zip(tree_leaves(self.state.params),
                                           tree_leaves(grads))):
                sub = kind(step, *(None if c is None else c[i] for c in cols))
                u, new = self.optimizer.update(g, sub, p)
                p.add_(u.to(p.dtype))
                del u
                for c, leaf in zip(cols, new[1:]):
                    if c is not None:
                        c[i] = leaf
                new_step = new[0]
        finally:
            self.state = self.state._replace(opt_state=kind(
                new_step, *(None if c is None else tree_unflatten_like(s, c)
                            for s, c in zip(skeletons, cols))))

    # ----------------------------------------------------------- public API
    def _post_step(self, metrics) -> None:
        self.global_steps += 1
        self.skipped_steps += metrics["overflow"]
        self._last_metrics = metrics

    def curriculum_difficulty(self) -> Optional[int]:
        """Current curriculum difficulty (ref: engine.curriculum_scheduler
        .get_difficulty), or None when no curriculum is configured."""
        if self.curriculum_scheduler is None:
            return None
        return self.curriculum_scheduler.get_difficulty(self.global_steps)

    def _apply_curriculum(self, batch):
        return apply_seqlen_curriculum(batch, self.curriculum_scheduler,
                                       self.global_steps)

    def train_batch(self, batch) -> torch.Tensor:
        """One optimizer step on a global batch; returns the loss (an f32
        scalar tensor on the device)."""
        metrics = self._train_step(self._apply_curriculum(batch))
        self._post_step(metrics)
        return metrics["loss"]

    def eval_batch(self, batch):
        with torch.no_grad():
            cparams = self._compute_params()
            loss, aux = self._loss_for(cparams, self._batch(batch))
        return loss if aux is None else (loss, aux)

    def __call__(self, batch):
        metrics = self._train_step(self._apply_curriculum(batch))
        self._pending = metrics
        self._last_metrics = metrics
        return metrics["loss"]

    def forward(self, batch):
        return self(batch)

    def backward(self, loss):
        """No-op: the backward ran inside ``engine(batch)``."""
        if self._pending is None:
            raise RuntimeError(
                "backward() without a preceding engine(batch) call")
        return loss

    def step(self):
        """Complete the step started by ``engine(batch)`` (bookkeeping)."""
        if self._pending is None:
            raise RuntimeError("step() without a preceding engine(batch) call")
        metrics, self._pending = self._pending, None
        self._post_step(metrics)

    @property
    def metrics(self):
        return self._last_metrics

    def get_lr(self):
        return [float(self.lr_schedule(self.state.step))]

    def get_global_grad_norm(self) -> float:
        m = self._last_metrics.get("grad_norm")
        return float(m) if m is not None else 0.0

    @property
    def train_batch_size(self):
        return self.config.train_batch_size

    @property
    def gradient_accumulation_steps(self):
        return self.config.gradient_accumulation_steps

    def module_params(self):
        """The master params (one device: no gather).  These are the live
        tensors, which later steps update in place."""
        return self.state.params

    # ---------------------------------------------------------- checkpointing
    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[dict] = None,
                        async_save: bool = False):
        from deepspeed_tpu_torch.checkpoint import save_checkpoint as _save

        return _save(self, save_dir, tag=tag, client_state=client_state,
                     async_save=async_save)

    def wait_for_checkpoint(self):
        from deepspeed_tpu_torch.checkpoint import wait_for_checkpoint as _wait

        return _wait(self)

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None):
        from deepspeed_tpu_torch.checkpoint import load_checkpoint as _load

        return _load(self, load_dir, tag=tag)


def initialize(args=None, *, loss_fn: Optional[Callable] = None,
               params: Any = None, config: Any = None,
               optimizer: Optional[Optimizer] = None, lr_scheduler=None,
               training_data=None, has_aux: bool = False,
               dist_init_required: Optional[bool] = None, device=None):
    """ref: deepspeed.initialize -> (engine, optimizer, dataloader,
    lr_schedule).  ``config`` may be a dict, a JSON path or a Config;
    ``device`` None means CUDA."""
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    if isinstance(config, str):
        config = Config.from_file(config)
    elif isinstance(config, dict):
        config = Config.from_dict(config)
    elif config is None:
        config = Config()
    if loss_fn is None or params is None:
        raise ValueError("initialize() needs loss_fn and params")
    engine = TrainingEngine(loss_fn, params, config, optimizer=optimizer,
                            lr_scheduler=lr_scheduler, has_aux=has_aux,
                            device=device)
    return _finish_initialize(engine, config, training_data)


def _finish_initialize(engine, config, training_data):
    """initialize()'s tail: the dataloader over ``training_data`` (global
    batches of numpy arrays, which ``train_batch`` moves to the device) and
    the 4-tuple."""
    dataloader = None
    if training_data is not None:
        from deepspeed_tpu_torch.data.loader import DataLoader

        dataloader = DataLoader(training_data,
                                batch_size=config.train_batch_size,
                                seed=config.seed)
    return engine, engine.optimizer, dataloader, engine.lr_schedule
