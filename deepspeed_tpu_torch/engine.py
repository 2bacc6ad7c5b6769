"""Training engine (port of ``deepspeed_tpu/engine.py``; ref:
deepspeed/runtime/engine.py DeepSpeedEngine + deepspeed.initialize).

One rank a GPU, data parallel over the ``data`` axis of a mesh built from
the process group (:mod:`deepspeed_tpu_torch.topology`), ZeRO stages 0-3
(:mod:`deepspeed_tpu_torch.zero`).  Each rank takes the rows of the global
batch that the JAX package's ``[dp, accum, mb]`` view gives its device,
casts the master params once a step to the compute dtype (bf16, or fp16
under the dynamic loss scaler) as a detached copy, so autograd never holds
the master, and runs the loss and its backward once a microbatch; the
gradients accumulate in f32 and are divided by the accumulation count.
Then the grads are averaged over the ranks: all-reduced at stages 0 and 1,
reduce-scattered to each rank's shard at stages 2 and 3.  The loss is the
mean over ranks; the overflow decision (an all-reduced minimum) and the
global norm (each leaf's sum of squares on this rank, all-reduced once) are
the same on every rank.  The optimizer runs one leaf at a time in place
(``p += u``): at stages 1-3 on this rank's shard of the master and the
moments (fused Adam, B4, on CUDA), after which stages 1 and 2 all-gather
the new master; stage 3 keeps f32 shards and gathers the compute-dtype
tree leaf by leaf before the forward, freeing it after the backward.  On
overflow the params and optimizer state are kept and the step does not
advance, as ``_finish_step`` does.  The machinery runs at a world of one
too, collectives included.  ZeRO++ (qgZ, qwZ, hpZ) and the 1-bit
optimizers take the compressed steps of :mod:`~deepspeed_tpu_torch.
comm_compress`.

Unscheduled ``offload_optimizer`` / ``offload_param`` blocks (``device:
cpu``, no ``scheduled``; ZeRO-Offload) keep the named state in page-locked
host memory at every stage: the moments and the f32 master for the
optimizer block, the master for the param block; whole leaves at stage 0,
this rank's shards from stage 1 (:func:`~deepspeed_tpu_torch.offload.
offload_placement`).  Each leaf or shard visits the card for its cast and
its update (B4 under ``fused_adam``) and goes back.  At stages 1 and 2 a
host master is a shard, so the card keeps the whole compute-dtype copy,
and the new shard is cast and all-gathered into it after the update (the
reference's fp16 all-gather).  Casting commutes with the gather, so the
results equal the engine without the block bit for bit.  The scheduled
and NVMe blocks go to the streaming engines (:func:`initialize`).

:meth:`TrainingEngine.comms_digest` counts the collectives of one dry
step (:mod:`deepspeed_tpu_torch.comm.digest`).

``train_batch`` first truncates the batch to the curriculum's current
sequence length when a ``curriculum_learning`` block is configured, as the
JAX engine does.  ``save_checkpoint`` / ``load_checkpoint`` /
``wait_for_checkpoint`` resume a run at any stage and world size
(:mod:`deepspeed_tpu_torch.checkpoint`).

DeepSpeed's three-call idiom is kept::

    loss = engine(batch)        # runs the whole step and commits it
    engine.backward(loss)       # no-op: the backward ran inside the step
    engine.step()               # bookkeeping

beside ``loss = engine.train_batch(batch)``.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch import comm, comm_compress, lr_schedules, \
    precision, topology, zero
from deepspeed_tpu_torch._device import resolve_device
from deepspeed_tpu_torch._tree import tree_leaves, tree_map, \
    tree_unflatten_like
from deepspeed_tpu_torch.config import Config
from deepspeed_tpu_torch.data.curriculum import (CurriculumScheduler,
                                                 apply_seqlen_curriculum)
from deepspeed_tpu_torch.monitor import MonitorMaster
from deepspeed_tpu_torch.ops.losses import global_batch_mean
from deepspeed_tpu_torch.ops.optim import Optimizer, default_lr
from deepspeed_tpu_torch.ops.optim import from_config as opt_from_config
from deepspeed_tpu_torch.telemetry import MetricsRegistry, TelemetryExporter
from deepspeed_tpu_torch.timers import ThroughputTimer

logger = logging.getLogger(__name__)

# optimizers whose update reads a whole leaf (a trust ratio's norms)
_PER_LEAF_NORM = ("lamb", "fusedlamb")


class TrainState(NamedTuple):
    step: int                  # optimizer steps taken (skipped ones not)
    params: Any                # master params (master dtype): whole leaves,
    #                            this rank's shards at stage 3, its flat
    #                            row under qwZ
    opt_state: Any             # at stages >= 1 this rank's shards
    scaler: precision.ScalerState


def accum_split(batch: Any, accum: int) -> Any:
    """[B, ...] -> [accum, B/accum, ...] microbatch split (one device: the
    JAX package's split with no data axis)."""
    return tree_map(
        lambda x: x.reshape((accum, x.shape[0] // accum) + tuple(x.shape[1:])),
        batch)


def rank_rows(batch: Any, world: int, rank: int) -> Any:
    """Rank ``rank``'s rows of a global batch: the block ``[r n, (r + 1)
    n)``, ``n = B / world``, which JAX's ``[dp, accum, mb]`` view gives
    device r (scalars as they are)."""
    if world == 1:
        return batch

    def rows(x):
        if not getattr(x, "ndim", 0):
            return x
        n = x.shape[0] // world
        return x[rank * n:(rank + 1) * n]

    return tree_map(rows, batch)


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


def _is_init_thunk(params) -> bool:
    """A zero-argument callable that returns the param tree (zero.Init
    parity), not a tree."""
    return callable(params) and not isinstance(params, (dict, list, tuple))


def _unsupported(config: Config, params) -> Optional[str]:
    """The first configured feature this engine does not run, or None."""
    if config.progressive_layer_drop:
        return "progressive_layer_drop (ROADMAP A11)"
    if config.eigenvalue:
        return "eigenvalue (ROADMAP A11)"
    if not _is_init_thunk(params) and not isinstance(params,
                                                     (dict, list, tuple)):
        return ("params that are neither a tree of arrays nor an init "
                "thunk (a LayeredModel goes to the param-stream engine "
                "through initialize())")
    return None


def mesh_for(config: Config, device: torch.device) -> topology.MeshSpec:
    """The engine's mesh over the process group: the config's ``mesh``
    block (every rank on ``data`` by default; ``model``, ``seq``, ``pipe``
    and ``expert`` as it sets them).  The current mesh is reused when it
    has those sizes, so engines built in turn share one set of process
    groups."""
    world = comm.get_world_size()
    sizes = config.mesh.axis_sizes(world)
    ms = topology.current_mesh()
    live = torch.distributed.is_initialized()
    if ms is not None and ms.sizes == {a: sizes.get(a, 1)
                                       for a in topology.AXES} \
            and (ms.device_mesh is not None) == live:
        return ms
    nccl = live and torch.distributed.get_backend() == "nccl"
    return topology.MeshSpec.build(
        sizes, device_type="cuda" if device.type == "cuda" and nccl
        else "cpu")


# the axes besides data a param spec may split a leaf over
_MP_AXES = ("pipe", "expert", "seq", "model")


class TrainingEngine:
    """The data-parallel train step (ZeRO stages 0-3, ZeRO++, 1-bit) on
    this rank + host bookkeeping.

    ``loss_fn``: ``(params, batch) -> loss`` or ``-> (loss, aux)`` with
    ``has_aux``; ``params`` arrive cast to the compute dtype, this rank's
    blocks of the leaves a ``param_specs`` tree splits.  ``params``: the
    initial master tree (torch tensors or numpy arrays, the same on every
    rank; copied, cut to this rank's blocks, cast to the master dtype and
    placed on ``device``), or a zero-argument init thunk
    (:func:`~deepspeed_tpu_torch.zero.sharded_init`).  ``device``: None =
    CUDA.  ``mesh``: default :func:`mesh_for` the config.
    ``param_specs``: model-parallel placements (a tree of specs over
    ``model`` / ``pipe`` / ``expert``, or a callable ``leaf -> spec``);
    ZeRO layers the data axis onto a dim each leaves free.

    Every rank of ``data`` x ``expert`` takes its rows of the global
    batch; the ranks of ``seq`` take the same rows (the model splits the
    sequence), and so do those of ``model`` and ``pipe``.  A leaf's grads
    are summed over every axis that splits the tokens and does not split
    the leaf (``seq``; ``expert`` for a leaf that is not an expert's), then
    over ``data`` as the stage says.
    """

    def __init__(self, loss_fn: Callable, params: Any, config: Config,
                 optimizer: Optional[Optimizer] = None, lr_scheduler=None,
                 has_aux: bool = False, device=None,
                 mesh: Optional[topology.MeshSpec] = None,
                 param_specs: Any = None):
        why = _unsupported(config, params)
        if why is not None:
            raise NotImplementedError(f"{why} is not ported yet")
        self.config = config
        self._cparams: Optional[List[torch.Tensor]] = None
        self._pinned: list = []
        # host <-> card bytes of the offloaded state in the last step
        self.link_bytes = {"up": 0, "down": 0}
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else mesh_for(config,
                                                           self.device)
        topology.set_current_mesh(self.mesh)
        self.dp = self.mesh.size("data")
        self.rank = self.mesh.rank_in("data")
        self._live = [a for a in topology.AXES if self.mesh.size(a) > 1]
        self._batch_live = [a for a in topology.BATCH_AXES
                            if self.mesh.size(a) > 1]
        stages = config.pipeline.stages
        if stages > 1 and self.mesh.size("pipe") != stages:
            raise ValueError(
                f"pipeline.stages {stages} needs a mesh with pipe = "
                f"{stages}, got pipe = {self.mesh.size('pipe')}")
        config.resolve_batch_sizes(self.mesh.dp_world)
        self.loss_fn = loss_fn
        self.has_aux = has_aux
        stage = config.zero.stage
        self.stage = stage

        name = optimizer.name if optimizer is not None \
            else config.optimizer.type
        self.grad_comm_mode = comm_compress.resolve_mode(
            config, self.mesh, name, has_aux)
        mode = self.grad_comm_mode
        if mode == "qwz" and (config.zero.offload_param
                               or config.zero.offload_optimizer):
            raise ValueError(
                "zero_quantized_weights does not compose with offload "
                "(the flat-shard step owns the param layout); use the "
                "scheduled Infinity engine or drop the qwZ flag")
        if mode == "onebit" and config.gradient_clipping > 0:
            logger.warning(
                "gradient_clipping is ignored under the 1-bit optimizer "
                "path (the exact global grad never exists; the reference "
                "has the same semantics)")
        if mode == "onebit" and optimizer is not None and \
                optimizer.axis_name != comm_compress.AXIS:
            raise ValueError(
                "user-supplied 1-bit optimizer must be built with "
                f"axis_name={comm_compress.AXIS!r} to run in the engine's "
                "compressed step (yours has "
                f"axis_name={optimizer.axis_name!r}, which would do NO "
                "cross-rank communication and silently diverge); or "
                "omit `optimizer=` and configure it via the config dict")
        # a trust ratio reads whole-leaf norms: a leaf split over ranks
        # sums its blocks' squares over the axes that split it
        self._per_leaf_norm = name.lower() in _PER_LEAF_NORM

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
            if mode == "onebit":
                oparams["axis_name"] = comm_compress.AXIS
            optimizer = opt_from_config(config.optimizer.type, oparams)
        self.optimizer = optimizer

        mdt = precision.master_dtype(config.precision)
        if _is_init_thunk(params):
            # zero.Init parity: the tree is drawn on the host and each
            # leaf placed (cut to this rank's shard at stage 3) and dropped
            params = zero.draw_on_host(params)
        self._specs = zero.spec_leaves(params, param_specs)
        for sp in self._specs:
            bad = [a for a in zero.spec_axes(sp) if a not in _MP_AXES]
            if bad:
                raise ValueError(
                    f"param spec {sp} names {bad}: a param spec places "
                    f"leaves over {_MP_AXES} (ZeRO adds the data axis)")
        self._mp = any(zero.spec_axes(sp) for sp in self._specs)
        leaves = tree_leaves(params)
        self._skeleton = tree_unflatten_like(params, [0] * len(leaves))
        self._shapes = [tuple(np.shape(l)) for l in leaves]
        del params
        if mode == "qwz":
            self._setup_qwz_state(leaves, mdt)
            self._finish_init()
            return
        # the dim each leaf's shard splits (None: whole on every rank);
        # used from stage 1 (optimizer state), 2 (grads), 3 (master)
        self._dims = [None if stage < 1 or not _is_float(l)
                      else zero.shard_dim(s, self.dp, sp)
                      for s, l, sp in zip(self._shapes, leaves, self._specs)]
        master = zero.place_leaves(
            leaves, self._dims if stage >= 3 else [None] * len(leaves),
            self.rank, self.dp, self.device, mdt, self._specs, self.mesh)
        params = tree_unflatten_like(self._skeleton, master)
        del leaves, master
        if stage in (1, 2):
            opt_params = tree_unflatten_like(self._skeleton, [
                zero.take_shard(p, d, self.rank, self.dp)
                for p, d in zip(tree_leaves(params), self._dims)])
        else:
            opt_params = params
        opt_state = self.optimizer.init(opt_params)
        del opt_params
        # unscheduled offload blocks (ref: ZeRO-Offload; the JAX engine's
        # pinned_host memory-kind shardings): the optimizer block keeps the
        # moments and the f32 master in page-locked host memory, the param
        # block the master, whole at stage 0 and this rank's shards from
        # stage 1; each visits the card for its update
        from deepspeed_tpu_torch.offload import offload_placement

        place = offload_placement(config)
        self._host_opt, self._host_master = (place["optimizer"],
                                             place["master"])
        # stages 1-2 with a host master: the whole compute-dtype copy on
        # the card (self._cparams)
        if self._host_master and stage in (1, 2):
            cdt = precision.compute_dtype(config.precision)
            whole = tree_leaves(params)
            self._cparams = [p.detach().to(cdt) if p.is_floating_point()
                             else p for p in whole]
            params = tree_unflatten_like(self._skeleton, [
                self._to_host(zero.take_shard(p, d, self.rank, self.dp))
                for p, d in zip(whole, self._dims)])
            del whole
        elif self._host_master:
            params = tree_map(self._to_host, params)
        if self._host_opt:
            opt_state = type(opt_state)(opt_state[0], *(
                None if f is None else tree_map(self._to_host, f)
                for f in opt_state[1:]))
        if not (isinstance(opt_state, tuple) and hasattr(opt_state, "_fields")
                and isinstance(opt_state[0], int)):
            raise ValueError(
                f"optimizer {self.optimizer.name!r}: the engine applies "
                "updates one leaf at a time and needs a NamedTuple state "
                "(step: int, then trees shaped like the params)")
        self.state = TrainState(step=0, params=params, opt_state=opt_state,
                                scaler=precision.scaler_init(config.precision))
        if mode == "qgz":
            self._reduce_fn, self._hier = comm_compress.make_reduce_fn(
                config.comm, self.mesh)
        self._finish_init()

    def _finish_init(self) -> None:
        config = self.config
        # curriculum (ref: engine.curriculum_scheduler): seqlen-type
        # curricula truncate each batch's sequence axis before the step
        self.curriculum_scheduler = (
            CurriculumScheduler(config.curriculum)
            if config.curriculum is not None and config.curriculum.enabled
            else None)
        # monitoring + throughput (ref: engine._configure_monitoring +
        # ThroughputTimer in engine.train): backends from the reference's
        # config keys (tensorboard / wandb / csv_monitor); the timer runs
        # (and syncs the device) only when a monitor or step_sync reads it
        self.monitor = MonitorMaster(config.raw)
        self.tput_timer = ThroughputTimer(
            batch_size=config.train_batch_size, device=self.device)
        # unified telemetry (the `telemetry` block): a step-time
        # histogram and run gauges on a MetricsRegistry, with the optional
        # exporter bridging into the monitors / a Prometheus file.  The
        # step stays sync-free: the gauges that need a device read (loss,
        # grad norm, MFU) refresh on the steps_per_print cadence when a
        # sink reads them, or on demand through telemetry_snapshot()
        tel = config.telemetry
        self.registry = MetricsRegistry(enabled=tel.enabled)
        self._c_train_steps = self.registry.counter(
            "train_steps", "optimizer steps taken")
        self._h_step = self.registry.histogram(
            "train_step_seconds",
            "per-step wall time (host wall unless telemetry.step_sync — "
            "then device-synced via the ThroughputTimer)",
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0))
        self._g_loss = self.registry.gauge("train_loss")
        self._g_lr = self.registry.gauge("train_lr")
        self._g_grad_norm = self.registry.gauge("train_grad_norm")
        self._g_sps = self.registry.gauge(
            "train_samples_per_sec", "ThroughputTimer samples/sec")
        self._g_mfu = self.registry.gauge(
            "train_mfu", "model FLOPs utilization vs the card's peak "
            "(0 until flops_per_sample is configured)")
        self._tel_sync = tel.enabled and tel.step_sync
        self._tel_exporter = None
        if tel.enabled and (tel.prometheus_path or tel.http_port
                            is not None or (tel.monitor_bridge
                                            and self.monitor.enabled)):
            self._tel_exporter = TelemetryExporter(
                self.registry,
                monitor=self.monitor if tel.monitor_bridge else None,
                prometheus_path=tel.prometheus_path,
                interval_s=tel.interval_s, http_port=tel.http_port)
        self.global_steps = 0
        self.skipped_steps = 0
        self._pending: Optional[dict] = None
        self._last_metrics: dict = {}
        self._dry = False

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """A page-locked host copy of ``t`` (plain host memory without
        CUDA)."""
        from deepspeed_tpu_torch.infinity import pinned_views

        out = pinned_views([tuple(t.shape)], [t.dtype], self._pinned)[0]
        return out.copy_(t)

    def _visit(self, t: torch.Tensor) -> torch.Tensor:
        """A host-placed leaf's copy on the card (the leaf itself when it
        already lives there)."""
        if t.device.type == self.device.type:
            return t
        self.link_bytes["up"] += t.numel() * t.element_size()
        return torch.empty_like(t, device=self.device).copy_(
            t, non_blocking=True)

    def _leave(self, host: torch.Tensor, t: torch.Tensor) -> None:
        """Write a visiting copy ``t`` back into its host tensor."""
        if t is not host:
            self.link_bytes["down"] += t.numel() * t.element_size()
            host.copy_(t)

    # ------------------------------------------------------- qwZ flat state
    def _setup_qwz_state(self, leaves: list, mdt) -> None:
        """ZeRO++ qwZ layout (ref ``zero_quantized_weights``): the master
        params as one flat ``[world, chunk]`` buffer of which this rank
        keeps row ``rank`` (each leaf's part that falls in the row is
        copied there and the leaf dropped); the step all-gathers the rows
        as int8 codes and scales to rebuild the compute leaves."""
        self._qwz_sizes = [int(np.prod(s)) for s in self._shapes]
        total = sum(self._qwz_sizes)
        unit = comm_compress._GROUP
        C = -(-total // (self.dp * unit)) * unit
        self._qwz_chunk = C
        lo = self.rank * C
        row = torch.zeros(C, dtype=mdt, device=self.device)
        off = 0
        for i, n in enumerate(self._qwz_sizes):
            a, b = max(off, lo), min(off + n, lo + C)
            if a < b:
                flat = torch.as_tensor(leaves[i]).reshape(-1)
                row[a - lo:b - lo] = flat[a - off:b - off].to(
                    device=self.device, dtype=mdt)
            leaves[i] = None
            off += n
        self.state = TrainState(
            step=0, params=row, opt_state=self.optimizer.init(row),
            scaler=precision.scaler_init(self.config.precision))
        self._gather_row, self._hier = comm_compress.make_weight_gather(
            self.config.comm, self.mesh)

    def _qwz_flatten(self, leaves: List[torch.Tensor], dtype):
        """Leaves -> the padded flat ``[world * chunk]`` buffer."""
        flat = torch.cat([l.reshape(-1).to(dtype) for l in leaves])
        pad = self.dp * self._qwz_chunk - flat.shape[0]
        return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat

    def _qwz_unflatten(self, flat, dtype):
        """The flat buffer's unpadded prefix -> the param tree."""
        out, off = [], 0
        for shape, n in zip(self._shapes, self._qwz_sizes):
            out.append(flat[off:off + n].reshape(shape).to(dtype))
            off += n
        return tree_unflatten_like(self._skeleton, out)

    def _qwz_exact_params(self, dtype):
        """The master tree from the rows, gathered exactly (f32)."""
        full = comm.all_gather(self.state.params, "data")
        return self._qwz_unflatten(full, dtype)

    # ------------------------------------------------------------------ step
    def _compute_params(self):
        """The compute-dtype tree whose float leaves require grad: a
        detached copy of the master (a view when the dtypes agree: nothing
        writes the master until the backward is done), gathered leaf by
        leaf from the shards at stage 3 (exactly, from the rows under
        qwZ only for eval)."""
        dt = precision.compute_dtype(self.config.precision)
        if self.grad_comm_mode == "qwz":
            return tree_map(lambda p: p.detach(),
                            self._qwz_exact_params(dt))
        if self._cparams is not None:
            return tree_unflatten_like(self._skeleton, [
                c.detach().requires_grad_(True) if c.is_floating_point()
                else c for c in self._cparams])
        if self.stage >= 3:
            leaves = [zero.gather_shard(
                self._visit(p).detach().to(dt) if p.is_floating_point()
                else self._visit(p), d)
                for p, d in zip(tree_leaves(self.state.params), self._dims)]
            return tree_unflatten_like(self._skeleton, [
                l.requires_grad_(True) if l.is_floating_point() else l
                for l in leaves])

        def cast(p):
            p = self._visit(p)
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

    def _local_rows(self, batch, parts: int = 1):
        """This rank's rows of the global batch, on the device: the block
        ``[r n, (r + 1) n)``, ``n = B / W``, which JAX's ``[dp, accum, mb]``
        view gives device r (``W`` the ranks of ``data`` x ``expert``, ``r``
        this rank's index there, data-major), cut into ``parts``
        microbatches."""
        E = self.mesh.size("expert")
        W, r = self.dp * E, self.rank * E + self.mesh.rank_in("expert")

        def check(x):
            if getattr(x, "ndim", 0) and x.shape[0] % (W * parts):
                raise ValueError(
                    f"a global batch of {x.shape[0]} rows does not split "
                    f"into {W} ranks x {parts} microbatches")

        tree_map(check, batch)
        local = self._batch(rank_rows(batch, W, r))
        if parts == 1:
            return [local]

        def micro(i):
            def f(x):
                if not getattr(x, "ndim", 0):
                    return x
                mb = x.shape[0] // parts
                return x[i * mb:(i + 1) * mb]
            return tree_map(f, local)

        return [micro(i) for i in range(parts)]

    def _train_step(self, batch) -> dict:
        if self.grad_comm_mode == "qwz":
            return self._qwz_train_step(batch)
        self.link_bytes = {"up": 0, "down": 0}
        cfg = self.config
        # pipelined: the loss consumes the whole batch and microbatches it
        # inside the pipeline (ref: runtime/pipe/engine.py train_batch)
        micro = self._local_rows(
            batch, 1 if cfg.pipeline.stages > 1
            else cfg.gradient_accumulation_steps)
        accum = len(micro)
        cparams = self._compute_params()
        leaves = tree_leaves(cparams)
        live = [i for i, p in enumerate(leaves) if p.requires_grad]
        grads = [torch.zeros(p.shape, dtype=torch.float32,
                             device=self.device) for p in leaves]
        loss_sum, auxes = None, []
        # the exact path's backward is of this rank's share of the global
        # mean (its local mean / W), so each rank's partial grads have the
        # size JAX's per-device partials have (what fp16 overflow sees)
        # and the exchange sums them; the compressed paths average local
        # means, as JAX's shard_map steps do
        W = self.mesh.dp_world
        share = W if self.grad_comm_mode is None and W > 1 else None
        for mb in micro:
            with self._global_mean(share is not None):
                loss, aux = self._loss_for(cparams, mb)
            scaled = precision.scale_loss(
                loss if share is None else loss / share, self.state.scaler,
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
        del cparams, leaves, micro
        if accum > 1:
            for g in grads:
                g /= accum
        loss = loss_sum / accum if accum > 1 else loss_sum
        grads = self._reduce_grads(grads)
        loss = self._batch_mean_(loss)
        return self._finish_step(grads, loss, auxes)

    def _global_mean(self, on: bool):
        """A masked mean inside divides by the microbatch's global count
        (:func:`~deepspeed_tpu_torch.ops.losses.global_batch_mean` over the
        axes that split the rows), as the JAX engine's GSPMD step takes it;
        the compressed steps keep their local means, as JAX's shard_map
        steps do."""
        if not on or self.mesh.dp_world <= 1:
            return contextlib.nullcontext()
        return global_batch_mean(self._batch_live, self.mesh.dp_world)

    def _batch_mean_(self, loss: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks that split the batch, in place."""
        for a in self._batch_live or ["data"]:
            comm.all_reduce_(loss, a, comm.ReduceOp.AVG)
        return loss

    def _reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The rank-local grads summed (each is its share of the global
        mean) over the data axis: whole leaves at stages 0-1 (all-reduce),
        this rank's shards at stages 2-3 (reduce-scatter); qgZ's quantized
        all-reduce of the local means, then the shards at stage 2; the
        1-bit optimizers exchange their own momentum."""
        mode = self.grad_comm_mode
        if mode == "onebit":
            return grads
        if mode == "qgz":
            grads = self._reduce_fn(grads)
            if self.stage >= 2:
                grads = [zero.take_shard(g, d, self.rank, self.dp)
                         .contiguous() for g, d in zip(grads, self._dims)]
            return grads
        # the exact path: each rank's grads are its share already.  Under
        # fp16 the exchange carries fp16, as the reference's does (and the
        # JAX engine's, whose grads are in the compute dtype): a sum of
        # finite partials that overflows fp16 skips the step there too
        wire = torch.float16 if self.config.precision.is_fp16 \
            and self.mesh.dp_world > 1 else None
        if wire is not None:
            grads = [g.to(wire) for g in grads]
        # the token-splitting axes besides data: seq splits every leaf's
        # tokens, expert those of every leaf that is not an expert's
        for a in ("seq", "expert"):
            if self.mesh.size(a) > 1:
                for g, sp in zip(grads, self._specs):
                    if a not in zero.spec_axes(sp):
                        comm.all_reduce_(g, a)
        if self.stage >= 2:
            grads = zero.grad_constraint(grads, self._dims,
                                         comm.ReduceOp.SUM)
        else:
            grads = [comm.all_reduce_(g, "data") for g in grads]
        return grads if wire is None else [g.float() for g in grads]

    def _agree(self, ok: bool) -> bool:
        """``ok`` on every rank (an all-reduced minimum over every axis), so
        all ranks skip alike."""
        if self.mesh.group("data") is None:
            return ok
        t = torch.tensor([int(ok)], dtype=torch.int32, device=self.device)
        for a in self._live or ["data"]:
            comm.all_reduce_(t, a, comm.ReduceOp.MIN)
        return bool(t.item())

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global grad norm, the same on every rank: each leaf's sum of
        squares on this rank (a whole leaf counted on rank 0 only), one
        all-reduce of the vector of sums, then the square root of its sum
        (stage 0's formula on a world of one)."""
        if self.grad_comm_mode == "onebit":
            # the exact global grad never exists here: sqrt of the ranks'
            # mean squared local norm, as the JAX package
            sq = torch.square(global_norm(grads))
            return torch.sqrt(comm.all_reduce_(sq, "data",
                                               comm.ReduceOp.AVG))
        sharded = self.stage >= 2

        def counted(d, sp) -> bool:
            # a leaf's sum of squares counts once: on each rank holding a
            # distinct block of it, and on index 0 of every other axis
            split = set(zero.spec_axes(sp))
            if sharded and d is not None:
                split.add("data")
            return all(a in split or self.mesh.rank_in(a) == 0
                       for a in self._live or ["data"])

        sums = torch.stack([
            torch.sum(torch.square(g.float())) if counted(d, sp)
            else g.new_zeros((), dtype=torch.float32)
            for g, d, sp in zip(grads, self._dims or [None] * len(grads),
                                self._specs)])
        for a in self._live or ["data"]:
            comm.all_reduce_(sums, a)
        return torch.sqrt(sums.sum())

    def _finish_step(self, grads: List[torch.Tensor], loss, auxes) -> dict:
        """Unscale/overflow-check, clip, update, commit (the JAX
        ``_finish_step``).  A dry step (:meth:`comms_digest`) runs every
        exchange and commits nothing."""
        cfg = self.config
        step = self.state.step
        grads, ok, scaler = precision.unscale_and_check(
            grads, self.state.scaler, cfg.precision, agree=self._agree)
        gnorm = self._global_norm(grads)
        if ok:
            if cfg.gradient_clipping > 0 and self.grad_comm_mode != "onebit":
                factor = _clip_factor(gnorm, cfg.gradient_clipping)
                for g in grads:
                    g.mul_(factor)
            self._apply_updates(grads, commit=not self._dry)
        if not self._dry:
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

    def _norm_axes(self, d, sp) -> List[str]:
        """The axes over which leaf blocks are split on this rank: data
        (its ZeRO dim, from stage 1) and its spec's live axes."""
        axes = [a for a in zero.spec_axes(sp) if self.mesh.size(a) > 1]
        if d is not None and self.stage >= 1 and self.dp > 1:
            axes.append("data")
        return axes

    def _apply_updates(self, grads: List[torch.Tensor],
                       commit: bool = True) -> None:
        """``optimizer.update`` one leaf at a time, then ``p += u`` in
        place: on the whole leaf at stage 0, on this rank's shard from
        stage 1 (stages 1 and 2 then all-gather the new master, or cast
        it and gather it into the compute copy when the master is a host
        shard).  A host-placed leaf visits the card and goes back.  The old
        state's leaves are held only by ``cols``, so each is freed as soon
        as its replacement lands.  ``commit=False`` runs the updates and
        their gathers on copies and keeps the state as it was."""
        from deepspeed_tpu_torch.ops.optim import whole_leaf_norms

        opt = self.state.opt_state
        kind, step = type(opt), opt[0]
        skeletons = [None if f is None else tree_map(lambda _: 0, f)
                     for f in opt[1:]]
        cols = [None if f is None else tree_leaves(f) for f in opt[1:]]
        self.state = self.state._replace(opt_state=None)
        del opt
        dims = self._dims or [None] * len(grads)
        host_shard = self._cparams is not None
        new_step = step
        try:
            for i, (p, g) in enumerate(zip(tree_leaves(self.state.params),
                                           grads)):
                d = dims[i]
                split = self.stage in (1, 2) and d is not None
                sub = kind(step, *(None if c is None else self._visit(c[i])
                                   for c in cols))
                if split and not host_shard:
                    pd = zero.take_shard(p, d, self.rank, self.dp).clone(
                        memory_format=torch.contiguous_format)
                else:
                    pd = self._visit(p)
                    if pd is p and not commit:
                        pd = pd.clone()
                if split and g.shape != pd.shape:   # a whole grad (stage 1)
                    g = zero.take_shard(g, d, self.rank, self.dp) \
                        .contiguous()
                axes = self._norm_axes(d, self._specs[i]) \
                    if self._per_leaf_norm else []
                with whole_leaf_norms(axes):
                    u, new = self.optimizer.update(g, sub, pd)
                pd.add_(u.to(pd.dtype))
                del u
                if host_shard:
                    c = self._cparams[i]
                    src = pd.to(c.dtype) if pd.dtype != c.dtype else pd
                    zero.gather_shard(src, d, out=c if commit else None)
                    if commit:
                        self._leave(p, pd)
                elif split:
                    zero.gather_shard(pd, d, out=p if commit else None)
                elif commit:
                    self._leave(p, pd)
                if not commit:
                    continue
                for c, leaf in zip(cols, new[1:]):
                    if c is not None:
                        if c[i].device.type != leaf.device.type:
                            self._leave(c[i], leaf)
                        else:
                            c[i] = leaf
                new_step = new[0]
        finally:
            self.state = self.state._replace(opt_state=kind(
                new_step, *(None if c is None else tree_unflatten_like(s, c)
                            for s, c in zip(skeletons, cols))))

    def _qwz_train_step(self, batch) -> dict:
        """Manual ZeRO-3 with compressed collectives: int8 row all-gather
        (qwZ; hpZ's two hops under a hierarchy) -> local grads -> the flat
        gradient reduce-scattered to this rank's row (int8 all-to-all with
        qgZ, exact otherwise) -> the elementwise update of the row."""
        cfg = self.config
        cdt = precision.compute_dtype(cfg.precision)
        C = self._qwz_chunk
        row = self.state.params
        full = self._gather_row(row)
        params = tree_map(lambda t: t.requires_grad_(True),
                          self._qwz_unflatten(full, cdt))
        del full

        def local_grads(p, mb):
            loss, _ = self._loss_for(p, mb)
            leaves = tree_leaves(p)
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
            # a leaf the loss does not reach (BERT's pooler under the MLM
            # loss) gets a zero gradient, as JAX's grad gives it
            return ([torch.zeros_like(t) if g is None else g
                     for t, g in zip(leaves, gs)], loss.detach())

        grads, loss = comm_compress.accumulate_local_grads(
            local_grads, params, self._local_rows(batch)[0],
            cfg.gradient_accumulation_steps)
        del params
        gflat = self._qwz_flatten(grads, torch.float32)
        del grads
        if cfg.zero.zeropp_quantized_gradients:
            from deepspeed_tpu_torch.ops.quant import quantized_reduce_scatter

            gshard = quantized_reduce_scatter(
                gflat, "data", groups_per_shard=C // comm_compress._GROUP)
        else:
            gshard = comm.reduce_scatter(gflat, "data",
                                         op=comm.ReduceOp.AVG)
        del gflat
        # one consensus: a NaN lands in exactly one owner row
        ok = self._agree(precision.finite_all([gshard]))
        # the exact global norm: grads are fully reduced here
        gnorm = torch.sqrt(comm.all_reduce_(
            torch.sum(torch.square(gshard)), "data"))
        if cfg.gradient_clipping > 0:
            gshard = gshard * _clip_factor(gnorm, cfg.gradient_clipping)
        loss = comm.all_reduce_(loss, "data", comm.ReduceOp.AVG)
        step = self.state.step
        if ok:
            u, new_opt = self.optimizer.update(gshard, self.state.opt_state,
                                               row)
            if not self._dry:
                row.add_(u.to(row.dtype))
                self.state = self.state._replace(opt_state=new_opt)
        if not self._dry:
            self.state = self.state._replace(step=step + int(ok))
        return {"loss": loss, "grad_norm": gnorm, "overflow": int(not ok),
                "lr": self.lr_schedule(step + 1),
                "loss_scale": self.state.scaler.scale}

    # ----------------------------------------------------------- public API
    def _post_step(self, metrics) -> None:
        """Per-step bookkeeping shared by train_batch and step(): sync-free
        unless a monitor reads this step (steps_per_print cadence)."""
        self.global_steps += 1
        self.skipped_steps += metrics["overflow"]
        self._last_metrics = metrics
        every = max(self.config.steps_per_print, 1)
        if self.monitor.enabled and self.global_steps % every == 0:
            self.monitor.write_scalars(
                {"Train/loss": float(metrics["loss"]),
                 "Train/lr": float(metrics["lr"]),
                 "Train/grad_norm": float(metrics["grad_norm"]),
                 "Train/samples_per_sec": self.tput_timer.samples_per_sec},
                self.global_steps)
            self.monitor.flush()
        if self.registry.enabled:
            self._c_train_steps.inc()
            reads = self.monitor.enabled or self._tel_exporter is not None
            if reads and self.global_steps % every == 0:
                self._refresh_gauges(metrics)
            if self._tel_exporter is not None:
                self._tel_exporter.maybe_export(self.global_steps)

    def _refresh_gauges(self, metrics) -> None:
        self._g_loss.set(float(metrics["loss"]))
        if "lr" in metrics:
            self._g_lr.set(float(metrics["lr"]))
        if metrics.get("grad_norm") is not None:
            self._g_grad_norm.set(float(metrics["grad_norm"]))
        self._g_sps.set(self.tput_timer.samples_per_sec)
        self._g_mfu.set(self.tput_timer.mfu)
        self.registry.fan_in_comms(comm.comms_logger())

    def telemetry_snapshot(self) -> dict:
        """On-demand registry snapshot with the synced gauges refreshed
        from the last step's metrics (the one deliberate sync point for
        callers that run without a monitor)."""
        if self.registry.enabled and self._last_metrics:
            self._refresh_gauges(self._last_metrics)
        return self.registry.snapshot()

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
        """One optimizer step on a global batch (every rank passes the same
        one and takes its rows); returns the loss averaged over the ranks
        (an f32 scalar tensor on the device)."""
        batch = self._apply_curriculum(batch)
        timed = self.monitor.enabled or self._tel_sync
        if timed:
            self.tput_timer.start()
        t0 = time.perf_counter()
        metrics = self._train_step(batch)
        if timed:
            self.tput_timer.stop()
        if timed or self.registry.enabled:
            # without a timer: the host wall only, no sync added
            self._h_step.observe(time.perf_counter() - t0)
        self._post_step(metrics)
        return metrics["loss"]

    def eval_batch(self, batch):
        """The loss of the global batch (each rank evaluates its rows, the
        loss is averaged over the ranks), exact weights."""
        with torch.no_grad():
            cparams = self._compute_params()
            with self._global_mean(True):
                loss, aux = self._loss_for(cparams,
                                           self._local_rows(batch)[0])
            loss = self._batch_mean_(loss)
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

    def comms_digest(self, batch, link_gbps: float = 45.0) -> dict:
        """Per-kind count and bytes of the collectives one step on
        ``batch`` runs (ref: deepspeed/comm/comm.py comms_logger; the JAX
        engine reads them from its compiled step's HLO).  Every collective
        here is an executed call, so the digest is the comms logger's
        totals over one dry step: the forward, the backward and every
        exchange of the step, the updates run on copies and discarded,
        and no counter, scaler, schedule or data state advanced (the
        trajectory after a call equals the trajectory without it, bit for
        bit).  Writes to the monitor when one is enabled; returns the dict
        (:func:`~deepspeed_tpu_torch.comm.digest.digest_of`)."""
        from deepspeed_tpu_torch.comm.digest import dry_digest, log_digest

        def run():
            self._dry = True
            try:
                self._train_step(self._apply_curriculum(batch))
            finally:
                self._dry = False

        d = dry_digest(run, link_gbps)
        if self.monitor.enabled:
            log_digest(self.monitor, d, self.global_steps)
        return d

    @property
    def train_batch_size(self):
        return self.config.train_batch_size

    @property
    def gradient_accumulation_steps(self):
        return self.config.gradient_accumulation_steps

    def module_params(self):
        """The master params as whole leaves: below stage 3 the live
        tensors, which later steps update in place; at stage 3 gathered
        one leaf at a time, and under qwZ from the rows, and whole leaves
        gathered from every rank's model-parallel blocks when a spec
        splits them (fresh tensors, the same on every rank)."""
        if self.grad_comm_mode == "qwz":
            return self._qwz_exact_params(
                precision.master_dtype(self.config.precision))
        params = self.state.params
        if self.stage >= 3 or self._cparams is not None:
            params = tree_unflatten_like(params, [
                zero.gather_shard(self._visit(t), d)
                for t, d in zip(tree_leaves(params), self._dims)])
        if self._mp:
            params = tree_unflatten_like(params, [
                zero.gather_local(t, sp, self.mesh) for t, sp in
                zip(tree_leaves(params), self._specs)])
        return params

    def state_layout(self):
        """How this rank holds the state, for checkpoints: ``("qwz",
        chunk)`` for the flat rows, else ``("leaves", param_dims,
        opt_dims, specs)``: the dim each param / optimizer leaf is split
        along over the data axis (None: whole), and each leaf's
        model-parallel spec."""
        if self.grad_comm_mode == "qwz":
            return ("qwz", self._qwz_chunk)
        dims = self._dims or [None] * len(self._shapes)
        sharded = self.stage >= 3 or self._cparams is not None
        pdims = dims if sharded else [None] * len(dims)
        odims = dims if self.stage >= 1 else [None] * len(dims)
        return ("leaves", pdims, odims, self._specs)

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

        out = _load(self, load_dir, tag=tag)
        if self._cparams is not None:
            # the compute copy from the loaded host shards
            for p, c, d in zip(tree_leaves(self.state.params), self._cparams,
                               self._dims):
                pd = self._visit(p)
                zero.gather_shard(pd.to(c.dtype), d, out=c)
        return out


def _is_float(leaf) -> bool:
    dt = getattr(leaf, "dtype", None)
    if isinstance(dt, torch.dtype):
        return dt.is_floating_point
    return np.issubdtype(np.asarray(leaf).dtype, np.floating)


def initialize(args=None, *, loss_fn: Optional[Callable] = None,
               params: Any = None, config: Any = None,
               optimizer: Optional[Optimizer] = None, lr_scheduler=None,
               training_data=None, has_aux: bool = False,
               dist_init_required: Optional[bool] = None,
               param_specs: Any = None, device=None,
               mesh: Optional[topology.MeshSpec] = None):
    """ref: deepspeed.initialize -> (engine, optimizer, dataloader,
    lr_schedule).  ``config`` may be a dict, a JSON path or a Config;
    ``device`` None means CUDA.  Unless ``dist_init_required`` is False,
    the process first joins the launcher's process group
    (:func:`~deepspeed_tpu_torch.comm.init_distributed`: nccl, or gloo when
    ``device`` is the CPU; nothing to join for a lone process).

    Routing, as the JAX package routes: a
    :class:`~deepspeed_tpu_torch.param_stream.LayeredModel`, or an
    ``offload_param`` block on ``nvme`` (or ``cpu`` with ``scheduled``),
    goes to the layer-streaming :class:`~deepspeed_tpu_torch.param_stream.
    ParamStreamEngine`; an ``offload_optimizer`` block on ``nvme`` (or
    ``cpu`` with ``scheduled``) to the optimizer-state-streaming
    :class:`~deepspeed_tpu_torch.infinity.InfinityEngine`; everything else
    to :class:`TrainingEngine` (ZeRO stages 0-3 over the mesh; its
    unscheduled ``cpu`` offload blocks keep the state, or this rank's
    shards of it, in page-locked host memory).  ``param_specs``: the
    model-parallel placements of every engine (each cuts its leaves to
    this rank's blocks)."""
    if dist_init_required is None or dist_init_required:
        cpu = device is not None and torch.device(device).type == "cpu"
        comm.init_distributed(dist_backend="gloo" if cpu else "nccl")
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    if isinstance(config, str):
        config = Config.from_file(config)
    elif isinstance(config, dict):
        config = Config.from_dict(config)
    elif config is None:
        config = Config()

    from deepspeed_tpu_torch.param_stream import (LayeredModel,
                                                  ParamStreamEngine)

    poff = config.zero.offload_param or {}
    poff_dev = poff.get("device", "none")
    if isinstance(params, LayeredModel) or (
            poff_dev == "nvme" or (poff_dev == "cpu"
                                   and poff.get("scheduled"))):
        if not isinstance(params, LayeredModel):
            raise ValueError(
                "scheduled parameter offload streams per-layer programs "
                "and needs the model factored for it: pass params="
                "<model>.layered_model(cfg, params) (llama provides one); "
                "plain pytrees only support the memory-kind offload path")
        if optimizer is not None or has_aux:
            raise ValueError(
                "the param-stream engine drives its own CPU-Adam; "
                "configure the optimizer via the config block and drop "
                "has_aux (LayeredModel.block_has_aux covers it)")
        engine = ParamStreamEngine(params, config, lr_scheduler=lr_scheduler,
                                   param_specs=param_specs, device=device,
                                   mesh=mesh)
        return _finish_initialize(engine, config, training_data)

    if loss_fn is None or params is None:
        raise ValueError("initialize() needs loss_fn and params (a "
                         "LayeredModel params carries its own loss)")
    off = config.zero.offload_optimizer or {}
    off_dev = off.get("device", "none")
    if off_dev == "nvme" or (off_dev == "cpu" and off.get("scheduled")):
        from deepspeed_tpu_torch.infinity import InfinityEngine

        if optimizer is not None or has_aux:
            raise ValueError(
                "the ZeRO-Infinity scheduled-offload engine drives its own "
                "Adam update; pass the optimizer via the config block and "
                "drop has_aux (param_specs ARE supported: TP shardings on "
                "the compute params compose with the [dp, chunk] state)")
        if config.curriculum is not None and config.curriculum.enabled:
            raise ValueError(
                "curriculum_learning does not compose with the scheduled "
                "ZeRO-Infinity engine yet — drop one of the two (the "
                "TrainingEngine honors curriculum; Infinity ignores it, "
                "which would be a silent no-op)")
        if callable(params) and not isinstance(params, (dict, list, tuple)):
            # a zero.Init thunk: the engine keeps the compute params on
            # the card regardless, so materialize it now
            params = params()
        engine = InfinityEngine(loss_fn, params, config,
                                lr_scheduler=lr_scheduler,
                                param_specs=param_specs, device=device,
                                mesh=mesh)
    else:
        engine = TrainingEngine(loss_fn, params, config, optimizer=optimizer,
                                lr_scheduler=lr_scheduler, has_aux=has_aux,
                                device=device, mesh=mesh,
                                param_specs=param_specs)
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
