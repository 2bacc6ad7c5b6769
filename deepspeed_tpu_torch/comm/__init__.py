"""Communication over ``torch.distributed`` (port of
``deepspeed_tpu/comm/__init__.py``; ref: deepspeed/comm/comm.py + the
NCCL backend in deepspeed/comm/torch.py).

Process bring-up (:func:`init_distributed`) and the reference's collective
API.  As in the JAX package, each collective is keyed by a mesh axis name,
resolved through :func:`~deepspeed_tpu_torch.topology.current_mesh` to that
axis's process group (``group=`` overrides it with a sub-group, the
counterpart of JAX's ``axis_index_groups``).  Collectives are functional:
they return a new tensor and leave their input as it was, except the
``_``-suffixed in-place forms the engine uses on its own buffers.  Every
call is recorded in the process's :class:`~deepspeed_tpu_torch.utils.
trace.CommsLogger` (one record a call that ran, with this rank's payload
bytes).

``ReduceOp.AVG`` is a sum divided by the world size on every backend (gloo
has no average; JAX's ``pmean`` is the same sum and division), and
``PRODUCT`` takes JAX's sign-and-zero route through logs.  A rank of a
world of one with no process group runs each collective as the identity.
"""

from __future__ import annotations

import datetime
import enum
import os
import warnings
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.topology import current_mesh
from deepspeed_tpu_torch.utils.trace import CommsLogger

# torch >= 2.10 renames the tensor-in, tensor-out collectives; the old
# names the port calls stay on every version it supports
warnings.filterwarnings(
    "ignore", message=r"`torch\.distributed\.\w+` is deprecated",
    category=FutureWarning)

_initialized = False
_comms_logger = CommsLogger(enabled=True)
# one process group's first wait: long enough for a peer's kernel build
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def comms_logger() -> CommsLogger:
    """The process-wide collective log."""
    return _comms_logger


def configure_comms_logger(enabled: bool) -> None:
    """Toggle collective recording (ref: comms_logger config knob)."""
    _comms_logger.enabled = bool(enabled)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class ReduceOp(enum.Enum):  # ref: deepspeed/comm/comm.py ReduceOp
    SUM = "sum"
    AVG = "avg"
    MAX = "max"
    MIN = "min"
    PRODUCT = "prod"


# --------------------------------------------------------------------------
# bring-up (ref: init_distributed / deepspeed/comm/comm.py)
# --------------------------------------------------------------------------
def _address(coordinator_address: Optional[str]) -> Optional[str]:
    env = os.environ
    if coordinator_address:
        return coordinator_address
    if env.get("COORDINATOR_ADDRESS"):
        return env["COORDINATOR_ADDRESS"]
    if env.get("MASTER_ADDR"):
        return f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    return None


def init_distributed(dist_backend: str = "nccl",
                     coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT,
                     **_compat) -> None:
    """Join the process group the launcher set up.

    The address, world size and rank come from the arguments, else from
    the JAX package's env names (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``,
    ``PROCESS_ID``), else from the reference's (``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  A process with no address
    and a world of one joins nothing (one rank, no launcher), as the JAX
    package's single host does.  Under ``nccl`` this rank takes
    ``cuda:LOCAL_RANK``; ``nccl`` without a GPU raises (pass
    ``dist_backend="gloo"`` for ranks on the CPU)."""
    global _initialized
    if _initialized or dist.is_initialized():
        _initialized = True
        return
    env = os.environ
    addr = _address(coordinator_address)
    world = int(num_processes if num_processes is not None else env.get(
        "NUM_PROCESSES", env.get("WORLD_SIZE", "1")))
    rank = int(process_id if process_id is not None else env.get(
        "PROCESS_ID", env.get("RANK", "0")))
    if addr is None:
        if world > 1:
            raise ValueError(
                f"world size {world} but no address to meet at: set "
                "MASTER_ADDR / MASTER_PORT (the launcher does) or pass "
                "coordinator_address")
        _initialized = True
        return
    if dist_backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dist_backend='nccl' needs a CUDA GPU; pass "
                "dist_backend='gloo' to run the ranks on the CPU")
        torch.cuda.set_device(get_local_rank())
    dist.init_process_group(dist_backend, init_method=f"tcp://{addr}",
                            rank=rank, world_size=world, timeout=timeout)
    _initialized = True


def is_initialized() -> bool:
    return _initialized or dist.is_initialized()


def get_rank() -> int:
    """This process's global rank (one rank a GPU, as the reference)."""
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def get_device_count() -> int:
    """Devices across all ranks: one a rank (the JAX package counts chips
    here, since one of its processes drives several)."""
    return get_world_size()


def get_local_rank() -> int:
    """This rank's index on its node (``LOCAL_RANK``; the GPU it takes)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def barrier() -> None:
    """Every rank waits for the others (ref: comm.barrier)."""
    if get_world_size() > 1:
        with _comms_logger.record("barrier", 0):
            dist.barrier()


# --------------------------------------------------------------------------
# collectives keyed by a mesh axis
# --------------------------------------------------------------------------
def _resolve(axis_name: str, group=None) -> Tuple[object, int]:
    """(process group, its size) of ``axis_name`` on the current mesh, or
    of ``group`` when given.  The group is None for a world of one without
    a process group."""
    if group is not None:
        return group, dist.get_world_size(group)
    ms = current_mesh()
    if ms is None:
        raise RuntimeError(
            f"no current mesh to resolve axis {axis_name!r}: build one "
            "(topology.default_mesh() / MeshSpec.build) and "
            "set_current_mesh() it, or let initialize() do it")
    return ms.group(axis_name), ms.size(axis_name)


def _avg_(x: torch.Tensor, n: int) -> torch.Tensor:
    if n == 1:
        return x                  # x / 1 is x: no pass over the buffer
    # a tensor divisor: CUDA's division by a Python scalar multiplies by
    # its reciprocal, an ulp off the quotient JAX's pmean takes
    d = torch.full((), n, dtype=x.dtype, device=x.device)
    return x.div_(d) if x.is_floating_point() else x.floor_divide_(d)


def _host_staged(g, x: torch.Tensor) -> bool:
    """True for a CUDA tensor in a gloo group: gloo carries only
    all_reduce and broadcast for CUDA tensors, so every other collective
    stages its buffers through host memory (several ranks sharing one
    GPU, where NCCL refuses the group).  Under NCCL, or for CPU tensors,
    nothing is staged."""
    return g is not None and x.is_cuda and dist.get_backend(g) == "gloo"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """A page-locked host copy of a CUDA tensor (the caching host
    allocator reuses the buffers), for a staged collective."""
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return h.copy_(x)


def _device_staged(g, x: torch.Tensor) -> bool:
    """True for a host tensor in an NCCL group: NCCL carries only CUDA
    tensors, so host state (the offload engines') goes through the card."""
    return g is not None and not x.is_cuda and dist.get_backend(g) == "nccl"


def _wire(g, x: torch.Tensor) -> torch.Tensor:
    """The tensor a collective of ``x`` hands the backend: a page-locked
    host copy, a copy on the card, or ``x`` itself."""
    if _host_staged(g, x):
        return _to_host(x)
    if _device_staged(g, x):
        return x.to(torch.device("cuda", torch.cuda.current_device()))
    return x


def _op_name(op: str, g, x: torch.Tensor) -> str:
    """The log's name of a call: ``op``, or ``op:host`` when staged."""
    return f"{op}:host" if _host_staged(g, x) else op


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


# --------------------------------------------------------------------------
# the raw exchanges (no autograd; host staging for gloo + CUDA)
# --------------------------------------------------------------------------
def _all_reduce_raw(x: torch.Tensor, g, dop) -> None:
    """In place; gloo reduces CUDA tensors itself (through host memory)."""
    if g is None:
        return
    if _device_staged(g, x):
        y = _wire(g, x)
        dist.all_reduce(y, op=dop, group=g)
        x.copy_(y)
    else:
        dist.all_reduce(x, op=dop, group=g)


def _gather_dim0(x: torch.Tensor, g, n: int) -> torch.Tensor:
    """[n * x.shape[0], ...]: every rank's x along dim 0, in rank order."""
    x = x.contiguous()
    if g is None:
        return x.clone()
    src = _wire(g, x)
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=g)
    return out.to(x.device) if out.device != x.device else out


def _reduce_scatter_dim0(x: torch.Tensor, g, n: int) -> torch.Tensor:
    """This rank's 1/n slice of dim 0 of the sum of every rank's x."""
    x = x.contiguous()
    if g is None:
        return x.clone()
    src = _wire(g, x)
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=g)
    return out.to(x.device) if out.device != x.device else out


def _all_to_all_dim0(x: torch.Tensor, g) -> torch.Tensor:
    """Chunk j of dim 0 to rank j; received chunks in rank order."""
    x = x.contiguous()
    if g is None:
        return x.clone()
    src = _wire(g, x)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=g)
    return out.to(x.device) if out.device != x.device else out


def _ppermute_raw(x: torch.Tensor, g, perm) -> torch.Tensor:
    x = x.contiguous()
    me = 0 if g is None else dist.get_group_rank(g, dist.get_rank())
    src = _wire(g, x)
    staged = src is not x
    out = torch.zeros_like(src)
    ops = []
    for s, d in perm:
        if s == me and d == me:
            out.copy_(src)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, src,
                                  dist.get_global_rank(g, d), g))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(g, s), g))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out.to(x.device) if staged else out


def _all_gather_fwd(x, axis_name, group, axis):
    g, n = _resolve(axis_name, group)
    with _comms_logger.record(_op_name("all_gather", g, x), _nbytes(x)):
        out = _gather_dim0(x.movedim(axis, 0), g, n).movedim(0, axis)
    # rows of the result are what its readers (kernels among them) expect
    # contiguous
    return out.contiguous()


def _reduce_scatter_fwd(x, axis_name, group, axis):
    g, n = _resolve(axis_name, group)
    with _comms_logger.record(_op_name("reduce_scatter", g, x),
                              _nbytes(x)):
        out = _reduce_scatter_dim0(x.movedim(axis, 0), g, n)
    return out.movedim(0, axis).contiguous()


def _psum_fwd(x, axis_name, group):
    g, _ = _resolve(axis_name, group)
    y = x.clone()
    with _comms_logger.record("all_reduce", _nbytes(x)):
        _all_reduce_raw(y, g, dist.ReduceOp.SUM)
    return y


def _all_to_all_fwd(x, axis_name, group, split_axis, concat_axis):
    g, n = _resolve(axis_name, group)
    xm = x.movedim(split_axis, 0)
    with _comms_logger.record(_op_name("all_to_all", g, x), _nbytes(x)):
        out = _all_to_all_dim0(xm, g)
    blocks = out.reshape((n, xm.shape[0] // n) + tuple(xm.shape[1:]))
    return torch.cat([b.movedim(0, split_axis) for b in blocks],
                     dim=concat_axis)


def _ppermute_fwd(x, axis_name, group, perm):
    g, _ = _resolve(axis_name, group)
    with _comms_logger.record(_op_name("ppermute", g, x), _nbytes(x)):
        return _ppermute_raw(x, g, perm)


# --------------------------------------------------------------------------
# collectives autograd goes through.  JAX takes each collective's backward
# from its transpose rule: psum's is psum, all_gather's reduce_scatter,
# all_to_all's the inverse all_to_all, ppermute's the inverse permutation.
# Cotangents are partial a rank (each rank back-propagates its own share of
# the loss), as under JAX's shard_map.
# --------------------------------------------------------------------------
class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, group):
        ctx.a = (axis_name, group)
        return _psum_fwd(x, *ctx.a)

    @staticmethod
    def backward(ctx, g):
        return _psum_fwd(g, *ctx.a), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, group, axis):
        ctx.a = (axis_name, group, axis)
        return _all_gather_fwd(x, axis_name, group, axis)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_fwd(g, *ctx.a), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, group, axis):
        ctx.a = (axis_name, group, axis)
        return _reduce_scatter_fwd(x, axis_name, group, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_fwd(g, *ctx.a), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, group, split_axis, concat_axis):
        ctx.a = (axis_name, group, split_axis, concat_axis)
        return _all_to_all_fwd(x, axis_name, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        axis_name, group, split_axis, concat_axis = ctx.a
        return (_all_to_all_fwd(g, axis_name, group, concat_axis,
                                split_axis), None, None, None, None)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, group, perm):
        ctx.a = (axis_name, group, perm)
        return _ppermute_fwd(x, axis_name, group, perm)

    @staticmethod
    def backward(ctx, g):
        axis_name, group, perm = ctx.a
        inverse = [(d, s) for s, d in perm]
        return _ppermute_fwd(g, axis_name, group, inverse), None, None, None


def all_reduce_(x: torch.Tensor, axis_name: str = "data",
                op: ReduceOp = ReduceOp.SUM, group=None) -> torch.Tensor:
    """In-place :func:`all_reduce` of SUM / AVG / MAX / MIN; returns x."""
    g, n = _resolve(axis_name, group)
    with _comms_logger.record("all_reduce", _nbytes(x)):
        if g is not None:
            dop = {ReduceOp.SUM: dist.ReduceOp.SUM,
                   ReduceOp.AVG: dist.ReduceOp.SUM,
                   ReduceOp.MAX: dist.ReduceOp.MAX,
                   ReduceOp.MIN: dist.ReduceOp.MIN}.get(op)
            if dop is None:
                raise ValueError(f"unsupported in-place op {op}")
            _all_reduce_raw(x, g, dop)
    if op is ReduceOp.AVG:
        _avg_(x, n)
    return x


def all_reduce(x: torch.Tensor, axis_name: str = "data",
               op: ReduceOp = ReduceOp.SUM, group=None) -> torch.Tensor:
    """ref: comm.all_reduce -> the reduction over the axis, on every rank.
    SUM and AVG of a tensor that requires grad back-propagate as JAX's
    ``psum`` / ``pmean`` do (the cotangents reduced the same way)."""
    if op is ReduceOp.PRODUCT:
        # log-space magnitude; sign parity and zeros counted apart so
        # non-positive inputs give no NaN (JAX's route)
        xf = x.float()
        ones = torch.ones_like(xf)
        mag = torch.exp(all_reduce_(
            torch.log(torch.where(xf == 0, ones, xf.abs())), axis_name,
            ReduceOp.SUM, group))
        neg = all_reduce_((xf < 0).to(torch.int32), axis_name,
                          ReduceOp.SUM, group)
        has_zero = all_reduce_((xf == 0).to(torch.int32), axis_name,
                               ReduceOp.SUM, group) > 0
        sign = torch.where(neg % 2 == 0, ones, -ones)
        return torch.where(has_zero, torch.zeros_like(xf), sign * mag)
    if op in (ReduceOp.SUM, ReduceOp.AVG) and _differentiable(x):
        y = _PSum.apply(x, axis_name, group)
        n = _resolve(axis_name, group)[1]
        return y if op is ReduceOp.SUM or n == 1 else y / torch.full(
            (), n, dtype=y.dtype, device=y.device)
    return all_reduce_(x.clone(), axis_name, op, group)


def all_gather(x: torch.Tensor, axis_name: str = "data", axis: int = 0,
               tiled: bool = True, group=None) -> torch.Tensor:
    """ref: comm.all_gather -> every rank's x concatenated along ``axis``
    (``tiled``), or stacked on a new dim at ``axis``.  Its backward is the
    reduce-scatter of the cotangent (JAX's transpose)."""
    if not tiled:
        return all_gather(x.unsqueeze(axis), axis_name, axis, True, group)
    if _differentiable(x):
        return _AllGather.apply(x, axis_name, group, axis)
    return _all_gather_fwd(x, axis_name, group, axis)


def reduce_scatter(x: torch.Tensor, axis_name: str = "data", axis: int = 0,
                   op: ReduceOp = ReduceOp.SUM, group=None) -> torch.Tensor:
    """ref: comm.reduce_scatter_base -> the sum (or mean) over the axis,
    keeping this rank's 1/n slice of ``axis``; its backward all-gathers
    the cotangent."""
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError("reduce_scatter supports SUM/AVG")
    if _differentiable(x):
        out = _ReduceScatter.apply(x, axis_name, group, axis)
        n = _resolve(axis_name, group)[1]
        return out if op is ReduceOp.SUM or n == 1 else out / torch.full(
            (), n, dtype=out.dtype, device=out.device)
    out = _reduce_scatter_fwd(x, axis_name, group, axis)
    if op is ReduceOp.AVG:
        _avg_(out, _resolve(axis_name, group)[1])
    return out


def broadcast(x: torch.Tensor, axis_name: str = "data", src: int = 0,
              group=None) -> torch.Tensor:
    """ref: comm.broadcast -> axis index ``src``'s value on every rank."""
    g, _ = _resolve(axis_name, group)
    y = x.clone()
    with _comms_logger.record("broadcast", _nbytes(x)):
        if g is not None:
            w = _wire(g, y) if _device_staged(g, y) else y
            dist.broadcast(w, src=dist.get_global_rank(g, src), group=g)
            if w is not y:
                y.copy_(w)
    return y


def all_to_all(x: torch.Tensor, axis_name: str = "data", split_axis: int = 0,
               concat_axis: int = 0, group=None) -> torch.Tensor:
    """ref: comm.all_to_all_single: split ``split_axis`` into n chunks,
    chunk j to rank j, the chunks received concatenated along
    ``concat_axis`` in rank order (JAX's tiled ``all_to_all``).  Its
    backward is the inverse all-to-all."""
    if _differentiable(x):
        return _AllToAll.apply(x, axis_name, group, split_axis, concat_axis)
    return _all_to_all_fwd(x, axis_name, group, split_axis, concat_axis)


def ppermute(x: torch.Tensor, axis_name: str, perm: Sequence,
             group=None) -> torch.Tensor:
    """Point-to-point exchange over the axis: for each ``(src, dst)`` pair
    of axis indices, dst receives src's x; a rank no pair sends to gets
    zeros (JAX's ``ppermute``).  Its backward sends each cotangent back
    along the inverse permutation."""
    perm = [tuple(p) for p in perm]
    if _differentiable(x):
        return _PPermute.apply(x, axis_name, group, perm)
    return _ppermute_fwd(x, axis_name, group, perm)


# --------------------------------------------------------------------------
# Megatron's four mappings over an axis whose ranks all compute the same
# loss (ref: megatron/mpu/mappings.py, wired in through DeepSpeed's mpu):
# the cotangent of a value replicated over the axis is whole on every rank
# --------------------------------------------------------------------------
def _own_slice(x: torch.Tensor, axis_name: str, dim: int) -> torch.Tensor:
    _, n = _resolve(axis_name)
    c = x.shape[dim] // n
    return x.narrow(dim, rank_in(axis_name) * c, c).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis = axis_name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum_fwd(g, ctx.axis, None), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        return _psum_fwd(x, axis_name, None)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, dim):
        ctx.a = (axis_name, dim)
        return _all_gather_fwd(x, axis_name, None, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, *ctx.a), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, dim):
        ctx.a = (axis_name, dim)
        return _own_slice(x, axis_name, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_fwd(g, ctx.a[0], None, ctx.a[1]), None, None


def _axis_live(axis_name: str) -> bool:
    ms = current_mesh()
    return ms is not None and ms.size(axis_name) > 1


def copy_to(x: torch.Tensor, axis_name: str = "model") -> torch.Tensor:
    """Identity forward; the backward all-reduces the cotangent (the input
    of a column-parallel product: each rank's grad covers its columns)."""
    return _CopyTo.apply(x, axis_name) if _axis_live(axis_name) else x


def reduce_from(x: torch.Tensor, axis_name: str = "model") -> torch.Tensor:
    """All-reduce forward (a row-parallel product's partial sums);
    identity backward."""
    return _ReduceFrom.apply(x, axis_name) if _axis_live(axis_name) else x


def gather_from(x: torch.Tensor, axis_name: str = "model",
                dim: int = -1) -> torch.Tensor:
    """All-gather ``dim`` forward; the backward keeps this rank's slice."""
    if not _axis_live(axis_name):
        return x
    return _GatherFrom.apply(x, axis_name, dim % x.dim())


def scatter_to(x: torch.Tensor, axis_name: str = "model",
               dim: int = -1) -> torch.Tensor:
    """This rank's slice of ``dim`` forward; the backward all-gathers."""
    if not _axis_live(axis_name):
        return x
    return _ScatterTo.apply(x, axis_name, dim % x.dim())


def send_recv_next(x: torch.Tensor, axis_name: str, size: int,
                   group=None) -> torch.Tensor:
    """Shift +1 around the ring (pipeline stage handoff)."""
    return ppermute(x, axis_name, [(i, (i + 1) % size) for i in range(size)],
                    group)


def rank_in(axis_name: str) -> int:
    """This rank's index along a mesh axis."""
    ms = current_mesh()
    return 0 if ms is None else ms.rank_in(axis_name)


def mesh_all_reduce(x: torch.Tensor, mesh=None,
                    op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
    """Reduce every rank's x over all axes of ``mesh`` (default: the
    current mesh): one wall-timed record with x's bytes, beside the
    records of the per-axis reductions inside it."""
    from deepspeed_tpu_torch.topology import AXES

    ms = mesh if mesh is not None else current_mesh()
    if ms is None:
        return x.clone()
    with _comms_logger.record("mesh_all_reduce", _nbytes(x)):
        x = x.clone()
        for a in AXES:
            if ms.size(a) > 1:
                x = all_reduce(x, a, op, ms.group(a))
        return x
