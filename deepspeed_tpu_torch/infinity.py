"""Host and NVMe tiers for streamed state (the port's part of
``deepspeed_tpu/infinity.py``; ref: deepspeed/runtime/swap_tensor/ —
ZeRO-Infinity's partitioned swappers).

A tier holds named host buffers between uses: :class:`_RamTier` in host
memory, :class:`_NvmeTier` in one flat file per name under a directory,
read and written through the port's aio pool (:mod:`~deepspeed_tpu_torch.
io.aio`) on ALTERNATING read and write slots: a pool's ``wait`` fences
everything it has, so two pools per direction give per-slot fencing and
keep one item of IO in flight in each direction.  The ZeRO-Inference
serving engine streams layer weights through either tier
(:class:`~deepspeed_tpu_torch.param_stream.TierLayerReader`).

Buffers are numpy arrays or CPU tensors of any dtype (bfloat16 too: the
files hold raw bytes).  :class:`PinnedBuffer` page-locks host memory once,
so host -> device copies out of it run asynchronously on a side stream.

:class:`InfinityEngine` is the ZeRO-Infinity training engine that streams
optimizer state through a tier around the step; the layer-streaming engine
that offloads the params too is :class:`~deepspeed_tpu_torch.param_stream.
ParamStreamEngine`.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.io.aio import as_bytes

logger = logging.getLogger(__name__)


def _empty(shape, dtype):
    """A host buffer of ``shape`` and ``dtype`` (a torch dtype gives a CPU
    tensor, anything else a numpy array)."""
    if isinstance(dtype, torch.dtype):
        return torch.empty(tuple(shape), dtype=dtype)
    return np.empty(tuple(shape), np.dtype(dtype))


class PinnedBuffer:
    """``nbytes`` of host memory, page-locked with ``cudaHostRegister``
    when CUDA is available (one registration for the whole buffer, at its
    exact size: ``pin_memory`` would round a 2.9 GB layer up to 4 GiB), so
    a ``copy_(non_blocking=True)`` out of it is truly asynchronous.  The
    memory is an anonymous ``mmap`` (page-aligned and untouched), which
    registers faster than an allocator's block.  The registration is
    undone when the buffer is collected, before its memory is freed.
    Without CUDA the buffer is plain host memory."""

    def __init__(self, nbytes: int):
        import mmap

        self._map = mmap.mmap(-1, max(int(nbytes), 1))
        self.tensor = torch.frombuffer(self._map, dtype=torch.uint8)
        self._registered = False
        if torch.cuda.is_available():
            rt = torch.cuda.cudart()
            torch.cuda.check_error(rt.cudaHostRegister(
                self.tensor.data_ptr(), self.tensor.numel(), 0))
            self._registered = True

    def view(self, offset: int, shape, dtype: torch.dtype) -> torch.Tensor:
        """A tensor of ``shape`` and ``dtype`` over the bytes at
        ``offset``."""
        n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        return self.tensor[offset:offset + n].view(dtype).view(tuple(shape))

    def __del__(self):
        if getattr(self, "_registered", False):
            torch.cuda.cudart().cudaHostUnregister(self.tensor.data_ptr())
            self._registered = False


# host views into one page-locked buffer start at this byte alignment
_ALIGN = 256


def pinned_views(shapes, dtypes, keep: list) -> List[torch.Tensor]:
    """Views of ONE :class:`PinnedBuffer` (a single registration) holding
    tensors of ``shapes`` and ``dtypes`` back to back; the buffer is
    appended to ``keep``, whose owner must hold it as long as the views."""
    offs, off = [], 0
    for s, d in zip(shapes, dtypes):
        offs.append(off)
        n = int(np.prod(s, dtype=np.int64)) * torch.empty(
            (), dtype=d).element_size()
        off += -(-n // _ALIGN) * _ALIGN
    buf = PinnedBuffer(off)
    keep.append(buf)
    return [buf.view(o, s, d) for o, s, d in zip(offs, shapes, dtypes)]


class _Tier:
    """Where streamed host buffers live between uses."""

    def put(self, name: str, arr) -> None:
        raise NotImplementedError

    def get_submit(self, name: str, shape, dtype, out=None):
        """Begin fetching; returns the buffer (valid after
        :meth:`fence_reads`).  ``out``: an optional preallocated
        destination, honoured by the NVMe tier (reads land in place); the
        RAM tier returns its stored buffer regardless."""
        raise NotImplementedError

    def reads_pending(self) -> int:
        return 0

    def fence_reads(self) -> None:
        pass

    def fence_writes(self) -> None:
        pass

    def fence_all(self) -> None:
        pass

    def next_read_slot(self) -> None:
        pass


class _RamTier(_Tier):
    """Buffers kept in host memory as they are put (the ZeRO-Inference
    engine puts views of one pinned buffer per layer)."""

    def __init__(self):
        self.store: Dict[str, object] = {}

    def put(self, name, arr):
        self.store[name] = arr

    def get_submit(self, name, shape, dtype, out=None):
        return self.store[name]

    def read_sync(self, name, shape, dtype):
        """Synchronous read (the degradation rung below aio: trivially the
        stored buffer here)."""
        return self.store[name]


class _NvmeTier(_Tier):
    """A flat file per name; alternating aio pools for per-slot fencing."""

    def __init__(self, path: str, n_threads: int = 4):
        from deepspeed_tpu_torch.io.aio import AioHandle

        os.makedirs(path, exist_ok=True)
        self.dir = path
        self.rpools = [AioHandle(n_threads), AioHandle(n_threads)]
        self.wpools = [AioHandle(n_threads), AioHandle(n_threads)]
        self.rslot = 0
        self.wslot = 0
        self._wbufs: List[list] = [[], []]
        self._fds: Dict[Tuple[str, bool], int] = {}
        # bytes submitted each way (plain counts: the tier's traffic)
        self.bytes_read = 0
        self.bytes_written = 0

    def _path(self, name: str) -> str:
        return os.path.join(self.dir, name + ".bin")

    def _fd(self, pool, name: str, write: bool) -> int:
        key = (name, write)
        if key not in self._fds:
            self._fds[key] = pool.open(self._path(name), write=write)
        return self._fds[key]

    def next_read_slot(self):
        self.rslot ^= 1

    def next_write_slot(self):
        self.wslot ^= 1

    def put(self, name, arr):
        pool = self.wpools[self.wslot]
        self._wbufs[self.wslot].append(arr)  # keep alive until the fence
        pool.pwrite(self._fd(pool, name, True), arr, 0)
        self.bytes_written += as_bytes(arr).nbytes

    def get_submit(self, name, shape, dtype, out=None):
        pool = self.rpools[self.rslot]
        buf = _empty(shape, dtype) if out is None else out
        pool.pread(self._fd(pool, name, False), buf, 0)
        self.bytes_read += as_bytes(buf).nbytes
        return buf

    def reads_pending(self) -> int:
        """In-flight reads on the CURRENT slot (non-blocking): 0 means the
        next :meth:`fence_reads` is free, the prefetch hid behind
        compute."""
        return self.rpools[self.rslot].pending()

    def read_sync(self, name, shape, dtype):
        """Synchronous read through the plain OS path, bypassing the aio
        pools: the rung a reader drops to when a fence exhausted its
        retries."""
        buf = _empty(shape, dtype)
        view = as_bytes(buf)
        with open(self._path(name), "rb") as f:
            if f.readinto(memoryview(view)) != view.nbytes:
                raise IOError(f"short read of {self._path(name)}")
        return buf

    def fence_reads(self):
        errs = self.rpools[self.rslot].wait()
        if errs:
            raise IOError(f"{errs} NVMe reads failed")

    def fence_writes(self):
        errs = self.wpools[self.wslot].wait()
        self._wbufs[self.wslot] = []
        if errs:
            raise IOError(f"{errs} NVMe writes failed")

    def fence_all(self):
        for s in (0, 1):
            self.rpools[s].wait()
            errs = self.wpools[s].wait()
            self._wbufs[s] = []
            if errs:
                raise IOError(f"{errs} NVMe writes failed")


_LANE = 128  # chunk alignment of the [dp, chunk] layout (checkpoint keys)


class _Staging:
    """A ring of page-locked host chunks for copies between pageable host
    tensors and the card (JAX's double-buffered sub-group staging): each
    chunk is a host memcpy into a ring slot and an asynchronous copy out
    of it on a side stream, so the memcpy of one chunk overlaps the DMA of
    the one before.  On the CPU a copy is a plain ``copy_``."""

    def __init__(self, device: torch.device, chunk_bytes: int = 64 << 20,
                 slots: int = 4):
        self.cuda = device.type == "cuda"
        self.chunk = int(chunk_bytes)
        self._keep: List[PinnedBuffer] = []
        self._next = 0
        if self.cuda:
            self.bufs = pinned_views([(self.chunk,)] * slots,
                                     [torch.uint8] * slots, self._keep)
            self.events = [torch.cuda.Event() for _ in range(slots)]
            self.stream = torch.cuda.Stream(device=device)

    @staticmethod
    def _bytes(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(-1).view(torch.uint8)

    def h2d(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """``dst`` (on the card) <- ``src`` (host), same dtype and size;
        the compute stream waits for the copies."""
        if not self.cuda:
            dst.copy_(src.reshape(dst.shape))
            return
        db, sb = self._bytes(dst), self._bytes(src)
        cur = torch.cuda.current_stream()
        self.stream.wait_stream(cur)
        for off in range(0, sb.numel(), self.chunk):
            slot = self._next % len(self.bufs)
            self._next += 1
            c = min(self.chunk, sb.numel() - off)
            self.events[slot].synchronize()   # the slot's last DMA is done
            self.bufs[slot][:c].copy_(sb[off:off + c])
            with torch.cuda.stream(self.stream):
                db[off:off + c].copy_(self.bufs[slot][:c], non_blocking=True)
                self.events[slot].record(self.stream)
        cur.wait_stream(self.stream)

    def d2h(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """``dst`` (host) <- ``src`` (on the card); returns once ``dst``
        holds the data."""
        if not self.cuda:
            dst.copy_(src.reshape(dst.shape))
            return
        db, sb = self._bytes(dst), self._bytes(src)
        n, ns = sb.numel(), len(self.bufs)
        offs = list(range(0, n, self.chunk))
        self.stream.wait_stream(torch.cuda.current_stream())

        def issue(j):
            slot, off = j % ns, offs[j]
            with torch.cuda.stream(self.stream):
                self.bufs[slot][:min(self.chunk, n - off)].copy_(
                    sb[off:off + self.chunk], non_blocking=True)
                self.events[slot].record(self.stream)

        for j in range(min(ns, len(offs))):
            issue(j)
        for j, off in enumerate(offs):
            slot = j % ns
            self.events[slot].synchronize()
            db[off:off + self.chunk].copy_(
                self.bufs[slot][:min(self.chunk, n - off)])
            if j + ns < len(offs):
                issue(j + ns)


class InfinityEngine:
    """Host-scheduled ZeRO-Infinity engine (port of the JAX package's; ref:
    deepspeed/runtime/swap_tensor/partitioned_optimizer_swapper.py): the
    compute-dtype params stay on the card, the f32 master and moments live
    on the tier in the ``[dp, chunk]`` layout (dp the ranks of the mesh's
    ``data`` axis, chunks padded to 128 elements; each rank's tier holds
    its own row, in a subdir of its own on NVMe) and stream through it in
    sub-groups of about ``zero_optimization.sub_group_size`` elements
    (default 2**24; a larger leaf is a group of its own).  Each rank
    backprops its rows of the global batch; its grads are reduce-scattered
    over ``data`` into its row, and the fresh compute rows are
    all-gathered back into the whole leaf.  ``param_specs`` cut each
    compute leaf to this rank's model-parallel block, and the ``[dp,
    chunk]`` state is that block's.

    The grad program is ``loss_fn`` under autograd over the compute leaves,
    with accumulation in f32, the finite check and global-norm clipping on
    the whole tree, and ``offload_optimizer.bf16_grads`` keeping bf16
    grads without accumulation.  Then ``update: "device"`` (default)
    streams each group's state up through page-locked staging, runs the
    plain :func:`~deepspeed_tpu_torch.ops.optim.adam` on the card, and
    streams the new state back; ``update: "host"`` streams the grads down
    in pieces, runs the native host Adam on each piece as it lands, and
    streams the fresh bf16 image piece up (2 + 2 link bytes a parameter
    against 12 + 12).  A nonfinite grad skips the step and keeps the
    state."""

    def __init__(self, loss_fn, params: Any, config, lr_scheduler=None,
                 param_specs=None, device=None, mesh=None):
        from deepspeed_tpu_torch import lr_schedules, precision
        from deepspeed_tpu_torch._device import resolve_device
        from deepspeed_tpu_torch._tree import (tree_leaves_with_keystr,
                                               tree_map)
        from deepspeed_tpu_torch.ops.optim import adam, default_lr
        from deepspeed_tpu_torch.param_stream import (_adam_hyper,
                                                      _cpu_tensor,
                                                      default_swap_dir,
                                                      process_count)

        from deepspeed_tpu_torch import comm, topology, zero
        from deepspeed_tpu_torch.engine import mesh_for

        self.config = config
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self.mesh = mesh if mesh is not None else mesh_for(config,
                                                           self.device)
        topology.set_current_mesh(self.mesh)
        self._pc = process_count()
        self._dp = self.mesh.size("data")
        self._row = self.mesh.rank_in("data")
        config.resolve_batch_sizes(self._dp)
        self.loss_fn = loss_fn
        off = config.zero.offload_optimizer or {}
        self.device_tier = off.get("device", "cpu")
        self.update_mode = off.get("update", "device")
        if self.update_mode not in ("device", "host"):
            raise ValueError(
                f"offload_optimizer.update must be 'device' or 'host', "
                f"got {self.update_mode!r}")
        opt_type = config.optimizer.type.lower()
        if opt_type not in ("adam", "adamw", "fusedadam"):
            raise ValueError(
                f"InfinityEngine supports the Adam family (the reference's "
                f"swappable optimizer is CPU-Adam), got {opt_type!r}")
        oparams = dict(config.optimizer.params)
        opt_lr = float(oparams.pop("lr", default_lr(opt_type)))
        self.lr_schedule = (
            lr_scheduler if callable(lr_scheduler)
            else lr_schedules.from_config(config.scheduler.type,
                                          config.scheduler.params,
                                          fallback_lr=opt_lr))
        oparams.pop("torch_adam", None)
        self._hyp = _adam_hyper(oparams)
        # registry parity: "adam" also defaults to decoupled decay
        adamw_mode = oparams.pop("adam_w_mode", True)
        if "betas" in oparams:
            oparams["betas"] = tuple(oparams["betas"])
        self.optimizer = adam(lr=self.lr_schedule, adamw=adamw_mode,
                              **oparams)

        # ---- the flat [dp, chunk] layout of each leaf's block
        flat = tree_leaves_with_keystr(params)
        self._template = tree_map(lambda a: 0, params)
        self._names = ["g" + p.replace("/", "_") for p, _ in flat]
        self._specs = zero.spec_leaves(params, param_specs)
        if len(self._specs) != len(flat):
            raise ValueError("param_specs tree does not match params")
        self._full = [tuple(a.shape) for _, a in flat]
        flat = [(p, zero.local_shard(_cpu_tensor(a), sp, self.mesh)
                 if sp else a) for (p, a), sp in zip(flat, self._specs)]
        self._shapes = [tuple(a.shape) for _, a in flat]
        self._sizes = [int(np.prod(s, dtype=np.int64)) for s in self._shapes]
        self._chunks = [-(-n // (self._dp * _LANE)) * _LANE
                        for n in self._sizes]
        sub_elems = int(config.zero.sub_group_size or 2 ** 24)
        groups: List[List[int]] = [[]]
        acc = 0
        for i, n in enumerate(self._sizes):
            if acc and acc + n > sub_elems:
                groups.append([])
                acc = 0
            groups[-1].append(i)
            acc += n
        self.groups = groups
        if self.device_tier == "nvme":
            self.tier: _Tier = _NvmeTier(os.path.join(
                off.get("nvme_path", default_swap_dir()),
                f"proc{comm.get_rank()}"))
        else:
            self.tier = _RamTier()
        self._compute_dtype = precision.compute_dtype(config.precision)
        self._grad_dtype = (torch.bfloat16 if off.get("bf16_grads")
                            else torch.float32)
        self.params_c: List[torch.Tensor] = []
        for i, (_, leaf) in enumerate(flat):
            arr = _cpu_tensor(leaf).to(torch.float32)
            rows = self._partition_host(arr, i)
            self.tier.put(self._names[i], rows)
            for kind in ("m", "v"):
                self.tier.put(kind + self._names[i], torch.zeros_like(rows))
            self.params_c.append(arr.to(self._compute_dtype).to(
                self.device, copy=True))
            del arr
            if isinstance(self.tier, _NvmeTier):
                self.tier.fence_writes()
        del flat
        self._stage = _Staging(self.device)
        if self._cuda:
            # the host update's pieces: grads down, bf16 images up
            self._piece = 16 << 20
            keep = self._stage._keep
            self._gpieces = pinned_views([(self._piece,)] * 2,
                                         [torch.float32] * 2, keep)
            self._ipieces = pinned_views([(self._piece,)] * 2,
                                         [torch.bfloat16] * 2, keep)
            self._gev = [torch.cuda.Event() for _ in range(2)]
            self._iev = [torch.cuda.Event() for _ in range(2)]
            self._down = torch.cuda.Stream(device=self.device)
            self._up = torch.cuda.Stream(device=self.device)
        self.global_steps = 0
        self._opt_steps = 0            # advances only on finite steps
        self.skipped_steps = 0
        self._last_metrics: Dict[str, Any] = {}
        self.step_times: List[float] = []
        self.phase_times: Dict[str, float] = {}
        self.link_bytes = {"up": 0, "down": 0}
        logger.info(
            "InfinityEngine: tier=%s update=%s groups=%d (%s elems) "
            "params=%d", self.device_tier, self.update_mode, len(groups),
            sub_elems, sum(self._sizes))

    # -------------------------------------------------- partition helpers
    def _partition_host(self, arr: torch.Tensor, i: int) -> torch.Tensor:
        """A block leaf (host) -> this rank's row of its zero-padded
        ``[dp, chunk]`` layout, as ``[1, chunk]``."""
        c = self._chunks[i]
        lo = self._row * c
        rows = torch.zeros((1, c), dtype=torch.float32)
        n = max(0, min(c, self._sizes[i] - lo))
        rows.view(-1)[:n].copy_(arr.reshape(-1)[lo:lo + n])
        return rows

    def _unpad(self, rows: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's row -> the block leaf: every rank's row gathered
        over ``data`` (a collective when dp > 1), unpadded."""
        from deepspeed_tpu_torch import comm

        flat = rows.reshape(-1)
        if self._dp > 1:
            flat = comm.all_gather(flat.contiguous(), "data")
        return flat[:self._sizes[i]].view(self._shapes[i])

    def _whole(self, rows: torch.Tensor, i: int) -> torch.Tensor:
        """The whole leaf from this rank's row (collective over data and
        the leaf's model-parallel axes)."""
        from deepspeed_tpu_torch import zero

        t = self._unpad(rows, i)
        if self._specs[i]:
            t = zero.gather_local(t, self._specs[i], self.mesh)
        return t

    # ------------------------------------------------------------------ step
    def _phase_reset(self) -> Dict[str, float]:
        self.phase_times = {
            "grad_program": 0.0, "tier_read_wait": 0.0,
            "grad_d2h_wait": 0.0, "state_h2d": 0.0, "update_submit": 0.0,
            "host_adam": 0.0, "state_d2h": 0.0, "tier_write": 0.0,
            "param_h2d_submit": 0.0, "total": 0.0}
        self.link_bytes = {"up": 0, "down": 0}
        return self.phase_times

    def phase_report(self) -> Dict[str, float]:
        """Per-phase host seconds of the last step.  Host mode:
        grad_program (forward + backward to the finite check), the tier's
        read fences, grad_d2h_wait (waits on a grad piece's download),
        host_adam, tier_write, param_h2d_submit.  Device mode: state_h2d,
        update_submit (the Adam launches), state_d2h (absorbs the
        update's execution), tier_write.  Phases overlap, so the parts can
        sum past 'total'."""
        return dict(self.phase_times)

    def _grad_step(self, batch):
        """(loss, finite, grads as this rank's ``[1, chunk]`` rows in the
        grad dtype).  Over several processes the loss is the mean over
        ``data``, each rank backprops its rows' share of it, the grads are
        reduce-scattered over ``data`` into the rows, and the finite check
        and the clipping norm are taken on the rows (one all-reduce)."""
        from deepspeed_tpu_torch import comm
        from deepspeed_tpu_torch._tree import tree_map, tree_unflatten_like
        from deepspeed_tpu_torch.engine import (accum_split,
                                                clip_by_global_norm,
                                                rank_rows)
        from deepspeed_tpu_torch.precision import finite_all

        accum = self.config.gradient_accumulation_steps
        leaves = [p.detach().requires_grad_(True) for p in self.params_c]
        tree = tree_unflatten_like(self._template, leaves)
        ranks = self._pc > 1
        share = float(self._dp) if self._dp > 1 else None

        def one(mb):
            with torch.enable_grad():
                loss = self.loss_fn(tree, mb).float()
                got = torch.autograd.grad(
                    loss if share is None else loss / share, leaves,
                    allow_unused=True)
            return loss.detach(), [torch.zeros_like(x) if g is None else g
                                   for g, x in zip(got, leaves)]

        batch = rank_rows(batch, self._dp, self._row)
        if accum > 1:
            split = accum_split(batch, accum)
            g = [torch.zeros(x.shape, dtype=torch.float32,
                             device=self.device) for x in leaves]
            lsum = None
            for i in range(accum):
                loss, gi = one(tree_map(lambda x, _i=i: x[_i], split))
                for a, b in zip(g, gi):
                    a.add_(b)
                del gi
                lsum = loss if lsum is None else lsum + loss
            for a in g:
                a.div_(accum)
            loss = lsum / accum
        else:
            loss, g = one(batch)
            if self._grad_dtype == torch.float32:
                g = [x.float() for x in g]
            # bf16_grads: the tree stays bf16 (a full f32 copy doubles the
            # transient grad memory); clipping's norm still sums in f32
        del tree, leaves
        clip = self.config.gradient_clipping
        if not ranks:
            ok = finite_all(g)
            if clip > 0:
                g, _ = clip_by_global_norm(g, clip)
        out = []
        for x, n, c in zip(g, self._sizes, self._chunks):
            f = x.reshape(-1).to(self._grad_dtype)
            if self._dp * c > n:
                f = torch.cat([f, f.new_zeros(self._dp * c - n)])
            if self._dp > 1:
                f = comm.reduce_scatter(f, "data")
            out.append(f.view(1, c))
        del g
        if ranks:
            comm.all_reduce_(loss, "data", comm.ReduceOp.AVG)
            ok, out = self._check_rows(out, clip)
        return loss, ok, out

    def _check_rows(self, rows, clip: float):
        """(finite, rows clipped by the global norm) over every rank: the
        counted sums of squares (a row counts on each rank holding a
        distinct one, once over the axes it is replicated on) and nonfinite
        counts, all-reduced once."""
        from deepspeed_tpu_torch import comm, topology, zero
        from deepspeed_tpu_torch.engine import _clip_factor

        live = [a for a in topology.AXES if self.mesh.size(a) > 1]
        sums = torch.zeros(2, dtype=torch.float32, device=self.device)
        for r, sp in zip(rows, self._specs):
            split = set(zero.spec_axes(sp)) | {"data"}
            rf = r.float()
            if all(a in split or self.mesh.rank_in(a) == 0 for a in live):
                sums[0] += torch.sum(torch.square(rf))
            sums[1] += (~torch.isfinite(rf)).any().float()
        for a in live:
            comm.all_reduce_(sums, a)
        ok = bool(sums[1].item() == 0) and bool(torch.isfinite(sums[0]))
        if ok and clip > 0:
            factor = _clip_factor(torch.sqrt(sums[0]), clip)
            rows = [r * factor.to(r.dtype) for r in rows]
        return ok, rows

    def _submit_group_read(self, k: int):
        """Begin fetching group k's (master, mu, nu) rows from the tier."""
        return [tuple(self.tier.get_submit(
            kind + self._names[i], (1, self._chunks[i]),
            torch.float32) for kind in ("", "m", "v"))
            for i in self.groups[k]]

    def _restore_params_from_tier(self) -> None:
        """Rebuild the compute leaves from the tier's master rows after a
        failed step (groups written this step keep their new values)."""
        if isinstance(self.tier, _NvmeTier):
            self.tier.fence_all()
        for i, n in enumerate(self._names):
            rows = self.tier.get_submit(n, (1, self._chunks[i]),
                                        torch.float32)
            self.tier.fence_reads()
            self._stage.h2d(self.params_c[i],
                            self._unpad(rows, i).to(self._compute_dtype))
        if isinstance(self.tier, _NvmeTier):
            self.tier.fence_all()

    def _finish(self, t0, loss, ok: bool):
        self.global_steps += 1
        if ok:
            self._opt_steps += 1
        else:
            self.skipped_steps += 1
        self._last_metrics = {"loss": loss, "overflow": int(not ok)}
        self.step_times.append(time.perf_counter() - t0)
        self.phase_times["total"] = self.step_times[-1]
        return loss

    def train_batch(self, batch) -> torch.Tensor:
        """One optimizer step; returns the loss (an f32 scalar tensor on
        the device)."""
        from deepspeed_tpu_torch._tree import tree_map
        from deepspeed_tpu_torch.engine import _to_device

        t0 = time.perf_counter()
        batch = tree_map(lambda x: _to_device(x, self.device), batch)
        ph = self._phase_reset()
        nvme = isinstance(self.tier, _NvmeTier)
        grads = None
        try:
            t1 = time.perf_counter()
            loss, ok, grads = self._grad_step(batch)
            ph["grad_program"] += time.perf_counter() - t1
            if not ok:
                # the step is skipped and the state kept, as JAX's update
                # keeps it under a nonfinite flag
                return self._finish(t0, loss, False)
            if self.update_mode == "host":
                self._host_update(grads, ph, nvme)
            else:
                self._device_update(grads, ph, nvme)
            if nvme:
                t1 = time.perf_counter()
                self.tier.fence_all()   # read-after-write for the next step
                ph["tier_write"] += time.perf_counter() - t1
        except BaseException:
            grads = None
            self._restore_params_from_tier()
            raise
        return self._finish(t0, loss, True)

    def _groups(self, ph, nvme):
        """Yield ``(k, group, bufs)`` with group k + 1's reads in flight
        while group k is updated."""
        pending = self._submit_group_read(0)
        for k, group in enumerate(self.groups):
            if nvme:
                t1 = time.perf_counter()
                self.tier.fence_reads()
                ph["tier_read_wait"] += time.perf_counter() - t1
                self.tier.next_read_slot()
            bufs = pending
            if k + 1 < len(self.groups):
                pending = self._submit_group_read(k + 1)
            yield k, group, bufs

    def _write_group(self, group, bufs, ph, nvme):
        t1 = time.perf_counter()
        if nvme:
            self.tier.fence_writes()   # this slot's writes of two groups ago
        for j, i in enumerate(group):
            for kind, t in zip(("", "m", "v"), bufs[j]):
                self.tier.put(kind + self._names[i], t)
        if nvme:
            self.tier.next_write_slot()
        ph["tier_write"] += time.perf_counter() - t1

    def _device_update(self, grads, ph, nvme):
        """Each group's state up, the plain Adam on the card, the state
        back (into the RAM tier's rows in place)."""
        from deepspeed_tpu_torch.ops.optim import AdamState

        step = self._opt_steps
        for k, group, bufs in self._groups(ph, nvme):
            t1 = time.perf_counter()
            state = [[torch.empty(b.shape, dtype=torch.float32,
                                  device=self.device) for b in trio]
                     for trio in bufs]
            for trio, dev in zip(bufs, state):
                for b, d in zip(trio, dev):
                    self._stage.h2d(d, b)
                    self.link_bytes["up"] += b.numel() * 4
            ph["state_h2d"] += time.perf_counter() - t1
            g_k = [grads[i].float() for i in group]
            for i in group:
                grads[i] = None
            t1 = time.perf_counter()
            master = [s[0] for s in state]
            upd, new = self.optimizer.update(
                g_k, AdamState(step, [s[1] for s in state],
                               [s[2] for s in state]), master)
            new_master = [p + u for p, u in zip(master, upd)]
            for j, i in enumerate(group):
                self.params_c[i].copy_(self._unpad(new_master[j], i))
            ph["update_submit"] += time.perf_counter() - t1
            del state, master, upd, g_k
            t1 = time.perf_counter()
            for j, trio in enumerate(bufs):
                for b, d in zip(trio, (new_master[j], new.mu[j],
                                       new.nu[j])):
                    self._stage.d2h(b, d)
                    self.link_bytes["down"] += b.numel() * 4
            ph["state_d2h"] += time.perf_counter() - t1
            del new, new_master
            self._write_group(group, bufs, ph, nvme)

    def _host_update(self, grads, ph, nvme):
        """Grads down, the native host Adam, fresh compute rows up; the f32
        state never crosses the link."""
        t = self._opt_steps + 1
        lr = float(self.lr_schedule(t))
        for k, group, bufs in self._groups(ph, nvme):
            for j, i in enumerate(group):
                w, m, v = (b.view(-1) for b in bufs[j])
                self._host_update_leaf(i, grads[i], w, m, v, lr, t, ph)
                grads[i] = None
            self._write_group(group, bufs, ph, nvme)

    def _adam(self, w, m, v, g, lr, t, out):
        from deepspeed_tpu_torch.ops.cpu_adam import cpu_adam_step

        b1, b2 = self._hyp["betas"]
        return cpu_adam_step(
            w, m, v, g, lr=lr, b1=b1, b2=b2, eps=self._hyp["eps"],
            wd=self._hyp["wd"], adamw=self._hyp["adamw"], t=t,
            bias_correction=self._hyp["bias_correction"],
            emit_bf16=out is not None, out=out)

    def _host_update_leaf(self, i, g_rows, w, m, v, lr, t, ph):
        n, size = w.numel(), self._sizes[i]
        dst = self.params_c[i].view(-1)
        self.link_bytes["down"] += g_rows.numel() * g_rows.element_size()
        self.link_bytes["up"] += size * dst.element_size()
        bf16 = self._compute_dtype == torch.bfloat16
        if not self._cuda or not bf16 or self._dp > 1:
            t1 = time.perf_counter()
            g = torch.empty(n, dtype=g_rows.dtype)
            self._stage.d2h(g, g_rows.reshape(-1))
            g = g.float()
            ph["grad_d2h_wait"] += time.perf_counter() - t1
            t1 = time.perf_counter()
            img = torch.empty(n, dtype=torch.bfloat16) if bf16 else None
            self._adam(w, m, v, g, lr, t, img)
            ph["host_adam"] += time.perf_counter() - t1
            t1 = time.perf_counter()
            rows = img if bf16 else w.to(self._compute_dtype)
            self._stage.h2d(dst, self._unpad(rows, i).reshape(-1))
            ph["param_h2d_submit"] += time.perf_counter() - t1
            return
        # CUDA, bf16: pieces of the grad come down into page-locked slots,
        # the host Adam runs on each as it lands, and its bf16 image goes
        # up from its own slot while the next piece is updated
        g32 = g_rows.reshape(-1).float()
        S, ns = self._piece, len(self._gpieces)
        offs = list(range(0, n, S))
        cur = torch.cuda.current_stream()
        self._down.wait_stream(cur)
        self._up.wait_stream(cur)

        def issue(j):
            s, o = j % ns, offs[j]
            with torch.cuda.stream(self._down):
                self._gpieces[s][:min(S, n - o)].copy_(g32[o:o + S],
                                                       non_blocking=True)
                self._gev[s].record(self._down)

        for j in range(min(ns, len(offs))):
            issue(j)
        for j, o in enumerate(offs):
            s, c = j % ns, min(S, n - o)
            t1 = time.perf_counter()
            self._gev[s].synchronize()
            self._iev[s].synchronize()    # the slot's last upload is done
            ph["grad_d2h_wait"] += time.perf_counter() - t1
            t1 = time.perf_counter()
            self._adam(w[o:o + c], m[o:o + c], v[o:o + c],
                       self._gpieces[s][:c], lr, t, self._ipieces[s][:c])
            ph["host_adam"] += time.perf_counter() - t1
            if j + ns < len(offs):
                issue(j + ns)
            t1 = time.perf_counter()
            vc = min(c, size - o)
            if vc > 0:
                with torch.cuda.stream(self._up):
                    dst[o:o + vc].copy_(self._ipieces[s][:vc],
                                        non_blocking=True)
                    self._iev[s].record(self._up)
            ph["param_h2d_submit"] += time.perf_counter() - t1
        cur.wait_stream(self._up)
        # every grad piece has landed: g32 may go
        del g32

    # ----------------------------------------------------------- inspection
    def comms_digest(self, batch, link_gbps: float = 45.0) -> dict:
        """Per-kind count and bytes of the collectives one step on
        ``batch`` runs: a dry step through the comms logger (see
        :meth:`~deepspeed_tpu_torch.engine.TrainingEngine.comms_digest`):
        the grad program with its exchanges, then the all-gather of each
        leaf's (unchanged) compute rows that the update ends with; no
        state, counter or schedule advances.  Returns the dict."""
        from deepspeed_tpu_torch._tree import tree_map
        from deepspeed_tpu_torch.comm.digest import dry_digest
        from deepspeed_tpu_torch.engine import _to_device

        def run():
            b = tree_map(lambda x: _to_device(x, self.device), batch)
            _, _, grads = self._grad_step(b)
            del grads
            if self._dp > 1:
                for i, p in enumerate(self.params_c):
                    c = self._chunks[i]
                    flat = p.reshape(-1)
                    row = torch.zeros(c, dtype=p.dtype, device=p.device)
                    n = max(0, min(c, flat.numel() - self._row * c))
                    row[:n] = flat[self._row * c:self._row * c + n]
                    self._unpad(row, i)

        return dry_digest(run, link_gbps)

    @property
    def metrics(self):
        return self._last_metrics

    def get_lr(self):
        return [float(self.lr_schedule(self._opt_steps))]

    @property
    def train_batch_size(self):
        return self.config.train_batch_size

    @property
    def gradient_accumulation_steps(self):
        return self.config.gradient_accumulation_steps

    def hbm_state_bytes(self) -> int:
        """Bytes of persistent train state on the card: the compute-dtype
        params only (2N for bf16); the 12N of f32 master and moments live
        on the tier and transit in sub-groups."""
        return sum(x.numel() * x.element_size() for x in self.params_c)

    def tier_local_bytes(self) -> int:
        """Bytes of f32 state this rank's tier holds (12 per element of
        its padded rows)."""
        return sum(12 * c for c in self._chunks)

    # ---------------------------------------------------------- checkpoint
    def _ckpt_key(self, kind: str, i: int) -> str:
        """The JAX engine's universal key: index + sanitized leaf path."""
        import re

        return f"{kind}{i:04d}_" + re.sub(r"[^0-9A-Za-z_]", "",
                                          self._names[i])

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[dict] = None,
                        async_save: bool = False):
        """The universal per-leaf layout, each leaf flat and unpadded, so
        the checkpoint restores under any layout; synchronous
        (``async_save`` is accepted for parity: the state is already on
        the host)."""
        from deepspeed_tpu_torch.checkpoint import (
            UniversalLeafCheckpointer, finalize_checkpoint_dir,
            wait_for_checkpoint)

        from deepspeed_tpu_torch import comm

        wait_for_checkpoint()
        tag = tag or f"global_step{self.global_steps}"
        d = os.path.join(os.path.abspath(save_dir), tag)
        writes = comm.get_rank() == 0
        ulc = UniversalLeafCheckpointer(d) if writes else None
        for i, n in enumerate(self._names):
            for kind in ("", "m", "v"):
                buf = self.tier.get_submit(
                    kind + n, (1, self._chunks[i]), torch.float32)
                self.tier.fence_reads()
                item = self._whole(buf, i).reshape(-1)
                if writes:
                    ulc.save(self._ckpt_key(kind or "w", i), item)
        if isinstance(self.tier, _NvmeTier):
            self.tier.fence_all()
        if writes:
            ulc.wait()
            finalize_checkpoint_dir(save_dir, tag, {
                "global_steps": self.global_steps,
                "opt_steps": self._opt_steps,
                "skipped_steps": self.skipped_steps,
                "client_state": client_state or {}})
        if self._pc > 1:
            comm.barrier()
        return d

    def wait_for_checkpoint(self) -> None:
        """Parity with TrainingEngine: saves here are synchronous."""
        from deepspeed_tpu_torch.checkpoint import wait_for_checkpoint

        wait_for_checkpoint()

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None):
        from deepspeed_tpu_torch.checkpoint import (
            UniversalLeafCheckpointer, read_meta, resolve_offload_tag)

        from deepspeed_tpu_torch import comm, zero

        if self._pc > 1:
            comm.barrier()
        d = resolve_offload_tag(load_dir, tag)
        ulc = UniversalLeafCheckpointer(d)
        for i, n in enumerate(self._names):
            leaf = {}
            for k in "wmv":
                t = ulc.restore(self._ckpt_key(k, i)).view(self._full[i])
                if self._specs[i]:
                    t = zero.local_shard(t, self._specs[i], self.mesh)
                leaf[k] = t.contiguous()
            for kind, key in (("", "w"), ("m", "m"), ("v", "v")):
                self.tier.put(kind + n, self._partition_host(leaf[key], i))
            self._stage.h2d(self.params_c[i],
                            leaf["w"].to(self._compute_dtype))
            if isinstance(self.tier, _NvmeTier):
                self.tier.fence_writes()
        if isinstance(self.tier, _NvmeTier):
            self.tier.fence_all()
        meta = read_meta(d)
        self.global_steps = meta["global_steps"]
        self._opt_steps = meta["opt_steps"]
        self.skipped_steps = meta["skipped_steps"]
        return d, meta.get("client_state", {})

    def master_params(self) -> Any:
        """The f32 masters, consolidated, as CPU tensors in the params'
        layout (every rank's rows and blocks gathered: a collective over
        several processes)."""
        from deepspeed_tpu_torch._tree import tree_unflatten_like

        out = []
        for i, n in enumerate(self._names):
            rows = self.tier.get_submit(n, (1, self._chunks[i]),
                                        torch.float32)
            self.tier.fence_reads()
            out.append(self._whole(rows, i).clone())
        if isinstance(self.tier, _NvmeTier):
            self.tier.fence_all()
        return tree_unflatten_like(self._template, out)

    def module_params(self) -> Any:
        return self.master_params()
