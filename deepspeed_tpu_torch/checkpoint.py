"""Checkpoint engine (port of ``deepspeed_tpu/checkpoint.py``; ref:
deepspeed/runtime/checkpoint_engine/, deepspeed/utils/zero_to_fp32.py).

The JAX package saves its ``TrainState`` through Orbax, which needs jax.
The port writes plain files that need no package beyond torch::

    <save_dir>/<tag>/state/params.pt      torch.save of {path: tensor}
    <save_dir>/<tag>/state/opt_state.pt   the optimizer's trees, {path: tensor}
    <save_dir>/<tag>/state/scalars.json   step, optimizer kind and step, scaler
    <save_dir>/<tag>/meta.json            global/skipped steps, client state, config
    <save_dir>/latest                     the newest tag

Paths are the reference's pytree paths joined with ``/`` (``embed``,
``blocks/wq``; the optimizer's under its field names, ``mu/blocks/wq``), the
keys :func:`zero_to_fp32` writes, as the JAX one does.  The port's
``TrainState`` holds Python numbers where JAX holds arrays (the step, the
optimizer's step, the loss scaler): they round-trip through JSON as the same
Python types.  ``meta.json`` and then ``latest`` are written only after the
state files are on disk (each written to a temporary name, flushed with
``fsync`` and renamed), so ``latest`` never names a partial checkpoint.

Saving copies the state to host memory before it returns, since the engine
updates its master params and moments in place; ``async_save=True`` then
writes the copy from a background thread while training goes on.  Loading
reads the files memory-mapped and copies each leaf into the engine's own
tensors, so the card holds one state, not two.

Across ranks the layout stays the same, so a checkpoint loads at any ZeRO
stage and world size (the JAX package restores onto the engine's current
shardings for the same reason).  Every rank takes part in the save: each
leaf held as shards is gathered whole on the card, one leaf at a time (the
peak is one extra leaf), and rank 0 alone copies it to the host and writes
the files.  On load every rank cuts its own slice of each leaf from the
memory-mapped files.  State an engine keeps in host memory (ZeRO-Offload)
visits the card for the gather on save, and on load each slice is copied
straight into its host buffer.  The qwZ engine's flat rows are saved whole, as the
``[world, chunk]`` buffer JAX saves; ``zero_to_fp32`` refuses them, as
JAX's does (``consolidate_to_fp32(engine)`` goes through
``module_params()``).

The offload engines (``ParamStreamEngine``, ``InfinityEngine``) write the
JAX package's universal per-leaf layout instead, one flat unpadded f32
leaf per file (:class:`UniversalLeafCheckpointer`): JAX writes each as an
Orbax item, the port as ``<tag>/state/<key>.npy`` under the same keys
(``w0003_b5``, ``stemw_000``, ...), and a param-stream ``meta.json`` carries
the same ``pstream_universal`` manifest, from which :func:`zero_to_fp32`
consolidates the checkpoint one leaf at a time into the JAX tool's
``.npz`` names (``blocks/<leaf>`` stacked, ``stem/<leaf>``,
``head/<leaf>``).
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import threading
from typing import Callable, Optional

import numpy as np
import torch

from deepspeed_tpu_torch._tree import tree_leaves_with_path, tree_map

logger = logging.getLogger(__name__)

_STATE = "state"
_PARAMS, _OPT, _SCALARS = "params.pt", "opt_state.pt", "scalars.json"


def _ckpt_dir(save_dir: str, tag: str) -> str:
    return os.path.join(os.path.abspath(save_dir), tag)


def _resolve_tag(load_dir: str, tag: Optional[str],
                 required: bool) -> Optional[str]:
    """Tag from the ``latest`` file when not given explicitly."""
    if tag is not None:
        return tag
    latest = os.path.join(os.path.abspath(load_dir), "latest")
    if os.path.exists(latest):
        with open(latest) as f:
            return f.read().strip()
    if required:
        raise FileNotFoundError(
            f"no 'latest' file under {load_dir}; pass tag= explicitly")
    return None


def _write_file(path: str, write: Callable) -> None:
    """``write(f)`` into ``path`` durably: a temporary name, flushed and
    fsynced, then renamed over ``path``."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _write_json(path: str, obj) -> None:
    _write_file(path, lambda f: f.write(json.dumps(obj).encode()))


class _BackgroundSave:
    """The process's one in-flight ``async_save``: its writer thread and
    the meta/``latest`` commit that follows it.  Any engine's next save,
    load or wait joins it, as the JAX package's module-scope checkpointer
    does."""

    def __init__(self):
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._finalize: Optional[Callable] = None

    def start(self, write: Callable, finalize: Callable) -> None:
        def run():
            try:
                write()
            except Exception as e:      # re-raised by join()
                self._error = e

        with self._lock:
            self._thread = threading.Thread(target=run, name="ckpt-write")
            self._finalize = finalize
            self._thread.start()

    def join(self) -> None:
        """Wait for the write, then commit it.  The commit is taken off
        first: if the write failed, its error propagates and ``latest``
        keeps naming the previous good tag."""
        with self._lock:
            thread, fin = self._thread, self._finalize
            self._thread = self._finalize = None
            if thread is None:
                return
            thread.join()
            err, self._error = self._error, None
        if err is not None:
            raise err
        fin()


_BACKGROUND = _BackgroundSave()
atexit.register(_BACKGROUND.join)


def finalize_checkpoint_dir(save_dir: str, tag: str, meta: dict) -> None:
    """Durable-commit tail of a save: write meta.json in the tagged dir,
    then point ``latest`` at it.  Call only after the state is on disk."""
    path = _ckpt_dir(save_dir, tag)
    _write_json(os.path.join(path, "meta.json"), meta)
    _write_file(os.path.join(os.path.abspath(save_dir), "latest"),
                lambda f: f.write(tag.encode()))
    logger.info("saved checkpoint %s", path)


def _writes(engine) -> bool:
    """Whether this rank writes the engine's checkpoint: index 0 along
    every axis of the engine's mesh (a one-rank engine inside a larger
    world writes its own)."""
    from deepspeed_tpu_torch.topology import AXES

    ms = getattr(engine, "mesh", None)
    if ms is None:
        from deepspeed_tpu_torch import comm

        return comm.get_rank() == 0
    return all(ms.rank_in(a) == 0 for a in AXES)


def _barrier(engine) -> None:
    """Every rank of the engine's mesh waits for the others (nothing for
    an engine of one rank, whatever the world)."""
    from deepspeed_tpu_torch import comm

    ms = getattr(engine, "mesh", None)
    if ms is None or ms.device_mesh is not None:
        comm.barrier()


def _opt_fields(opt):
    """(name, tree) of each optimizer field shaped like the params."""
    return [(f, v) for f, v in zip(opt._fields, opt)
            if f != "step" and v is not None]


def _gathered_copy(tree, dims, keep: bool, prefix: str = "",
                   specs=None, visit=None) -> dict:
    """{path: whole leaf on the host}: each leaf gathered along its ZeRO
    dim and then over the model-parallel axes of its spec on the card
    (every rank takes part; ``visit`` brings a host-placed leaf there),
    copied to the host on the keeping rank and dropped before the next."""
    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.topology import current_mesh

    out = {}
    specs = specs or [()] * len(dims)
    for (path, t), d, sp in zip(tree_leaves_with_path(tree), dims, specs):
        t = t.detach()
        full = zero.gather_shard(t if visit is None else visit(t), d)
        if zero.spec_axes(sp):
            full = zero.gather_local(full, sp, current_mesh())
        if keep:
            out[prefix + path] = full.to("cpu", copy=True)
        del full
    return out


def _snapshot(engine) -> Optional[dict]:
    """Host copies of the train state, keyed by path, and its numbers; None
    on the ranks that do not write."""
    from deepspeed_tpu_torch import comm

    state = engine.state
    opt = state.opt_state
    layout = engine.state_layout()
    keep = _writes(engine)
    if layout[0] == "qwz":
        def rows(t):
            full = comm.all_gather(t.detach(), "data", tiled=False)
            return full.cpu() if keep else None

        params = {"": rows(state.params)}
        optc = {f: rows(v) for f, v in _opt_fields(opt)}
    else:
        _, pdims, odims, specs = layout
        visit = getattr(engine, "_visit", None)
        params = _gathered_copy(state.params, pdims, keep, specs=specs,
                                visit=visit)
        optc = {}
        for f, v in _opt_fields(opt):
            optc.update(_gathered_copy(v, odims, keep, prefix=f + "/",
                                       specs=specs, visit=visit))
    if not keep:
        return None
    return {
        _PARAMS: params,
        _OPT: optc,
        _SCALARS: {
            "step": state.step,
            "opt_state": {"kind": type(opt).__name__, "step": opt.step,
                          "fields": [f for f, _ in _opt_fields(opt)]},
            "scaler": {"scale": state.scaler.scale,
                       "good_steps": state.scaler.good_steps}}}


def _write_state(state_dir: str, snap: dict) -> None:
    os.makedirs(state_dir, exist_ok=True)
    for name in (_PARAMS, _OPT):
        _write_file(os.path.join(state_dir, name),
                    lambda f, flat=snap[name]: torch.save(flat, f))
    _write_json(os.path.join(state_dir, _SCALARS), snap[_SCALARS])


def save_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                    client_state: Optional[dict] = None,
                    async_save: bool = False) -> str:
    """ref: DeepSpeedEngine.save_checkpoint(save_dir, tag, client_state).

    The state is copied to host memory before this returns, so training
    may update ``engine.state`` at once.  ``async_save=True`` writes the
    copy from a background thread; meta.json and ``latest`` follow once it
    is on disk (:func:`wait_for_checkpoint`, or the next save or load of
    any engine, joins it).
    """
    tag = tag or f"global_step{engine.global_steps}"
    path = _ckpt_dir(save_dir, tag)
    # at most one save in flight, and the previous one's commit must run
    wait_for_checkpoint(engine)
    snap = _snapshot(engine)
    if snap is None:                    # a rank that does not write
        if not async_save:
            _barrier(engine)            # rank 0's files are on disk
        return path
    meta = {
        "global_steps": engine.global_steps,
        "skipped_steps": engine.skipped_steps,
        "client_state": client_state or {},
        "config": engine.config.raw,
    }

    def write():
        _write_state(os.path.join(path, _STATE), snap)

    def finalize():
        finalize_checkpoint_dir(save_dir, tag, meta)

    if async_save:
        _BACKGROUND.start(write, finalize)
        return path
    write()
    finalize()
    _barrier(engine)
    return path


def wait_for_checkpoint(engine=None) -> None:
    """Join a pending ``async_save`` and commit it; a failed write raises
    here and leaves the previous ``latest`` standing."""
    _BACKGROUND.join()


def _load_flat(path: str) -> dict:
    return torch.load(path, map_location="cpu", mmap=True, weights_only=True)


def _copy_into(flat: dict, tree, what: str, dims, rank: int, world: int,
               prefix: str = "", specs=None) -> None:
    """Copy this rank's slice of each checkpoint leaf (its model-parallel
    block under its spec, then its slice along its ZeRO dim; the whole leaf
    where neither splits it) into the engine's tensor at its path; the two
    trees must hold the same paths, whole shapes and dtypes."""
    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.topology import current_mesh

    specs = specs or [()] * len(dims)
    leaves = [(prefix + p, t) for p, t in tree_leaves_with_path(tree)]
    mine = {p for p, _ in leaves}
    missing = sorted({k for k in flat if k.startswith(prefix)} ^ mine)
    if missing:
        raise ValueError(f"checkpoint {what} and the engine's differ in "
                         f"leaves {missing}")
    with torch.no_grad():
        for (p, leaf), d, sp in zip(leaves, dims, specs):
            src = flat[p]
            if zero.spec_axes(sp):
                src = zero.local_shard(src, sp, current_mesh())
            want = tuple(leaf.shape) if d is None else \
                tuple(leaf.shape[:d]) + (leaf.shape[d] * world,) \
                + tuple(leaf.shape[d + 1:])
            if tuple(src.shape) != want or src.dtype != leaf.dtype:
                raise ValueError(
                    f"checkpoint {what} leaf {p!r} is {tuple(src.shape)} "
                    f"{src.dtype}, the engine's {want} {leaf.dtype}")
            leaf.copy_(zero.take_shard(src, d, rank, world))


def load_checkpoint(engine, load_dir: str, tag: Optional[str] = None):
    """ref: DeepSpeedEngine.load_checkpoint -> (path, client_state), or
    (None, {}) when there is no ``latest`` and no tag.  Copies into the
    engine's existing tensors, whose device, dtypes and shapes stay; each
    rank reads its own slices, so the checkpoint may come from another
    ZeRO stage or world size."""
    wait_for_checkpoint(engine)          # join any pending async save
    _barrier(engine)                     # every rank's save is on disk
    tag = _resolve_tag(load_dir, tag, required=False)
    if tag is None:
        return None, {}
    path = _ckpt_dir(load_dir, tag)
    state_dir = os.path.join(path, _STATE)
    with open(os.path.join(state_dir, _SCALARS)) as f:
        scalars = json.load(f)
    state = engine.state
    opt = state.opt_state
    o = scalars["opt_state"]
    if o["kind"] != type(opt).__name__:
        raise ValueError(f"checkpoint optimizer state is {o['kind']}, the "
                         f"engine's {type(opt).__name__}")
    layout = engine.state_layout()
    world, rank = getattr(engine, "dp", 1), getattr(engine, "rank", 0)
    params = _load_flat(os.path.join(state_dir, _PARAMS))
    optf = _load_flat(os.path.join(state_dir, _OPT))
    if layout[0] == "qwz":
        if set(params) != {""} or params[""].shape != (
                world, state.params.shape[0]):
            raise ValueError(
                "checkpoint params are not this qwZ engine's [world, chunk] "
                f"rows ({world}, {state.params.shape[0]})")
        with torch.no_grad():
            state.params.copy_(params[""][rank])
            for f, v in _opt_fields(opt):
                v.copy_(optf[f][rank])
    else:
        _, pdims, odims, specs = layout
        _copy_into(params, state.params, "params", pdims, rank, world,
                   specs=specs)
        fields = _opt_fields(opt)
        for f, v in fields:
            _copy_into(optf, v, "optimizer state", odims, rank, world,
                       prefix=f + "/", specs=specs)
        extra = sorted(k for k in optf
                       if k.split("/", 1)[0] not in dict(fields))
        if extra:
            raise ValueError("checkpoint optimizer state and the engine's "
                             f"differ in leaves {extra}")
    engine.state = state._replace(
        step=int(scalars["step"]), opt_state=opt._replace(step=int(o["step"])),
        scaler=type(state.scaler)(float(scalars["scaler"]["scale"]),
                                  int(scalars["scaler"]["good_steps"])))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    # the curriculum's difficulty is a function of global_steps, so it is
    # re-derived from here on the next step
    engine.global_steps = int(meta.get("global_steps", 0))
    engine.skipped_steps = int(meta.get("skipped_steps", 0))
    logger.info("loaded checkpoint %s", path)
    return path, meta.get("client_state", {})


class UniversalLeafCheckpointer:
    """The offload engines' per-leaf universal layout: each state leaf is
    one ``.npy`` file, ``<tag_dir>/state/<key>.npy``, a flat unpadded f32
    array, restorable under any tier or engine.  One file per leaf keeps
    the transient to a single leaf, never the whole 12-bytes-a-parameter
    state (which by the offload engines' premise does not fit).  Writes go
    to a few background threads (the next leaf's tier read overlaps this
    one's write, as JAX's background Orbax commit does), each under a
    temporary name, fsynced and renamed; a saved buffer must stay unchanged
    until :meth:`wait`."""

    def __init__(self, tag_dir: str, workers: int = 4):
        self.state_dir = os.path.join(tag_dir, _STATE)
        os.makedirs(self.state_dir, exist_ok=True)
        self._workers = workers
        self._pool = None
        self._futs: list = []

    def _path(self, key: str) -> str:
        return os.path.join(self.state_dir, key + ".npy")

    def save(self, key: str, arr) -> None:
        """Queue one leaf's write (at most twice the writers in flight)."""
        from concurrent.futures import ThreadPoolExecutor

        a = np.ascontiguousarray(
            arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor)
            else np.asarray(arr)).reshape(-1)
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self._workers, thread_name_prefix="ckpt-leaf")
        while len(self._futs) >= 2 * self._workers:
            self._futs.pop(0).result()
        self._futs.append(self._pool.submit(
            _write_file, self._path(key),
            lambda f: np.lib.format.write_array(f, a)))

    def restore(self, key: str) -> torch.Tensor:
        """The leaf, read into a fresh CPU tensor."""
        return torch.from_numpy(np.load(self._path(key)))

    def restore_into(self, key: str, out: np.ndarray) -> None:
        """Read the leaf straight into ``out`` (C-contiguous, its size and
        dtype)."""
        with open(self._path(key), "rb") as f:
            major, _ = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if major == 1
                    else np.lib.format.read_array_header_2_0)
            shape, _, dtype = read(f)
            view = out.reshape(-1)
            if int(np.prod(shape)) != view.size or dtype != view.dtype:
                raise ValueError(f"checkpoint leaf {key}: {shape} {dtype}, "
                                 f"expected {view.size} {view.dtype}")
            got = f.readinto(memoryview(view.view(np.uint8)))
        if got != view.nbytes:
            raise IOError(f"short read of {self._path(key)}")

    def wait(self) -> None:
        """Join every queued write; the first failure raises here."""
        futs, self._futs = self._futs, []
        try:
            for fut in futs:
                fut.result()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None


def read_meta(tag_dir: str) -> dict:
    with open(os.path.join(tag_dir, "meta.json")) as f:
        return json.load(f)


def resolve_offload_tag(load_dir: str, tag: Optional[str]) -> str:
    """The tagged directory an offload engine loads: ``tag``, else the
    ``latest`` pointer, else the numerically newest ``global_step`` dir
    that holds a meta.json."""
    wait_for_checkpoint()
    tag = _resolve_tag(load_dir, tag, required=False)
    if tag is None:
        tags = [t for t in os.listdir(load_dir)
                if os.path.exists(os.path.join(load_dir, t, "meta.json"))]
        if not tags:
            raise FileNotFoundError(f"no checkpoints under {load_dir}")
        tag = max(tags, key=lambda t: (
            int(t.rsplit("global_step", 1)[-1])
            if t.rsplit("global_step", 1)[-1].isdigit() else -1, t))
    return _ckpt_dir(load_dir, tag)


def _pstream_to_fp32(tag_dir: str, manifest: dict, output: str):
    """Offline consolidation of a param-stream universal checkpoint: stack
    each block leaf's L per-layer files into its ``[L, ...]`` array, add
    the stem and head leaves, and write one ``.npz`` keyed by the factored
    paths of the manifest (``blocks/<leaf>`` stacked, ``stem/<leaf>``,
    ``head/<leaf>``), engine- and model-free.  Arrays stream into the zip
    one at a time, so the transient is a single stacked leaf; returns the
    lazy ``NpzFile`` for the same reason."""
    import re
    import zipfile

    ulc = UniversalLeafCheckpointer(tag_dir)
    L = int(manifest["n_layers"])

    def leaf_name(path: str) -> str:
        # "['attn']['wq']" -> "attn/wq"
        return re.sub(r"[^0-9A-Za-z_./]", "", path.replace("][", "/"))

    n = 0
    with zipfile.ZipFile(output, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        def add(name, arr):
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.ascontiguousarray(arr))

        for b in manifest["blocks"]:
            shape = tuple(b["shape"])
            stack = np.empty((L,) + shape, np.float32)
            for l in range(L):
                ulc.restore_into(f"w{l:04d}_{b['key']}", stack[l])
            add(f"blocks/{leaf_name(b['path'])}", stack)
            del stack
            n += 1
        for pre in ("stem", "head"):
            for i, s in enumerate(manifest[pre]):
                add(f"{pre}/{leaf_name(s['path'])}",
                    ulc.restore(f"{pre}w_{i:03d}").numpy().reshape(
                        tuple(s["shape"])))
                n += 1
    logger.info("wrote %d fp32 tensors (pstream universal layout) to %s",
                n, output)
    return np.load(output)


def _f32(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def consolidate_to_fp32(engine):
    """The engine's params as a tree of numpy arrays, floats in float32
    (ref: zero_to_fp32.py; one device: no gather)."""
    return tree_map(_f32, engine.module_params())


# ------------------------------------------------------------ offline CLI
def zero_to_fp32(ckpt_dir: str, output: str, tag: Optional[str] = None):
    """Offline checkpoint -> one ``.npz`` of float32 params keyed by
    pytree path, engine-free (ref: deepspeed/utils/zero_to_fp32.py).
    Reads only the params file, memory-mapped.  Returns the dict written;
    for a param-stream checkpoint, the ``NpzFile`` of
    :func:`_pstream_to_fp32`."""
    tag = _resolve_tag(ckpt_dir, tag, required=True)
    meta_path = os.path.join(_ckpt_dir(ckpt_dir, tag), "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        cfg = meta.get("config", {})
        if (cfg.get("zero_optimization") or {}).get(
                "zero_quantized_weights"):
            raise ValueError(
                "this checkpoint was written by the qwZ engine: its "
                "params are one flat [world, chunk] buffer, not a module "
                "pytree — consolidate in-process via "
                "engine.module_params() / consolidate_to_fp32(engine)")
        if "pstream_universal" in meta:
            return _pstream_to_fp32(
                _ckpt_dir(ckpt_dir, tag), meta["pstream_universal"], output)
    params = _load_flat(os.path.join(_ckpt_dir(ckpt_dir, tag), _STATE,
                                     _PARAMS))
    flat = {k: _f32(params[k]) for k in sorted(params)}
    np.savez(output, **flat)
    logger.info("wrote %d fp32 tensors to %s", len(flat), output)
    return flat


def main(argv=None):
    """``python -m deepspeed_tpu_torch.checkpoint <checkpoint_dir>
    <output.npz> [--tag TAG]``"""
    import argparse

    ap = argparse.ArgumentParser(
        description="Consolidate a deepspeed_tpu_torch checkpoint into one "
                    "fp32 .npz (ref: zero_to_fp32.py)")
    ap.add_argument("checkpoint_dir")
    ap.add_argument("output")
    ap.add_argument("--tag", default=None)
    args = ap.parse_args(argv)
    zero_to_fp32(args.checkpoint_dir, args.output, tag=args.tag)


if __name__ == "__main__":  # pragma: no cover
    main()
