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


def _host_copy(tree) -> dict:
    return {p: t.detach().to("cpu", copy=True)
            for p, t in tree_leaves_with_path(tree)}


def _snapshot(state) -> dict:
    """Host copies of the train state, keyed by path, and its numbers."""
    opt = state.opt_state
    return {
        _PARAMS: _host_copy(state.params),
        _OPT: _host_copy(opt._replace(step=None)),
        _SCALARS: {
            "step": state.step,
            "opt_state": {"kind": type(opt).__name__, "step": opt.step,
                          "fields": [f for f, v in zip(opt._fields, opt)
                                     if v is not None and f != "step"]},
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
    snap = _snapshot(engine.state)
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
    return path


def wait_for_checkpoint(engine=None) -> None:
    """Join a pending ``async_save`` and commit it; a failed write raises
    here and leaves the previous ``latest`` standing."""
    _BACKGROUND.join()


def _load_flat(path: str) -> dict:
    return torch.load(path, map_location="cpu", mmap=True, weights_only=True)


def _copy_into(flat: dict, tree, what: str) -> None:
    """Copy each checkpoint leaf into the engine's tensor at its path; the
    two trees must hold the same paths, shapes and dtypes."""
    leaves = tree_leaves_with_path(tree)
    missing = sorted(set(flat) ^ {p for p, _ in leaves})
    if missing:
        raise ValueError(f"checkpoint {what} and the engine's differ in "
                         f"leaves {missing}")
    with torch.no_grad():
        for p, leaf in leaves:
            src = flat[p]
            if src.shape != leaf.shape or src.dtype != leaf.dtype:
                raise ValueError(
                    f"checkpoint {what} leaf {p!r} is {tuple(src.shape)} "
                    f"{src.dtype}, the engine's {tuple(leaf.shape)} "
                    f"{leaf.dtype}")
            leaf.copy_(src)


def load_checkpoint(engine, load_dir: str, tag: Optional[str] = None):
    """ref: DeepSpeedEngine.load_checkpoint -> (path, client_state), or
    (None, {}) when there is no ``latest`` and no tag.  Copies into the
    engine's existing tensors, whose device, dtypes and shapes stay."""
    wait_for_checkpoint(engine)          # join any pending async save
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
    _copy_into(_load_flat(os.path.join(state_dir, _PARAMS)), state.params,
               "params")
    _copy_into(_load_flat(os.path.join(state_dir, _OPT)),
               opt._replace(step=None), "optimizer state")
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
    Reads only the params file, memory-mapped.  Returns the dict written."""
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
            raise NotImplementedError(
                "the param-stream universal layout comes with the offload "
                "engines (ROADMAP A9)")
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
