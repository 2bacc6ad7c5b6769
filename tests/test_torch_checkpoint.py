"""The port's checkpoints on the CPU, llama-tiny f32: save -> load ->
continue equals an uninterrupted port run step for step, bit for bit
(sync and async saves, AdamW, ``fused_adam`` and the fp16 loss scaler);
``latest`` and missing-tag behaviour as the JAX package's; an async save
snapshots the state before training moves on, and a failed one leaves the
previous ``latest`` standing; ``zero_to_fp32`` on a JAX train state bridged
by ``from_jax_train_state`` equals the JAX one's on the JAX checkpoint, key
for key and bit for bit; and a JAX run of 2 steps bridged and continued 2
steps in the port matches JAX's 4 steps at test_torch_train.py's f32
tolerance (losses 1e-4 relative, params 1e-3 relative / 1e-4 absolute)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
from deepspeed_tpu import checkpoint as jckpt
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.topology import MeshSpec
from deepspeed_tpu_torch import checkpoint as tckpt
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch._tree import tree_leaves, tree_leaves_with_path
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.ops import adam_cuda as tadam
from deepspeed_tpu_torch.ops.optim import AdamState
from deepspeed_tpu_torch.weights import from_jax_params, from_jax_train_state

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model():
    cfg = jl.LlamaConfig.tiny()
    jp = jax.device_get(jl.init_params(jax.random.PRNGKey(0), cfg))
    return cfg, jp


def _batch(seed, B=4, T=17):
    rng = np.random.default_rng(seed)
    seg = np.ones((B, T), np.int32)
    for b in range(B):
        seg[b, rng.integers(3, T - 3):] = 2
        seg[b, T - 1 - b:] = 0
    return {"tokens": rng.integers(0, 256, (B, T)).astype(np.int32),
            "segment_ids": seg}


BATCHES = [_batch(300 + i) for i in range(4)]


def _config(**over):
    conf = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
            "gradient_clipping": 1.0, "bf16": {"enabled": False},
            "optimizer": {"type": "adamw",
                          "params": {"lr": 3e-3, "weight_decay": 0.1}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_min_lr": 0.0,
                                     "warmup_max_lr": 3e-3,
                                     "warmup_num_steps": 3}}}
    conf.update(over)
    return conf


OPTS = {
    "adamw": (_config(), None),
    "fused_adam": (_config(), lambda: tadam.fused_adam(lr=1e-3,
                                                       weight_decay=0.1)),
    "fp16": (_config(fp16={"enabled": True, "initial_scale_power": 18,
                           "loss_scale_window": 2}), None),
}


def _engine(jp, name):
    conf, opt = OPTS[name]
    eng, _, _, _ = initialize(loss_fn=tl.loss_fn(tl.LlamaConfig.tiny()),
                              params=from_jax_params(jp, device="cpu"),
                              config=dict(conf),
                              optimizer=opt() if opt else None,
                              device="cpu")
    return eng


def _assert_same_state(a, b):
    assert a.step == b.step and type(a.step) is int
    assert a.scaler == b.scaler
    assert type(a.opt_state) is type(b.opt_state)
    assert a.opt_state.step == b.opt_state.step
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if torch.is_tensor(x):
            assert torch.equal(x, y)


@pytest.mark.parametrize("opt", OPTS)
@pytest.mark.parametrize("async_save", [False, True])
def test_resume_equals_uninterrupted_bitwise(model, tmp_path, opt,
                                             async_save):
    _, jp = model
    ref = _engine(jp, opt)
    want = [float(ref.train_batch(b)) for b in BATCHES]
    first = _engine(jp, opt)
    got = [float(first.train_batch(b)) for b in BATCHES[:2]]
    path = first.save_checkpoint(str(tmp_path), client_state={"epoch": 7},
                                 async_save=async_save)
    first.wait_for_checkpoint()
    del first
    resumed = _engine(jp, opt)
    p, client = resumed.load_checkpoint(str(tmp_path))
    assert p == path and client == {"epoch": 7}
    assert resumed.global_steps == 2
    got += [float(resumed.train_batch(b)) for b in BATCHES[2:]]
    assert got == want
    _assert_same_state(resumed.state, ref.state)
    assert resumed.skipped_steps == ref.skipped_steps


def test_latest_tag_and_missing_as_jax(model, tmp_path):
    _, jp = model
    eng = _engine(jp, "adamw")
    assert eng.load_checkpoint(str(tmp_path)) == (None, {})
    assert jckpt._resolve_tag(str(tmp_path), None, required=False) is None
    with pytest.raises(FileNotFoundError):
        tckpt._resolve_tag(str(tmp_path), None, required=True)
    with pytest.raises(FileNotFoundError):
        jckpt._resolve_tag(str(tmp_path), None, required=True)
    with pytest.raises(FileNotFoundError):
        tckpt.zero_to_fp32(str(tmp_path), str(tmp_path / "o.npz"))
    eng.train_batch(BATCHES[0])
    eng.save_checkpoint(str(tmp_path))           # tag = global_step1
    eng.train_batch(BATCHES[1])
    eng.save_checkpoint(str(tmp_path))           # tag = global_step2
    assert (tmp_path / "latest").read_text() == "global_step2"
    for tag in (None, "global_step1", "t9"):
        assert (tckpt._resolve_tag(str(tmp_path), tag, required=True)
                == jckpt._resolve_tag(str(tmp_path), tag, required=True))
    fresh = _engine(jp, "adamw")
    path, _ = fresh.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step2") and fresh.global_steps == 2
    path, _ = fresh.load_checkpoint(str(tmp_path), tag="global_step1")
    assert path.endswith("global_step1") and fresh.global_steps == 1
    with pytest.raises(FileNotFoundError):
        fresh.load_checkpoint(str(tmp_path), tag="missing")
    # a checkpoint of another optimizer kind does not load
    other = _engine(jp, "fused_adam")
    with pytest.raises(ValueError, match="AdamState"):
        other.load_checkpoint(str(tmp_path))


def test_async_save_snapshots_before_training_moves_on(model, tmp_path):
    _, jp = model
    eng = _engine(jp, "adamw")
    eng.train_batch(BATCHES[0])
    eng.save_checkpoint(str(tmp_path), tag="a1", async_save=True)
    snap = [t.clone() for t in tree_leaves(eng.state.params)]
    for b in BATCHES[1:]:
        eng.train_batch(b)
    assert not all(torch.equal(a, b) for a, b in
                   zip(snap, tree_leaves(eng.state.params)))
    other = _engine(jp, "adamw")        # another engine's load joins it
    path, _ = other.load_checkpoint(str(tmp_path))
    assert path.endswith("a1") and other.global_steps == 1
    assert (tmp_path / "latest").read_text() == "a1"
    for a, b in zip(snap, tree_leaves(other.state.params)):
        assert torch.equal(a, b)


def test_successive_async_saves_all_finalize(model, tmp_path):
    _, jp = model
    eng = _engine(jp, "adamw")
    for i in range(3):
        eng.train_batch(BATCHES[i])
        eng.save_checkpoint(str(tmp_path), tag=f"t{i}", async_save=True)
    eng.wait_for_checkpoint()
    for i in range(3):
        assert (tmp_path / f"t{i}" / "meta.json").exists(), i
    assert (tmp_path / "latest").read_text() == "t2"


def test_failed_async_write_leaves_previous_latest(model, tmp_path,
                                                   monkeypatch):
    _, jp = model
    eng = _engine(jp, "adamw")
    eng.train_batch(BATCHES[0])
    eng.save_checkpoint(str(tmp_path), tag="good")

    def broken(path, write):
        raise OSError("disk full")

    monkeypatch.setattr(tckpt, "_write_file", broken)
    eng.train_batch(BATCHES[1])
    eng.save_checkpoint(str(tmp_path), tag="bad", async_save=True)
    with pytest.raises(OSError, match="disk full"):
        eng.wait_for_checkpoint()
    monkeypatch.undo()
    eng.wait_for_checkpoint()                  # nothing pending any more
    assert (tmp_path / "latest").read_text() == "good"
    assert not (tmp_path / "bad" / "meta.json").exists()
    fresh = _engine(jp, "adamw")
    path, _ = fresh.load_checkpoint(str(tmp_path))
    assert path.endswith("good") and fresh.global_steps == 1


def _jax_engine(cfg, jp):
    mesh = MeshSpec.build({"data": 1}, devices=jax.devices()[:1])
    eng, _, _, _ = dstpu.initialize(
        loss_fn=jl.loss_fn(cfg), params=jax.tree.map(jnp.asarray, jp),
        config=_config(), mesh=mesh)
    return eng


def test_bridged_state_and_zero_to_fp32_match_jax(model, tmp_path):
    cfg, jp = model
    je = _jax_engine(cfg, jp)
    for b in BATCHES[:2]:
        je.train_batch(b)
    je.save_checkpoint(str(tmp_path / "jax"), tag="s2")
    jckpt.zero_to_fp32(str(tmp_path / "jax"), str(tmp_path / "jax.npz"))
    state = from_jax_train_state(jax.device_get(je.state), device="cpu")
    assert type(state.step) is int and state.step == 2
    assert isinstance(state.opt_state, AdamState)
    assert type(state.opt_state.step) is int
    assert type(state.scaler.scale) is float
    assert type(state.scaler.good_steps) is int
    te = _engine(jp, "adamw")
    te.state, te.global_steps = state, 2
    te.save_checkpoint(str(tmp_path / "port"), tag="s2")
    tckpt.main([str(tmp_path / "port"), str(tmp_path / "port.npz")])
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(got.files) == sorted(want.files)
    assert "blocks/wq" in got.files
    for k in want.files:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the in-process consolidation holds the same values
    flat = dict(tree_leaves_with_path(tckpt.consolidate_to_fp32(te)))
    for k in want.files:
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)


def test_zero_to_fp32_rejects_qwz(model, tmp_path):
    _, jp = model
    eng = _engine(jp, "adamw")
    eng.save_checkpoint(str(tmp_path), tag="q")
    meta_path = tmp_path / "q" / "meta.json"
    meta = json.loads(meta_path.read_text())
    meta["config"]["zero_optimization"] = {"stage": 3,
                                           "zero_quantized_weights": True}
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="qwZ"):
        tckpt.zero_to_fp32(str(tmp_path), str(tmp_path / "o.npz"), tag="q")


def test_jax_run_continued_in_the_port_matches_jax(model):
    cfg, jp = model
    je = _jax_engine(cfg, jp)
    want = [float(je.train_batch(b)) for b in BATCHES]
    half = _jax_engine(cfg, jp)
    got = [float(half.train_batch(b)) for b in BATCHES[:2]]
    te = _engine(jp, "adamw")
    te.state = from_jax_train_state(jax.device_get(half.state), device="cpu")
    te.global_steps = 2
    got += [float(te.train_batch(b)) for b in BATCHES[2:]]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert te.state.step == int(je.state.step) == 4
    for a, b in zip(tree_leaves(te.module_params()),
                    jax.tree.leaves(je.module_params())):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-4)
