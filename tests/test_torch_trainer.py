"""The port's HF ``Trainer`` bridge (``integrations/trainer.py``) against
the JAX package's, the cases of ``tests/test_hf_trainer.py``: the tiny e2e
(an HF checkpoint from ``save_pretrained`` -> ``Trainer`` with "auto"
values -> ``train`` -> ``save_model`` -> ``from_pretrained``), with the
same batches as the JAX Trainer's (both at world size 1, f32 compute:
losses rtol 1e-5; params rtol 1e-4 with atol 1e-2 of the lr per step, as
test_torch_distill.py holds them: Adam moves an element whose gradient is
near zero by its normalised step, so rounding-level gradient differences
between the frameworks shift such an element by a fraction of the lr; the
card-free run read 5.4e-5 after 6 steps at lr 3e-3),
the trained weights bit for bit in the saved file; a missing ``deepspeed``
config and an unresolvable "auto" raise; the JSON activation-checkpointing
block reaches the model's remat (the port keeps ``offload_attn``: it has
no CPU-mesh downgrade)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
from deepspeed_tpu.integrations import hf as jhf
from deepspeed_tpu.integrations import trainer as jtr
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.topology import MeshSpec
from deepspeed_tpu_torch import Trainer, TrainingArguments, from_pretrained
from deepspeed_tpu_torch._tree import tree_leaves
from deepspeed_tpu_torch.integrations import hf as thf
from deepspeed_tpu_torch.integrations import trainer as ttr

torch.set_num_threads(1)


def make_base_checkpoint(tmp_path):
    cfg = jl.LlamaConfig.tiny(dim=64, n_layers=2, n_heads=4, n_kv_heads=2)
    params = jl.init_params(jax.random.PRNGKey(0), cfg)
    base = str(tmp_path / "base")
    jhf.save_pretrained(jax.tree.map(np.asarray, params), cfg, base)
    return base, cfg


def ds_config_with_autos(stage=0, bf16=False):
    return {
        "train_micro_batch_size_per_gpu": "auto",
        "gradient_accumulation_steps": "auto",
        "gradient_clipping": "auto",
        "zero_optimization": {"stage": stage},
        "optimizer": {"type": "adamw", "params": {
            "lr": "auto", "betas": "auto", "eps": "auto",
            "weight_decay": "auto"}},
        "scheduler": {"type": "WarmupLR", "params": {
            "warmup_max_lr": "auto", "warmup_min_lr": "auto",
            "warmup_num_steps": "auto"}},
        "bf16": {"enabled": bf16},
    }


def make_dataset(cfg, n=64, T=33):
    rng = np.random.default_rng(1)
    return [{"input_ids": rng.integers(0, cfg.vocab_size, T).tolist()}
            for _ in range(n)]


@pytest.fixture
def world_of_one(monkeypatch):
    """The JAX Trainer at world size 1, as the port runs: one device in its
    batch arithmetic and its engine's mesh."""
    real = dstpu.initialize
    mesh = MeshSpec.build({"data": 1}, devices=jax.devices()[:1])
    monkeypatch.setattr(jax, "device_count", lambda *a: 1)
    monkeypatch.setattr(dstpu, "initialize",
                        lambda *a, **kw: real(*a, mesh=mesh, **kw))


def test_e2e_from_pretrained_train_save_matches_jax(world_of_one, tmp_path):
    base, cfg = make_base_checkpoint(tmp_path)
    kw = dict(per_device_train_batch_size=2, gradient_accumulation_steps=2,
              learning_rate=3e-3, max_steps=6, warmup_steps=2,
              logging_steps=3, weight_decay=0.01)
    targs = TrainingArguments(output_dir=str(tmp_path / "out"),
                              deepspeed=ds_config_with_autos(), **kw)
    jargs = jtr.TrainingArguments(output_dir=str(tmp_path / "jout"),
                                  deepspeed=ds_config_with_autos(), **kw)
    data = make_dataset(cfg)
    tr = Trainer(model_dir=base, args=targs, train_dataset=data,
                 device="cpu")
    jt = jtr.Trainer(model_dir=base, args=jargs, train_dataset=data)
    # "auto" resolution honoured the TrainingArguments, as in JAX
    c = tr.engine.config
    assert (c.train_micro_batch_size_per_gpu, c.gradient_accumulation_steps,
            c.gradient_clipping, c.optimizer.params["lr"],
            c.optimizer.params["betas"]) == (2, 2, 1.0, 3e-3, [0.9, 0.999])
    assert tr.num_update_steps == jt.num_update_steps == 6
    assert tr.engine.train_batch_size == jt.engine.train_batch_size == 4
    # the same batches, epoch by epoch
    for epoch in (0, 1):
        for a, b in zip(tr.get_train_dataloader(epoch),
                        jt.get_train_dataloader(epoch)):
            for k in ("tokens", "loss_mask"):
                np.testing.assert_array_equal(a[k], b[k])
    tlosses, jlosses = [], []
    for batch in itertools.islice(tr.get_train_dataloader(0), 6):
        tlosses.append(float(tr.engine.train_batch(batch)))
        jlosses.append(float(jt.engine.train_batch(batch)))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    for a, b in zip(tree_leaves(tr.engine.module_params()),
                    jax.tree.leaves(jt.engine.module_params())):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-2 * 3e-3 * len(tlosses))
    outdir = tr.save_model()
    assert outdir == str(tmp_path / "out")
    # the saved checkpoint loads back, holding the trained f32 weights bit
    # for bit, in the port and in JAX
    fn, p2, cfg2, _ = from_pretrained(outdir, dtype=torch.float32,
                                      device="cpu")
    for a, b in zip(tree_leaves(p2), tree_leaves(tr.engine.module_params())):
        assert torch.equal(a, b)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    logits = fn(p2, toks)
    assert logits.shape == (2, 16, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    _, jp2, _, _ = jhf.from_pretrained(outdir, dtype=jnp.float32)
    for a, b in zip(jax.tree.leaves(jp2),
                    tree_leaves(tr.engine.module_params())):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    base_sd, new_sd = thf.load_state_dict(base), thf.load_state_dict(outdir)
    w = "model.layers.0.self_attn.q_proj.weight"
    assert not torch.allclose(base_sd[w], new_sd[w])


def test_train_loop_matches_jax_trainer(world_of_one, tmp_path):
    base, cfg = make_base_checkpoint(tmp_path)
    kw = dict(per_device_train_batch_size=4, learning_rate=1e-3,
              max_steps=5, warmup_steps=1, logging_steps=0)
    data = make_dataset(cfg, n=16)
    tr = Trainer(model_dir=base, train_dataset=data, device="cpu",
                 args=TrainingArguments(deepspeed=ds_config_with_autos(),
                                        **kw))
    jt = jtr.Trainer(model_dir=base, train_dataset=data,
                     args=jtr.TrainingArguments(
                         deepspeed=ds_config_with_autos(), **kw))
    out, jout = tr.train(), jt.train()      # 4 steps an epoch: 2 epochs
    assert out["train_steps"] == jout["train_steps"] == 5
    for k in ("train_loss", "final_loss"):
        np.testing.assert_allclose(out[k], jout[k], rtol=1e-5)
    assert tr.engine.global_steps == 5
    path = tr.save_state(str(tmp_path / "state"))
    assert path is None or "ds_ckpt" in str(path)


def test_bf16_trains_and_requires_deepspeed_config(tmp_path):
    base, cfg = make_base_checkpoint(tmp_path)
    with pytest.raises(ValueError, match="deepspeed"):
        Trainer(model_dir=base, args=TrainingArguments(),
                train_dataset=make_dataset(cfg, n=8), device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        Trainer(args=TrainingArguments(deepspeed={}),
                train_dataset=make_dataset(cfg, n=8), device="cpu")
    tr = Trainer(model_dir=base, device="cpu",
                 args=TrainingArguments(deepspeed=ds_config_with_autos(
                     bf16=True), per_device_train_batch_size=2,
                     learning_rate=3e-3, max_steps=4),
                 train_dataset=make_dataset(cfg, n=16))
    out = tr.train()
    assert out["train_steps"] == 4 and np.isfinite(out["final_loss"])


def test_unresolvable_auto_raises(tmp_path):
    base, cfg = make_base_checkpoint(tmp_path)
    ds = ds_config_with_autos()
    ds["zero_optimization"]["stage"] = "auto"
    ds["steps_per_print"] = "auto"
    with pytest.raises(ValueError, match="auto"):
        Trainer(model_dir=base,
                args=TrainingArguments(deepspeed=ds, max_steps=2),
                train_dataset=make_dataset(cfg, n=8), device="cpu")
    # the resolver itself, against JAX's
    args = jtr.TrainingArguments(warmup_steps=3)
    ds = ds_config_with_autos()
    ds["scheduler"]["params"]["total_num_steps"] = "auto"
    assert ttr._resolve_auto(ds, args, 17) == jtr._resolve_auto(ds, args, 17)


def test_pad_batch_matches_jax():
    rows = [[1, 2, 3], [4] * 9, []]
    a, b = ttr._pad_batch(rows, 0, 6), jtr._pad_batch(rows, 0, 6)
    for k in ("tokens", "loss_mask"):
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype


def test_json_policy_reaches_model_remat(tmp_path):
    base, cfg = make_base_checkpoint(tmp_path)
    ds = ds_config_with_autos()
    ds["activation_checkpointing"] = {"enabled": True,
                                      "cpu_checkpointing": True}
    tr = Trainer(model_dir=base, device="cpu",
                 args=TrainingArguments(output_dir=str(tmp_path / "out"),
                                        deepspeed=ds,
                                        per_device_train_batch_size=1,
                                        learning_rate=1e-3, max_steps=2),
                 train_dataset=make_dataset(cfg))
    # cpu_checkpointing -> offload_attn, kept as it is (on a CPU tensor the
    # host move is the identity)
    assert tr.model_cfg.remat == "offload_attn"
    out = tr.train()
    assert np.isfinite(out["final_loss"])


def test_param_specs_raise_until_a9():
    from deepspeed_tpu_torch import initialize

    with pytest.raises(NotImplementedError, match="A9"):
        initialize(loss_fn=lambda p, b: p["w"].sum(),
                   params={"w": torch.zeros(2)}, config={},
                   param_specs={"w": None}, device="cpu")
