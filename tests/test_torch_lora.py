"""LoRA in the port (``deepspeed_tpu_torch/lora.py``) against the JAX
package's ``lora.py`` on a tiny f32 Llama: the init starts at the base, no
match raises, ``apply_lora`` / ``merge_lora`` equal JAX's on adapters
bridged from the JAX arrays (A cannot be drawn alike: threefry has no
torch twin), three engine steps' losses and adapters equal the JAX
engine's at the training tolerances (losses rtol 1e-5, adapters rtol 1e-4 /
atol 1e-6), the base is untouched, ``count_trainable`` is equal; the dotted
adapter keys keep apart from nested ones through the tree walk and a
checkpoint; the chunked loss's backward forms no ``dhead`` for a frozen
head and leaves ``dx`` as it was."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
from deepspeed_tpu import lora as jlora
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.topology import MeshSpec
from deepspeed_tpu.utils.trees import leaf_path
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch import lora as tlora
from deepspeed_tpu_torch._tree import (tree_leaves, tree_leaves_with_path,
                                       tree_map)
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.ops import losses as tloss
from deepspeed_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def base():
    cfg = jl.LlamaConfig.tiny()
    jp = jax.device_get(jl.init_params(jax.random.PRNGKey(0), cfg))
    return cfg, tl.LlamaConfig.tiny(), jp


def _cfgs(**kw):
    return jlora.LoRAConfig(**kw), tlora.LoRAConfig(**kw)


def _bridged(jp, jcfg, seed=0, b_scale=0.1):
    """JAX adapters with a nonzero B (numpy), and the same in torch."""
    ad = jax.device_get(jlora.init_lora(jax.random.PRNGKey(1), jp, jcfg))
    rng = np.random.default_rng(seed)
    ad = {k: {"A": v["A"], "B": (rng.standard_normal(v["B"].shape)
                                 * b_scale).astype(np.float32)}
          for k, v in ad.items()}
    return ad, from_jax_params(ad, device="cpu")


def test_defaults_match_jax():
    j, t = jlora.LoRAConfig(), tlora.LoRAConfig()
    assert (t.lora_r, t.lora_alpha, tuple(t.target_modules), t.scale) == \
        (j.lora_r, j.lora_alpha, tuple(j.target_modules), j.scale) == \
        (8, 32, ("wq", "wk", "wv", "wo"), 4.0)
    for path in ("blocks.wq", "wq", "blocks.w1", "x.blocks.wo"):
        assert t.matches(path) == j.matches(path)


def test_init_starts_at_base(base):
    _, tcfg, jp = base
    params = from_jax_params(jp, device="cpu")
    lcfg = tlora.LoRAConfig(lora_r=4, target_modules=("wq", "wv"))
    ad = tlora.init_lora(torch.Generator().manual_seed(1), params, lcfg)
    assert set(ad) == {"blocks.wq", "blocks.wv"}
    assert ad["blocks.wq"]["A"].shape == (tcfg.n_layers, tcfg.dim, 4)
    assert ad["blocks.wq"]["B"].shape == (tcfg.n_layers, 4, tcfg.dim)
    assert all(not torch.any(a["B"]) for a in ad.values())
    # A ~ N(0, 1) / r
    a = torch.cat([v["A"].reshape(-1) for v in ad.values()])
    assert abs(a.std().item() * 4 - 1) < 0.05 and abs(a.mean().item()) < 0.02
    eff = tlora.apply_lora(params, ad, lcfg)
    for x, y in zip(tree_leaves(eff), tree_leaves(params)):
        assert torch.equal(x, y)
    again = tlora.init_lora(torch.Generator().manual_seed(1), params, lcfg)
    assert torch.equal(again["blocks.wv"]["A"], ad["blocks.wv"]["A"])


def test_no_match_raises(base):
    _, _, jp = base
    with pytest.raises(ValueError, match="target_modules"):
        tlora.init_lora(torch.Generator(), from_jax_params(jp, device="cpu"),
                        tlora.LoRAConfig(target_modules=("nope",)))


@pytest.mark.parametrize("targets", [("wq", "wk", "wv", "wo"),
                                     ("blocks.w1", "wo", "embed")])
def test_apply_and_merge_match_jax(base, targets):
    _, _, jp = base
    jcfg, tcfg = _cfgs(lora_r=4, lora_alpha=8, target_modules=targets)
    jad, tad = _bridged(jp, jcfg)
    want = jlora.merge_lora(jax.tree.map(jnp.asarray, jp), jad, jcfg)
    got = tlora.merge_lora(from_jax_params(jp, device="cpu"), tad, tcfg)
    jleaves = jax.tree_util.tree_flatten_with_path(want)[0]
    for (kp, a), (path, b) in zip(jleaves,
                                  tree_leaves_with_path(got, ".")):
        assert leaf_path(kp) == path
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7, err_msg=path)
    applied = tlora.apply_lora(from_jax_params(jp, device="cpu"), tad, tcfg)
    for a, b in zip(tree_leaves(applied), tree_leaves(got)):
        assert torch.equal(a, b)


def test_count_trainable_matches_jax(base):
    _, _, jp = base
    jcfg, tcfg = _cfgs()
    jad, tad = _bridged(jp, jcfg)
    assert tlora.count_trainable(tad) == jlora.count_trainable(
        jax.tree.map(jnp.asarray, jad))


def test_leaf_path_spelling_matches_jax():
    import collections

    NT = collections.namedtuple("NT", ["mu", "nu"])
    tree = {"b": [np.zeros(1), {"z": np.zeros(1), "a": np.zeros(1)}],
            "a": NT(np.zeros(1), np.zeros(1)), "blocks.wq": {"A": 1.0}}
    want = [leaf_path(kp) for kp, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]
    got = [p for p, _ in tree_leaves_with_path(tree, ".")]
    assert got == want


def _config(**over):
    conf = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
            "bf16": {"enabled": False}, "gradient_clipping": 1.0,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 5e-3, "weight_decay": 0.01}}}
    conf.update(over)
    return conf


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, (4, 17)).astype(np.int32),
            "loss_mask": (rng.random((4, 17)) > 0.2).astype(np.int32)}


@pytest.mark.parametrize("loss_chunk", [0, 96])
def test_engine_steps_match_jax(base, loss_chunk):
    cfg, tcfg, jp = base
    cfg = dataclasses.replace(cfg, loss_chunk=loss_chunk)
    tcfg = dataclasses.replace(tcfg, loss_chunk=loss_chunk)
    jcfg, lcfg = _cfgs(lora_r=4, lora_alpha=8)
    jad = jax.device_get(jlora.init_lora(jax.random.PRNGKey(1), jp, jcfg))
    mesh = MeshSpec.build({"data": 1}, devices=jax.devices()[:1])
    je, _, _, _ = dstpu.initialize(
        loss_fn=jlora.lora_loss_fn(jl.loss_fn(cfg),
                                   jax.tree.map(jnp.asarray, jp), jcfg,
                                   compute_dtype=jnp.float32),
        params=jax.tree.map(jnp.asarray, jad), config=_config(), mesh=mesh)
    tbase = from_jax_params(jp, device="cpu")
    te, _, _, _ = initialize(
        loss_fn=tlora.lora_loss_fn(tl.loss_fn(tcfg), tbase, lcfg,
                                   compute_dtype=torch.float32,
                                   device="cpu"),
        params=from_jax_params(jad, device="cpu"), config=_config(),
        device="cpu")
    # the engine trains the adapter tree alone: its state is adapter-sized
    assert sorted(te.module_params()) == sorted(jad)
    n_ad, _ = tlora.count_trainable(te.module_params())
    assert sum(l.numel() for l in tree_leaves(te.state.opt_state[1:])) \
        == 2 * n_ad
    jlosses, tlosses = [], []
    for step in range(3):
        b = _batch(step)
        jlosses.append(float(je.train_batch(b)))
        tlosses.append(float(te.train_batch(b)))
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    # step 1 starts at the base (B = 0): the base model's own loss, over
    # the engine's two microbatches
    b0 = tree_map(torch.from_numpy, _batch(0))
    plain = sum(tl.loss_fn(tcfg)(tbase, tree_map(lambda x: x[i:i + 2], b0))
                for i in (0, 2)) / 2
    np.testing.assert_allclose(tlosses[0], plain.item(), rtol=LOSS_RTOL)
    jflat = jax.tree_util.tree_flatten_with_path(je.module_params())[0]
    for (kp, a), (path, b) in zip(jflat, tree_leaves_with_path(
            te.module_params(), ".")):
        assert leaf_path(kp) == path
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **PARAM_TOL,
                                   err_msg=path)
    assert any(torch.any(v["B"] != 0) for v in te.module_params().values())
    for a, b in zip(tree_leaves(tbase), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), b)     # base untouched


def test_dotted_keys_stay_apart_through_a_checkpoint(base, tmp_path):
    _, tcfg, jp = base
    lcfg = tlora.LoRAConfig(lora_r=2, target_modules=("wq",))
    params = from_jax_params(jp, device="cpu")
    ad = tlora.init_lora(torch.Generator().manual_seed(0), params, lcfg)
    mixed = {"blocks.wq": ad["blocks.wq"],
             "blocks": {"wq": {"A": torch.ones(3), "B": torch.zeros(2)}}}
    paths = [p for p, _ in tree_leaves_with_path(mixed)]
    assert paths == ["blocks/wq/A", "blocks/wq/B", "blocks.wq/A",
                     "blocks.wq/B"]
    loss = tlora.lora_loss_fn(tl.loss_fn(tcfg), params, lcfg,
                              compute_dtype=torch.float32, device="cpu")
    conf = _config()
    te, _, _, _ = initialize(loss_fn=loss, params=ad, config=dict(conf),
                             device="cpu")
    te.train_batch(_batch(5))
    te.save_checkpoint(str(tmp_path))
    te2, _, _, _ = initialize(loss_fn=loss, params=ad, config=dict(conf),
                              device="cpu")
    te2.load_checkpoint(str(tmp_path))
    for a, b in zip(tree_leaves(te2.state), tree_leaves(te.state)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    np.testing.assert_allclose(float(te2.train_batch(_batch(6))),
                               float(te.train_batch(_batch(6))),
                               rtol=0, atol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_loss_skips_dhead_for_a_frozen_head(masked):
    rng = np.random.default_rng(3)
    N, D, V = 20, 16, 200
    x = rng.standard_normal((N, D)).astype(np.float32)
    head = (rng.standard_normal((D, V)) / 4).astype(np.float32)
    tgt = torch.from_numpy(rng.integers(0, V, N).astype(np.int64))
    mask = torch.from_numpy((rng.random(N) > 0.3).astype(np.float32)) \
        if masked else None
    dx = {}
    for frozen in (False, True):
        tx = torch.from_numpy(x).requires_grad_(True)
        th = torch.from_numpy(head).requires_grad_(not frozen)
        tloss.chunked_lm_loss(tx, th, tgt, mask=mask, chunk=64).backward()
        dx[frozen] = tx.grad
        assert (th.grad is None) == frozen
    assert torch.equal(dx[True], dx[False])
