"""The port's activation checkpointing (``remat``) on the CPU, llama-tiny
f32 with packed segment ids: for every ported policy the loss and gradients
equal ``remat="none"`` in the port and JAX's under the same policy, at
test_torch_train.py's f32 tolerance (1e-4 relative, 1e-6 absolute on the
gradients); each policy really recomputes (the attention runs again in the
backward) and the dot policies keep the products (no ``aten.mm`` runs
again); unknown names raise.  The offload policies (``offload_attn``,
``offload_dots_no_batch``) give gradients bit-equal to their on-device
twins' (``save_attn``, ``save_dots_no_batch``) on llama-tiny and
gpt2-tiny, move exactly the tensors the twin keeps (counted, with their
bytes), and every named stage output is moved."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deepspeed_tpu import remat as jremat
from deepspeed_tpu.models import gpt2 as jg
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu_torch import remat as tremat
from deepspeed_tpu_torch._tree import tree_leaves_with_path
from deepspeed_tpu_torch.models import gpt2 as tg
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

PORTED = ["full", "save_dots", "save_dots_no_batch", "save_attn"]


@pytest.fixture(scope="module")
def model():
    cfg = jl.LlamaConfig.tiny()
    jp = jax.device_get(jl.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(5)
    B, T = 2, 17
    seg = np.ones((B, T), np.int32)
    seg[0, 7:] = 2
    seg[1, T - 3:] = 0
    batch = {"tokens": rng.integers(0, 256, (B, T)).astype(np.int32),
             "segment_ids": seg}
    return cfg, jp, batch


def _torch_grads(jp, batch, remat):
    tp = from_jax_params(jp, device="cpu")
    for leaf in jax.tree.leaves(tp):
        leaf.requires_grad_(True)
    loss = tl.loss_fn(tl.LlamaConfig.tiny(remat=remat))(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return loss.item(), {p: t.grad for p, t in tree_leaves_with_path(tp)}


def _jax_grads(cfg, jp, batch, remat):
    loss, grads = jax.value_and_grad(jl.loss_fn(
        dataclasses.replace(cfg, remat=remat)))(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, batch))
    return float(loss), {
        "/".join(str(k.key) for k in path): np.asarray(g)
        for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}


@pytest.mark.parametrize("remat", PORTED)
def test_grads_equal_no_remat_and_jax(model, remat):
    cfg, jp, batch = model
    base_loss, base = _torch_grads(jp, batch, "none")
    loss, got = _torch_grads(jp, batch, remat)
    jloss, want = _jax_grads(cfg, jp, batch, remat)
    assert got.keys() == base.keys() == want.keys()
    np.testing.assert_allclose(loss, base_loss, rtol=1e-4)
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    for path, g in got.items():
        np.testing.assert_allclose(g.numpy(), base[path].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=path)
        np.testing.assert_allclose(g.numpy(), want[path], rtol=1e-4,
                                   atol=1e-6, err_msg=path)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat", ["none"] + PORTED + list(tremat.OFFLOAD))
def test_policies_recompute_what_they_do_not_keep(model, remat, monkeypatch):
    """Attention runs once per layer without remat and again in the
    backward under every policy; the backward's ``aten.mm`` count grows by
    the forward's recomputed products under ``full`` and ``save_attn``, and
    not under the dot policies, which keep them."""
    _, jp, batch = model
    calls = []
    attention = tl._attention
    monkeypatch.setattr(tl, "_attention",
                        lambda *a, **k: calls.append(1) or attention(*a, **k))
    tp = from_jax_params(jp, device="cpu")
    for leaf in jax.tree.leaves(tp):
        leaf.requires_grad_(True)
    cfg = tl.LlamaConfig.tiny(remat=remat)
    loss = tl.loss_fn(cfg)(tp, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    assert len(calls) == cfg.n_layers
    with _CountMM() as count:
        loss.backward()
    assert len(calls) == cfg.n_layers * (1 if remat == "none" else 2)
    # per layer: 7 weight products in the forward (wq, wk, wv, wo, w1, w3,
    # w2), two gradient products each in the backward; ``full`` runs the
    # block again up to the last tensor its backward needs (6 products:
    # w2's output is saved by nothing), ``save_attn`` its two stages (wq,
    # wk, wv; w1, w3)
    per_layer = {"none": 14, "save_dots": 14, "save_dots_no_batch": 14,
                 "full": 20, "save_attn": 19}[tremat.OFFLOAD.get(remat,
                                                                remat)]
    head = 2                        # the LM head's two backward products
    assert count.mm == cfg.n_layers * per_layer + head, count.mm


@pytest.mark.parametrize("name", ["offload_attn", "offload_dots_no_batch"])
def test_offload_policies_raise(name):
    """The offload policies no longer raise ``NotImplementedError``: they
    are policies of their own, named beside their on-device twins."""
    assert tremat.check(name) == name
    assert tl.LlamaConfig.tiny(remat=name).remat == name
    assert tg.GPT2Config.tiny(remat=name).remat == name
    assert callable(tremat.checkpoint_block(lambda x: x, name))
    assert tremat.OFFLOAD[name] in tremat.POLICIES
    assert (tremat.policy(name) is None) == (name == "offload_attn")


# (family, config, loss function, batch) for the offload tests: llama-tiny
# with packed segments, and gpt2-tiny
def _families(batch):
    gcfg = jg.GPT2Config.tiny()
    gp = jax.device_get(jg.init_params(jax.random.PRNGKey(1), gcfg))
    return {"llama": (tl.LlamaConfig.tiny, tl.loss_fn, batch),
            "gpt2": (tg.GPT2Config.tiny, tg.loss_fn,
                     {"tokens": batch["tokens"]}, gp)}


def _family_grads(family, model, remat):
    _, jp, batch = model
    make, loss_fn, b, *params = _families(batch)[family]
    tp = from_jax_params(params[0] if params else jp, device="cpu")
    for leaf in jax.tree.leaves(tp):
        leaf.requires_grad_(True)
    tremat.offload.reset()
    loss = loss_fn(make(remat=remat))(tp, {k: torch.from_numpy(v)
                                           for k, v in b.items()})
    moved = (tremat.offload.tensors, tremat.offload.bytes)
    loss.backward()
    return loss.item(), {p: t.grad for p, t in tree_leaves_with_path(tp)}, \
        moved


@pytest.mark.parametrize("family", ["llama", "gpt2"])
@pytest.mark.parametrize("name", ["offload_attn", "offload_dots_no_batch"])
def test_offload_gradients_bit_equal_to_the_twin(model, family, name):
    twin = tremat.OFFLOAD[name]
    loss, got, moved = _family_grads(family, model, name)
    tloss, want, tmoved = _family_grads(family, model, twin)
    assert loss == tloss and got.keys() == want.keys()
    for path, g in got.items():
        assert torch.equal(g, want[path]), path
    assert tmoved == (0, 0) and moved[0] > 0


def _kept(family, name, B, T):
    """The tensors the twin keeps per layer, as (count, elements): the two
    named stage outputs, or the outputs of every 2-D weight product."""
    if family == "llama":
        c = tl.LlamaConfig.tiny()
        d, f, kvd = c.dim, c.ffn_dim, c.n_kv_heads * c.head_dim
        dots = [d, kvd, kvd, d, f, f, d]          # wq wk wv wo w1 w3 w2
        named = [c.n_heads * c.head_dim, f]
    else:
        c = tg.GPT2Config.tiny()
        d = c.dim
        dots = [3 * d, d, 4 * d, d]               # qkv proj fc out
        named = [d, 4 * d]
    widths = named if name == "offload_attn" else dots
    return c.n_layers * len(widths), c.n_layers * B * T * sum(widths)


@pytest.mark.parametrize("family", ["llama", "gpt2"])
@pytest.mark.parametrize("name", ["offload_attn", "offload_dots_no_batch"])
def test_offload_moves_exactly_what_the_twin_keeps(model, family, name):
    _, _, batch = model
    B, T = batch["tokens"].shape
    _, _, moved = _family_grads(family, model, name)
    count, elements = _kept(family, name, B, T - 1)
    assert moved == (count, 4 * elements)         # f32


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_every_named_stage_output_is_moved(model, family, monkeypatch):
    """Each tensor ``checkpoint_named`` marks under ``offload_attn`` is
    saved for the backward through the offload hook, once, and nothing
    else is: no saved tensor of the named set stays where it was."""
    named, packed = [], []
    mark, pack = tremat.offload.name, tremat.offload.pack
    monkeypatch.setattr(tremat.offload, "name", lambda out: named.append(
        out.untyped_storage().data_ptr()) or mark(out))
    monkeypatch.setattr(tremat.offload, "pack", lambda t: packed.append(
        t.untyped_storage().data_ptr()) or pack(t))
    _family_grads(family, model, "offload_attn")
    layers = tl.LlamaConfig.tiny().n_layers if family == "llama" \
        else tg.GPT2Config.tiny().n_layers
    assert len(named) == 2 * layers
    assert sorted(packed) == sorted(named)


def test_unknown_policy_raises_value_error_as_jax():
    with pytest.raises(ValueError, match="unknown remat policy"):
        jremat.policy("bogus")
    with pytest.raises(ValueError, match="unknown remat policy"):
        tl.LlamaConfig.tiny(remat="bogus")
    assert tremat.POLICIES == ("none", "full", "save_dots",
                               "save_dots_no_batch", "save_attn")
    assert tremat.policy("full") is None and tremat.policy("none") is None
    assert tremat.policy("save_dots") is not None
