"""The port's layer-streaming engine (``param_stream.ParamStreamEngine``)
against the JAX package's on the CPU: the same tiny bf16 Llama (dim 64, 3
layers, 4/2 heads) from bridged weights, the same numpy-seeded batches,
both on the RAM tier (the JAX one on a one-device mesh).  Trajectories over
3 steps: losses within 2e-3 relative (bf16 forwards of two frameworks) and
the masters' updates within 20 % of their norm (Adam moves a parameter by
about lr whatever its grad's size, so a grad near 0 may step either way; the
port's updates correlate with JAX's at 0.997 here).  The lazy Llama
builder's blocks, stem and head equal JAX's bit for bit; the layered
Mixtral with per-layer aux losses tracks JAX's within 5e-3 (JAX's tolerance
for it against its fused step), its updates within 50 %; ``zero_to_fp32`` of
a
param-stream checkpoint writes JAX's ``.npz`` names and values.  Within the
port, bit for bit: the NVMe tier against the RAM tier (losses, masters, and
a RAM-tier save loaded on NVMe), strict against overlap mode, the lazy
against the eager init.  No test here builds the JAX NVMe tier."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
from deepspeed_tpu import checkpoint as jckpt
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.models import mixtral as jm
from deepspeed_tpu.topology import MeshSpec
from deepspeed_tpu_torch import checkpoint as tckpt
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch._tree import tree_leaves
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.models import mixtral as tm
from deepspeed_tpu_torch.param_stream import ParamStreamEngine
from deepspeed_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
CFG = dict(dim=64, n_layers=3, n_heads=4, n_kv_heads=2)
LOSS_RTOL = 2e-3
# the MoE's: XLA fuses bf16 chains that torch rounds op by op, and the
# capacity gate turns such differences into other routings (JAX's own test
# holds its layered Mixtral to its fused step at 5e-3)
MOE_LOSS_RTOL = 5e-3
UPDATE_RTOL = 0.2
MOE_UPDATE_RTOL = 0.5


@pytest.fixture(scope="module")
def model():
    cfg = jl.LlamaConfig.tiny(**CFG)
    jp = jax.device_get(jl.init_params(jax.random.PRNGKey(0), cfg))
    return cfg, tl.LlamaConfig.tiny(**CFG), jp


def _conf(accum=1, tier=None, **over):
    off = tier or {"device": "cpu", "scheduled": True}
    conf = {"train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": accum,
            "zero_optimization": {"stage": 3, "offload_param": off},
            "optimizer": {"type": "adamw",
                          "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "bf16": {"enabled": True}}
    conf.update(over)
    return conf


def _jax(layered, conf):
    mesh = MeshSpec.build({"data": 1}, devices=jax.devices()[:1])
    return dstpu.initialize(params=layered, config=conf, mesh=mesh)[0]


def _torch(layered, conf):
    return initialize(params=layered, config=conf, device="cpu")[0]


def _tokens(rows, seed=0, T=33, vocab=256):
    return np.random.default_rng(seed).integers(
        0, vocab, (rows, T)).astype(np.int32)


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _check_masters(jmaster, tmaster, init, rtol=UPDATE_RTOL):
    """Each master leaf's update since ``init`` against JAX's."""
    for path, a in jax.tree_util.tree_flatten_with_path(jmaster)[0]:
        b = _leaf(tmaster, path).numpy()
        w0 = np.asarray(_leaf(init, path), np.float32)
        dj, dt = np.asarray(a) - w0, b - w0
        assert np.linalg.norm(dt - dj) <= rtol * np.linalg.norm(dj), \
            jax.tree_util.keystr(path)


CURRICULUM = {"enabled": True, "curriculum_type": "seqlen",
              "min_difficulty": 16, "max_difficulty": 33,
              "schedule_config": {"total_curriculum_step": 2,
                                  "difficulty_step": 16}}


@pytest.mark.parametrize("case", ["overlap", "accum2", "clip_strict",
                                  "curriculum"])
def test_trajectory_matches_jax(model, case):
    cfg, tcfg, jp = model
    accum = 2 if case == "accum2" else 1
    over = {}
    if case == "clip_strict":
        over["gradient_clipping"] = 0.5      # forces the strict path
    if case == "curriculum":
        over["curriculum_learning"] = CURRICULUM
    je = _jax(jl.layered_model(cfg, jax.tree.map(jnp.asarray, jp)),
              _conf(accum, **over))
    te = _torch(tl.layered_model(tcfg, from_jax_params(jp, device="cpu")),
                _conf(accum, **over))
    assert isinstance(te, ParamStreamEngine)
    assert te.overlap_step == je.overlap_step == (case != "clip_strict")
    toks = _tokens(2 * accum)
    jls, tls, jn, tn = [], [], [], []
    for _ in range(3):
        jls.append(float(je.train_batch({"tokens": jnp.asarray(toks)})))
        tls.append(float(te.train_batch({"tokens": toks})))
        jn.append(je.get_global_grad_norm())
        tn.append(te.get_global_grad_norm())
    np.testing.assert_allclose(tls, jls, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tn, jn, rtol=1e-2)
    assert tls[-1] < tls[0]
    assert te.global_steps == je.global_steps == 3
    assert te.get_lr() == pytest.approx(je.get_lr(), rel=1e-6)
    if case == "curriculum":
        assert te.curriculum_difficulty() == je.curriculum_difficulty() == 32
    _check_masters(je.master_params(), te.master_params(), jp)
    rep = te.phase_report()
    assert set(rep) == set(je.phase_report())
    assert rep["fwd_compute"] > 0 and rep["host_adam"] > 0


def test_strict_matches_overlap_and_nvme_matches_ram(model, tmp_path):
    _, tcfg, jp = model
    tp = from_jax_params(jp, device="cpu")
    runs = {}
    for name, tier in (
            ("overlap", None),
            ("strict", {"device": "cpu", "scheduled": True,
                        "overlap_step": False}),
            ("nvme", {"device": "nvme", "nvme_path": str(tmp_path)})):
        eng = _torch(tl.layered_model(tcfg, tp), _conf(2, tier))
        toks = _tokens(4, seed=1)
        losses = [float(eng.train_batch({"tokens": toks})) for _ in range(3)]
        runs[name] = (losses, eng.master_params(), eng)
    assert not runs["strict"][2].overlap_step
    for name in ("strict", "nvme"):
        assert runs[name][0] == runs["overlap"][0], name
        for a, b in zip(tree_leaves(runs[name][1]),
                        tree_leaves(runs["overlap"][1])):
            assert torch.equal(a, b), name
    assert runs["overlap"][2].phase_report()["update_wait"] >= 0.0


def test_lazy_llama_blocks_match_jax_bitwise(model, monkeypatch):
    cfg, tcfg, _ = model
    # draws cut into chunks (the card's widths take 16 M-element chunks)
    monkeypatch.setattr(tl, "_DRAW_CHUNK", 1000)
    jlm = jl.layered_model_lazy(cfg, seed=3)
    tlm = tl.layered_model_lazy(tcfg, seed=3)
    for l in range(cfg.n_layers):
        jb, tb = jlm.blocks(l), tlm.blocks(l)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert tb[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                tb[k].view(torch.int16).numpy(),
                np.asarray(jb[k]).view(np.int16), err_msg=k)
    for a, b in ((jlm.stem, tlm.stem), (jlm.head, tlm.head)):
        for k in a:
            np.testing.assert_array_equal(b[k].view(torch.int16).numpy(),
                                          np.asarray(a[k]).view(np.int16))
    for k, spec in tlm.blocks_spec.items():
        assert tuple(spec.shape) == jlm.blocks_spec[k].shape
    # the lazy engine starts where an eager one over the same draws does
    stacked = {k: torch.stack([tlm.blocks(l)[k]
                               for l in range(cfg.n_layers)])
               for k in tlm.blocks_spec}
    eager = dataclasses.replace(tlm, blocks=stacked, blocks_spec=None)
    toks = _tokens(2, seed=2)
    lz, eg = _torch(tlm, _conf()), _torch(eager, _conf())
    for _ in range(2):
        assert float(lz.train_batch({"tokens": toks})) == \
            float(eg.train_batch({"tokens": toks}))
    for a, b in zip(tree_leaves(lz.master_params()),
                    tree_leaves(eg.master_params())):
        assert torch.equal(a, b)


def test_layered_mixtral_with_aux_matches_jax(monkeypatch):
    """The layered Mixtral against JAX's.  Every router logit of the port
    lies within ROUTER_GAP of JAX's, at every token of every gate call.  A
    capacity gate turns a top-2 choice that the two frameworks' bf16
    forwards make by less than twice that into another routing, and the
    token it moves moves the capacity slots of later tokens (ROADMAP
    C-f10): where the port's ordered choices differ from JAX's, which the
    gap bound allows only at a JAX margin below 2 ROUTER_GAP (asserted),
    the port takes JAX's router logits (the values; its own gradients).
    Those tokens must be rare: at most one in eight of a gate call's."""
    kw = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, num_experts=4)
    cfg, tcfg = jm.MixtralConfig.tiny(**kw), tm.MixtralConfig.tiny(**kw)
    jp = jax.device_get(jm.init_params(jax.random.PRNGKey(0), cfg))
    conf = {"train_micro_batch_size_per_gpu": 2,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "bf16": {"enabled": True},
            "zero_optimization": {"stage": 3, "offload_param": {
                "device": "cpu", "scheduled": True}}}
    jrouter, ties = _routing_ties(monkeypatch, cfg.top_k)
    jlm = jm.layered_model(cfg, jax.tree.map(jnp.asarray, jp))
    tlm = tm.layered_model(tcfg, from_jax_params(jp, device="cpu"))
    assert tlm.block_has_aux and jlm.block_has_aux
    je, te = _jax(jlm, conf), _torch(tlm, dict(conf))
    toks = _tokens(2, seed=4)
    jls = []
    for _ in range(3):
        jls.append(float(je.train_batch({"tokens": jnp.asarray(toks)})))
        jax.effects_barrier()
    tls = [float(te.train_batch({"tokens": toks})) for _ in range(3)]
    assert len(jrouter) == 0, len(jrouter)    # every JAX gate was replayed
    print("router near-ties (gate call, token, JAX margin, gap):", ties)
    per_call = np.bincount([c for c, *_ in ties], minlength=12)
    assert per_call.max() <= 64 // 8, per_call
    np.testing.assert_allclose(tls, jls, rtol=MOE_LOSS_RTOL)
    assert tls[-1] < tls[0]
    _check_masters(je.master_params(), te.master_params(), jp,
                   MOE_UPDATE_RTOL)


# the bound on the gap between the two frameworks' router logits over the
# whole run: four bf16 spacings of logits in [0.25, 0.5), where the tiny
# Mixtral's largest lie (the gaps read up to 9.7e-3 on an AVX-512 host)
ROUTER_GAP = 2.0 ** -6


def _routing_ties(monkeypatch, k):
    """Records each router-logit matrix JAX's capacity gate sees (in call
    order) and holds the port's gate, called in the same order, to it:
    every logit within ROUTER_GAP of JAX's; at a token whose ordered k
    choices differ from JAX's (the capacity gate fills the first choices'
    slots before the second's, so the order decides slots and drops too),
    JAX's least margin between neighbours among its k + 1 largest logits
    below 2 ROUTER_GAP, and there the port takes JAX's logit values.
    Returns (the queue of JAX's logits, the list of ties found)."""
    from deepspeed_tpu.parallel import moe as jmoe
    from deepspeed_tpu_torch.parallel import moe as tmoe

    queue, ties, calls = [], [], [0]
    jgate, tgate = jmoe.top_k_gating, tmoe.top_k_gating

    def jax_gate(logits, k_, cap, **kw):
        jax.debug.callback(lambda x: queue.append(np.asarray(x)), logits)
        return jgate(logits, k_, cap, **kw)

    def port_gate(logits, k_, cap, **kw):
        want = queue.pop(0)
        got = logits.detach().float().numpy()
        assert want.shape == got.shape
        gap = np.abs(got - want).max(-1)
        assert gap.max() <= ROUTER_GAP, (calls[0], float(gap.max()))
        top = np.sort(want, -1)[:, ::-1][:, :k + 1]
        margin = (top[:, :-1] - top[:, 1:]).min(-1)
        choices = lambda x: np.argsort(-x, -1, kind="stable")[:, :k]
        flipped = (choices(got) != choices(want)).any(-1)
        for t in np.flatnonzero(flipped):
            assert margin[t] < 2 * ROUTER_GAP, (calls[0], t, margin[t])
            ties.append((calls[0], int(t), float(margin[t]), float(gap[t])))
        tied = torch.from_numpy(flipped)
        calls[0] += 1
        fixed = logits + (torch.from_numpy(want) - logits).detach()
        return tgate(torch.where(tied[:, None], fixed, logits), k_, cap,
                     **kw)

    monkeypatch.setattr(jmoe, "top_k_gating", jax_gate)
    monkeypatch.setattr(tmoe, "top_k_gating", port_gate)
    return queue, ties


def test_pstream_checkpoint_fp32_and_cross_tier(model, tmp_path):
    cfg, tcfg, jp = model
    je = _jax(jl.layered_model(cfg, jax.tree.map(jnp.asarray, jp)), _conf())
    te = _torch(tl.layered_model(tcfg, from_jax_params(jp, device="cpu")),
                _conf())
    # at step 0 both hold the bridged weights: the consolidated files
    # agree in names and, bit for bit, in values
    je.save_checkpoint(str(tmp_path / "jck"))
    te.save_checkpoint(str(tmp_path / "tck"))
    jflat = jckpt.zero_to_fp32(str(tmp_path / "jck"),
                               str(tmp_path / "j.npz"))
    tflat = tckpt.zero_to_fp32(str(tmp_path / "tck"),
                               str(tmp_path / "t.npz"))
    assert sorted(tflat.files) == sorted(jflat.files)
    for k in jflat.files:
        assert tflat[k].dtype == np.float32
        np.testing.assert_array_equal(tflat[k], jflat[k], err_msg=k)
    assert {"blocks/wq", "stem/embed", "head/lm_head"} <= set(tflat.files)
    # two steps on, saved on the RAM tier and loaded on the NVMe tier
    toks = _tokens(2, seed=5)
    for _ in range(2):
        te.train_batch({"tokens": toks})
    d = te.save_checkpoint(str(tmp_path / "ck"))
    l_next = float(te.train_batch({"tokens": toks}))
    e2 = _torch(tl.layered_model(tcfg, from_jax_params(jp, device="cpu")),
                _conf(tier={"device": "nvme",
                            "nvme_path": str(tmp_path / "swap")}))
    path, _ = e2.load_checkpoint(str(tmp_path / "ck"))
    assert path == d and e2.global_steps == 2
    m2 = e2.master_params()
    assert float(e2.train_batch({"tokens": toks})) == l_next
    flat = tckpt.zero_to_fp32(str(tmp_path / "ck"), str(tmp_path / "o.npz"))
    np.testing.assert_array_equal(flat["blocks/wq"],
                                  m2["blocks"]["wq"].numpy())
    np.testing.assert_array_equal(flat["stem/embed"], m2["embed"].numpy())


def test_overflow_skip_grad_norm_and_working_set(model):
    _, tcfg, jp = model
    te = _torch(tl.layered_model(tcfg, from_jax_params(jp, device="cpu")),
                _conf())
    assert te.get_global_grad_norm() == 0.0
    per_layer = 2 * sum(te._bsizes)
    resident = sum(x.numel() * 2 for x in tree_leaves(te.stem_c)
                   + tree_leaves(te.head_c))
    assert te.hbm_param_working_set_bytes() == 2 * per_layer + resident
    assert te.hbm_param_working_set_bytes() < te.L * per_layer + resident
    assert te.total_param_count() == tl.param_count(tcfg)
    toks = _tokens(2, seed=6)
    te.train_batch({"tokens": toks})
    assert np.isfinite(te.get_global_grad_norm())
    before = tree_leaves(te.master_params())
    te.head_c = {k: torch.full_like(v, float("inf"))
                 for k, v in te.head_c.items()}
    loss = float(te.train_batch({"tokens": toks}))
    assert not np.isfinite(loss)
    assert te.skipped_steps == 1 and te.global_steps == 2
    assert te.get_global_grad_norm() == float("inf")
    for a, b in zip(before, tree_leaves(te.master_params())):
        assert torch.equal(a, b)


@pytest.mark.parametrize("overlap", [True, False])
def test_nonfinite_grad_under_finite_loss(model, monkeypatch, overlap):
    # layer 1's grads read nonfinite while the loss is finite: the strict
    # path skips the whole step; overlap mode has already updated other
    # layers and raises, as the JAX engine does
    _, tcfg, jp = model
    te = _torch(tl.layered_model(tcfg, from_jax_params(jp, device="cpu")),
                _conf(tier={"device": "cpu", "scheduled": True,
                            "overlap_step": overlap}))
    stats = ParamStreamEngine._stats

    def flag_layer_1(accs, ssq):
        ssq, fin = stats(accs, ssq)
        return (float("nan"), False) if accs is te._gbuf[1] else (ssq, fin)

    monkeypatch.setattr(te, "_stats", flag_layer_1)
    before = tree_leaves(te.master_params())
    toks = {"tokens": _tokens(2, seed=7)}
    if overlap:
        with pytest.raises(FloatingPointError, match="overlap_step"):
            te.train_batch(toks)
        return
    assert np.isfinite(float(te.train_batch(toks)))
    assert te.skipped_steps == 1 and te._opt_steps == 0
    for a, b in zip(before, tree_leaves(te.master_params())):
        assert torch.equal(a, b)
