"""The port's ZeRO-Infinity engine (``infinity.InfinityEngine``: optimizer
state streamed through a tier in sub-groups, bf16 compute params on the
card) against the JAX package's on the CPU: a tiny bf16 Llama (dim 64, 2
layers) from bridged weights, numpy-seeded batches, the RAM tier, the JAX
engine on a one-device mesh.  Losses over 3 steps within 2e-3 relative
(bf16 forwards of two frameworks), the masters' updates within 20 % of
their norm, with accumulation and clipping; the host update (native Adam)
against the device update (plain Adam) within the same bounds.  Within
the port, bit for bit: the NVMe tier against the RAM tier, many sub-groups
against one, a checkpoint round trip.  No test here builds the JAX NVMe
tier."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.topology import MeshSpec
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch._tree import tree_leaves
from deepspeed_tpu_torch.infinity import InfinityEngine
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
CFG = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2)
LOSS_RTOL = 2e-3
UPDATE_RTOL = 0.2


@pytest.fixture(scope="module")
def model():
    cfg = jl.LlamaConfig.tiny(**CFG)
    jp = jax.device_get(jl.init_params(jax.random.PRNGKey(0), cfg))
    return cfg, tl.LlamaConfig.tiny(**CFG), jp


def _conf(offload=None, accum=1, sub_group=0, **over):
    zero = {"stage": 0, "offload_optimizer": offload or {
        "device": "cpu", "scheduled": True}}
    if sub_group:
        zero["sub_group_size"] = sub_group
    conf = {"train_micro_batch_size_per_gpu": 4,
            "gradient_accumulation_steps": accum,
            "zero_optimization": zero,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 3e-3, "weight_decay": 0.01}},
            "bf16": {"enabled": True}}
    conf.update(over)
    return conf


def _torch(tcfg, jp, conf):
    return initialize(loss_fn=tl.loss_fn(tcfg),
                      params=from_jax_params(jp, device="cpu"),
                      config=conf, device="cpu")[0]


def _batch(rows, seed=0, T=33):
    return {"tokens": np.random.default_rng(seed).integers(
        0, 256, (rows, T)).astype(np.int32)}


def _run(eng, batch, steps=3, jax_engine=False):
    b = {k: jnp.asarray(v) for k, v in batch.items()} if jax_engine \
        else batch
    return [float(eng.train_batch(b)) for _ in range(steps)]


def _check_masters(got, want, init):
    for path, a in jax.tree_util.tree_flatten_with_path(want)[0]:
        b, w0 = got, init
        for k in path:
            b, w0 = b[k.key], w0[k.key]
        dw = np.asarray(a) - np.asarray(w0, np.float32)
        dg = b.numpy() - np.asarray(w0, np.float32)
        assert np.linalg.norm(dg - dw) <= UPDATE_RTOL * np.linalg.norm(dw), \
            jax.tree_util.keystr(path)


@pytest.mark.parametrize("case", ["plain", "accum2_clip"])
def test_trajectory_matches_jax(model, case):
    cfg, tcfg, jp = model
    accum = 2 if case == "accum2_clip" else 1
    over = {"gradient_clipping": 0.5} if case == "accum2_clip" else {}
    conf = _conf(accum=accum, **over)
    mesh = MeshSpec.build({"data": 1}, devices=jax.devices()[:1])
    je = dstpu.initialize(loss_fn=jl.loss_fn(cfg),
                          params=jax.tree.map(jnp.asarray, jp),
                          config=dict(conf), mesh=mesh)[0]
    te = _torch(tcfg, jp, conf)
    assert isinstance(te, InfinityEngine)
    assert [len(g) for g in te.groups] == [len(g) for g in je.groups]
    batch = _batch(4 * accum)
    jls, tls = _run(je, batch, jax_engine=True), _run(te, batch)
    np.testing.assert_allclose(tls, jls, rtol=LOSS_RTOL)
    assert tls[-1] < tls[0]
    assert te.global_steps == je.global_steps == 3
    assert te.get_lr() == pytest.approx(je.get_lr(), rel=1e-6)
    _check_masters(te.master_params(), je.master_params(), jp)
    assert te.tier_local_bytes() == je.tier_local_bytes()
    assert te.hbm_state_bytes() == je.hbm_state_bytes()


def test_host_update_matches_device_update(model):
    _, tcfg, jp = model
    batch = _batch(4, seed=1)
    dev = _torch(tcfg, jp, _conf())
    host = _torch(tcfg, jp, _conf({"device": "cpu", "scheduled": True,
                                   "update": "host"}))
    ld, lh = _run(dev, batch), _run(host, batch)
    np.testing.assert_allclose(lh, ld, rtol=LOSS_RTOL)
    assert lh[0] == ld[0]             # step 1's loss precedes any update
    init = from_jax_params(jp, device="cpu")
    dm, hm = dev.master_params(), host.master_params()
    for path in ("embed", "lm_head", "final_norm"):
        dw = dm[path] - init[path]
        assert (hm[path] - init[path] - dw).norm() <= \
            UPDATE_RTOL * dw.norm()
    rep = host.phase_report()
    assert rep["host_adam"] > 0 and rep["grad_program"] > 0
    assert host.link_bytes["down"] > 0 and host.link_bytes["up"] > 0


def test_nvme_tier_groups_and_checkpoint_bitwise(model, tmp_path):
    _, tcfg, jp = model
    batch = _batch(4, seed=2)
    ram = _torch(tcfg, jp, _conf())
    nvme = _torch(tcfg, jp, _conf({"device": "nvme",
                                   "nvme_path": str(tmp_path / "swap")}))
    many = _torch(tcfg, jp, _conf(sub_group=5000))
    assert len(many.groups) > len(ram.groups) == 1
    lr_ = _run(ram, batch, 2)
    assert _run(nvme, batch, 2) == lr_ and _run(many, batch, 2) == lr_
    for eng in (nvme, many):
        for a, b in zip(tree_leaves(eng.master_params()),
                        tree_leaves(ram.master_params())):
            assert torch.equal(a, b)
    ram.save_checkpoint(str(tmp_path / "ck"))
    nxt = _run(ram, batch, 1)
    back = _torch(tcfg, jp, _conf({"device": "nvme",
                                   "nvme_path": str(tmp_path / "s2")}))
    back.load_checkpoint(str(tmp_path / "ck"))
    assert back.global_steps == 2
    assert _run(back, batch, 1) == nxt


def test_nonfinite_grad_skips_and_keeps_state(model):
    _, tcfg, jp = model
    eng = _torch(tcfg, jp, _conf())
    before = [t.clone() for t in tree_leaves(eng.master_params())]
    params_c = [p.clone() for p in eng.params_c]
    eng.params_c[0].fill_(float("nan"))        # embed: a nonfinite grad
    eng.train_batch(_batch(4, seed=3))
    assert eng.skipped_steps == 1 and eng.global_steps == 1
    assert eng.metrics["overflow"] == 1
    for a, b in zip(before, tree_leaves(eng.master_params())):
        assert torch.equal(a, b)
    eng.params_c[0].copy_(params_c[0])
    eng.train_batch(_batch(4, seed=3))
    assert eng.skipped_steps == 1 and eng._opt_steps == 1
    # the digest is ported: one rank with no process group runs no
    # collective, and the dry step leaves the state as it was
    before = [t.clone() for t in tree_leaves(eng.master_params())]
    d = eng.comms_digest(_batch(4))
    assert d["total_collectives"] == 0 and d["per_kind"] == {}
    assert eng._opt_steps == 1
    for a, b in zip(before, tree_leaves(eng.master_params())):
        assert torch.equal(a, b)
