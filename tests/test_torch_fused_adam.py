"""Adam of the port against the JAX package: five steps of ``fused_adam``
(on the CPU, the kernel's plain version ``adam_update_reference``) against
the Pallas ``fused_adam`` in interpret mode, with a warmup schedule, weight
decay and bf16 gradients, and the port's ``ops.optim`` rules (adam,
lamb, lion, adagrad, sgd) against the JAX ones.  f32 state; tolerance rtol 1e-5 / atol 1e-7 (the bias
corrections and the schedule's log1p come from two libraries' f32 pow and
log, one ulp apart at most)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu import lr_schedules as jls
from deepspeed_tpu.ops import adam_pallas as jadam
from deepspeed_tpu.ops import optim as jopt
from deepspeed_tpu_torch import lr_schedules as tls
from deepspeed_tpu_torch.ops import adam_cuda as tadam
from deepspeed_tpu_torch.ops import optim as topt

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-7)
SHAPES = {"w": (37, 5), "b": (300,), "stack": (3, 8, 16), "one": (1,)}


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(step, seed=1):
    rng = np.random.default_rng(seed + step)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _run(jopt_, topt_, bf16_grads, steps=5):
    jp = {k: jnp.asarray(v) for k, v in _params().items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in _params().items()}
    js, ts = jopt_.init(jp), topt_.init(tp)
    for i in range(steps):
        g = _grads(i)
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        if bf16_grads:
            jg = {k: v.astype(jnp.bfloat16) for k, v in jg.items()}
            tg = {k: v.to(torch.bfloat16) for k, v in tg.items()}
        ju, js = jopt_.update(jg, js, jp)
        tu, ts = topt_.update(tg, ts, tp)
        for k in SHAPES:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       err_msg=f"u[{k}] step {i}", **TOL)
        jp = jax.tree.map(lambda p, u: p + u.astype(p.dtype), jp, ju)
        tp = {k: p + tu[k].to(p.dtype) for k, p in tp.items()}
    assert int(js.step) == ts.step == steps
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **TOL)
        np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(js.mu[k]),
                                   **TOL)
        np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(js.nu[k]),
                                   **TOL)


@pytest.mark.parametrize("bf16_grads", [False, True])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_fused_adam_matches_pallas_interpret(bf16_grads, wd):
    kw = dict(warmup_min_lr=0.0, warmup_max_lr=1e-2, warmup_num_steps=3)
    _run(jadam.fused_adam(lr=jls.warmup_lr(**kw), weight_decay=wd,
                          interpret=True),
         tadam.fused_adam(lr=tls.warmup_lr(**kw), weight_decay=wd),
         bf16_grads)


@pytest.mark.parametrize("adamw,wd,bias_correction", [
    (True, 0.0, True), (True, 0.05, True), (False, 0.05, True),
    (True, 0.0, False)])
def test_adam_matches_jax(adamw, wd, bias_correction):
    kw = dict(lr=3e-3, weight_decay=wd, adamw=adamw,
              bias_correction=bias_correction)
    _run(jopt.adam(**kw), topt.adam(**kw), bf16_grads=False)


def test_kernel_plain_version_is_the_xla_twin():
    rng = np.random.default_rng(3)
    g, m, p = (rng.standard_normal(50).astype(np.float32) for _ in range(3))
    v = np.abs(rng.standard_normal(50)).astype(np.float32)
    c1, c2 = tadam.adam_scalars(0.9, 0.999, 4)
    want = jadam._adam_update_xla(
        jnp.asarray(g), jnp.asarray(m), jnp.asarray(v), jnp.asarray(p),
        jnp.float32(c1), jnp.float32(c2), jnp.float32(2e-3), b1=0.9,
        b2=0.999, eps=1e-8, wd=0.1)
    got = tadam.adam_update(*(torch.from_numpy(x) for x in (g, m, v, p)),
                            c1, c2, 2e-3, wd=0.1)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    t = np.float32(5)
    np.testing.assert_allclose(
        (c1, c2), (1 / (1 - np.float32(0.9) ** t),
                   1 / (1 - np.float32(0.999) ** t)), rtol=1e-6)


def test_registry_and_onebit_names():
    assert topt.from_config("fusedadam", {"lr": 1e-3}).name == "adamw"
    assert topt.from_config("Lion", {}).name == "lion"
    # the 1-bit family is ported: built outside the engine it exchanges
    # nothing (axis_name None, with the JAX package's warning)
    for name, want in (("OneBitAdam", "onebit_adam"),
                       ("OnebitLamb", "onebit_lamb"),
                       ("ZeroOneAdam", "onebit_adam")):
        opt = topt.from_config(name, {})
        assert (opt.name, opt.axis_name) == (want, None)
        assert opt.name == jopt.from_config(name, {}).name
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.from_config("nope", {})


@pytest.mark.parametrize("name,kw", [
    ("lamb", dict(lr=1e-2, weight_decay=0.01)),
    ("lion", dict(lr=1e-3, weight_decay=0.1)),
    ("adagrad", dict(lr=1e-2, weight_decay=0.01)),
    ("sgd", dict(lr=1e-2, momentum=0.9, nesterov=True, weight_decay=0.01)),
    ("sgd", dict(lr=1e-2)),
])
def test_other_optimizers_match_jax(name, kw):
    jo, to = getattr(jopt, name)(**kw), getattr(topt, name)(**kw)
    jp = {k: jnp.asarray(v) for k, v in _params().items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in _params().items()}
    js, ts = jo.init(jp), to.init(tp)
    for i in range(5):
        g = _grads(i)
        ju, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tu, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tp)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tp = {k: p + tu[k] for k, p in tp.items()}
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **TOL)
    jleaves = [np.asarray(x) for x in jax.tree.leaves(js[1:])]
    tleaves = [x.numpy() for f in ts[1:] if f is not None
               for x in (f[k] for k in sorted(f))]
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_allclose(a, b, **TOL)
