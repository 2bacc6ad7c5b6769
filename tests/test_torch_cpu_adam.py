"""The port's fused CPU Adam (``deepspeed_tpu_torch/ops/cpu_adam.py`` over
its own ``csrc/host/cpu_adam.cpp``) against the JAX package's
``ops/cpu_adam.py`` on the same arrays: adam and adamw, weight decay on and
off, bias correction on and off, the bf16 image.

Tolerance: 1 ulp of f32 on p, m and v, the bound the JAX module's comment
states, held arm against arm (the port's native against the JAX native,
the port's plain mirror against the JAX numpy fallback); the two natives
are built from the same source with the same flags and agree bit for bit.
The bf16 image is exact: it equals the round-to-nearest-even of the same
arm's new p, and the JAX arm's image wherever their p agree.
``f32_to_bf16`` is exact.  The native and plain arms differ by more than
an ulp (the C++ forms 1 - b2 in f32): held at 1e-4 relative."""

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import cpu_adam as jadam
from deepspeed_tpu_torch.ops import cpu_adam as tadam

torch.set_num_threads(1)
N = 50003                              # > 16 threads x 4096: threaded path


def _arrays(seed, n=N):
    rng = np.random.default_rng(seed)
    p, m, g = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    v = np.abs(rng.standard_normal(n)).astype(np.float32)
    return [p, m, v, g]


def _kw(adamw, wd, bc, t=3):
    return dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, wd=wd, adamw=adamw, t=t,
                bias_correction=bc, emit_bf16=True)


def _jax_plain(monkeypatch):
    monkeypatch.setattr(jadam, "_ensure_lib", lambda: None)


def _port_plain(monkeypatch):
    monkeypatch.setattr(tadam, "_ensure_lib", lambda: None)


def _bits(img):
    if isinstance(img, torch.Tensor):
        return img.view(torch.int16).numpy().view(np.uint16)
    return img


def _rne(p):
    return torch.from_numpy(p).to(torch.bfloat16).view(
        torch.int16).numpy().view(np.uint16)


CASES = [(adamw, wd, bc) for adamw in (True, False) for wd in (0.0, 0.1)
         for bc in (True, False)]


@pytest.mark.parametrize("adamw,wd,bc", CASES)
@pytest.mark.parametrize("as_tensor", [False, True])
def test_native_step_matches_jax_native(adamw, wd, bc, as_tensor):
    assert tadam.native_available() and jadam.native_available()
    want = _arrays(0)
    jimg = jadam.cpu_adam_step(*want, **_kw(adamw, wd, bc))
    got = _arrays(0)
    bufs = [torch.from_numpy(a) for a in got] if as_tensor else got
    img = tadam.cpu_adam_step(*bufs, **_kw(adamw, wd, bc))
    assert isinstance(img, torch.Tensor if as_tensor else np.ndarray)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_max_ulp(a, b, maxulp=1)
        np.testing.assert_array_equal(a, b)       # same source, same flags
    np.testing.assert_array_equal(_bits(img), jimg)
    np.testing.assert_array_equal(_bits(img), _rne(got[0]))


@pytest.mark.parametrize("adamw,wd,bc", CASES)
def test_plain_mirror_matches_jax_fallback(adamw, wd, bc, monkeypatch):
    _jax_plain(monkeypatch)
    _port_plain(monkeypatch)
    want = _arrays(1)
    jimg = jadam.cpu_adam_step(*want, **_kw(adamw, wd, bc))
    got = _arrays(1)
    img = tadam.cpu_adam_step(*[torch.from_numpy(a) for a in got],
                              **_kw(adamw, wd, bc))
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_max_ulp(a, b, maxulp=1)
    np.testing.assert_array_equal(_bits(img), _rne(got[0]))
    same = got[0] == want[0]
    np.testing.assert_array_equal(_bits(img)[same], jimg[same])


def test_native_and_plain_arms_agree(monkeypatch):
    native = _arrays(2)
    tadam.cpu_adam_step(*native, **_kw(True, 0.1, True, t=5))
    _port_plain(monkeypatch)
    plain = _arrays(2)
    tadam.cpu_adam_step(*plain, **_kw(True, 0.1, True, t=5))
    for a, b in zip(native[:3], plain[:3]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7)


def test_no_image_and_pinned_buffers():
    bufs = [torch.from_numpy(a) for a in _arrays(3, n=4096)]
    kw = _kw(True, 0.0, True)
    kw["emit_bf16"] = False
    assert tadam.cpu_adam_step(*bufs, **kw) is None
    want = _arrays(3, n=4096)
    jadam.cpu_adam_step(*want, **kw)
    np.testing.assert_array_equal(bufs[0].numpy(), want[0])


def test_rejects_what_it_cannot_write_through():
    p, m, v, g = (torch.zeros(8) for _ in range(4))
    kw = _kw(True, 0.0, True)
    with pytest.raises(ValueError, match="float32"):
        tadam.cpu_adam_step(p.double(), m, v, g, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tadam.cpu_adam_step(torch.zeros(16)[::2], m, v, g, **kw)
    with pytest.raises(ValueError, match="size"):
        tadam.cpu_adam_step(p, m, v, torch.zeros(9), **kw)


@pytest.mark.parametrize("plain", [False, True])
def test_f32_to_bf16_exact(plain, monkeypatch):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(40000) * 10.0 ** rng.integers(-30, 30, 40000)
         ).astype(np.float32)
    x[:4] = [np.inf, -np.inf, 0.0, -0.0]
    # round-to-nearest-even ties: halfway between two bf16 neighbours
    x[4:8] = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0x7F7F8000],
                      np.uint32).view(np.float32)
    want = jadam.f32_to_bf16(x)
    if plain:
        _port_plain(monkeypatch)
    np.testing.assert_array_equal(tadam.f32_to_bf16(x), want)
    got_t = tadam.f32_to_bf16(torch.from_numpy(x))
    assert got_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got_t), want)
    out = np.empty(x.shape, np.uint16)
    assert tadam.f32_to_bf16(x, out) is out
    np.testing.assert_array_equal(out, want)
    nan = tadam.f32_to_bf16(np.array([np.nan], np.float32))
    assert np.isnan(torch.from_numpy(nan.view(np.int16)).view(
        torch.bfloat16).float().item())


def test_library_is_the_ports_own_build():
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    assert Path(tadam._SRC) == root / "deepspeed_tpu_torch" / "csrc" / \
        "host" / "cpu_adam.cpp"
    assert Path(tadam._LIB).parent == root / "build" / \
        "deepspeed_tpu_torch" / "host"


@pytest.mark.parametrize("native", [True, False])
def test_grad_scale_equals_the_scaled_grad(native, monkeypatch):
    # the layer-streaming engine folds 1/accumulation (and the clip factor)
    # into the Adam's pass: the same as scaling g first, bit for bit
    if not native:
        monkeypatch.setattr(tadam, "_ensure_lib", lambda: None)
    a = [torch.from_numpy(x) for x in _arrays(7)]
    b = [x.clone() for x in a]
    b[3].mul_(0.37)
    img_a = tadam.cpu_adam_step(*a, grad_scale=0.37, **_kw(True, 0.1, True))
    img_b = tadam.cpu_adam_step(*b, **_kw(True, 0.1, True))
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)
    assert torch.equal(img_a, img_b)
    assert not torch.equal(a[3], b[3])       # g itself is not written


@pytest.mark.parametrize("native", [True, False])
def test_accumulate_bf16_lands_and_sums_squares(native, monkeypatch):
    if not native:
        monkeypatch.setattr(tadam, "_ensure_lib", lambda: None)
    gen = torch.Generator().manual_seed(3)
    g1, g2 = (torch.randn(N, generator=gen).to(torch.bfloat16)
              for _ in range(2))
    acc = torch.full((N,), 5.0)
    s1 = tadam.accumulate_bf16(acc, g1, True)
    assert torch.equal(acc, g1.float())
    s2 = tadam.accumulate_bf16(acc, g2, False)
    want = g1.float() + g2.float()
    assert torch.equal(acc, want)
    for got, ref in ((s1, g1.double()), (s2, want.double())):
        np.testing.assert_allclose(got, float(torch.dot(ref, ref)),
                                   rtol=1e-12)
    with pytest.raises(ValueError, match="bf16"):
        tadam.accumulate_bf16(acc, g1.float(), False)
