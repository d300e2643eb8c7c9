"""Gradients of K2 (flash attention) and K3 (the RG-LRU scan) in the port
against ``jax.grad`` of the reference, on the CPU, where the port runs the
kernels' plain backwards (:func:`flash_attention_bwd_torch`, a port of the
reference's ``_flash_bwd``; :func:`scan_bwd_torch`, its ``_scan_bwd``).

The reference runs as its own tests run it on the CPU: ``ops`` with
``impl="reference"``, which takes autodiff of ``attention_reference`` for a
short q and ``flash_attention_xla``'s custom VJP past 1024 rows, and
``rglru_xla``'s custom VJP at T = 1024 (``rglru_reference`` below 512).
Tolerance: max |diff| / max |grad| < 1e-5 per gradient, the reference's own
bar (tests/test_kernels.py::test_flash_xla_custom_vjp_grads,
::test_rglru_xla_custom_vjp_grads).  Inputs come from a seeded NumPy
generator."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_helpers  # noqa: F401  (one intra-op thread per worker)

from repro.kernels import ops as ref_ops

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru as rg

TOL = 1e-5


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / (np.max(np.abs(want)) + 1e-12))


def _flash_case(seed, b, s, h, kvh, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d), dtype=np.float32)
    k = rng.standard_normal((b, s, kvh, d), dtype=np.float32)
    v = rng.standard_normal((b, s, kvh, d), dtype=np.float32)
    do = rng.standard_normal((b, s, h, d), dtype=np.float32)
    return q, k, v, do


def _ref_flash_grads(q, k, v, do, **kw):
    f = lambda q, k, v: ref_ops.flash_attention(q, k, v, impl="reference", **kw)
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_flash_grads(q, k, v, do, **kw):
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = fa.flash_attention(qt, kt, vt, **kw)
    return [g.numpy() for g in torch.autograd.grad(out, (qt, kt, vt), torch.tensor(do))]


@pytest.mark.parametrize("shape,window,causal", [
    ((2, 256, 4, 2, 32), None, True),        # autodiff of attention_reference
    ((1, 200, 6, 3, 40), 64, True),
    ((1, 160, 4, 4, 16), None, False),
    ((1, 1280, 4, 1, 32), None, True),       # flash_attention_xla's custom VJP
    ((1, 1280, 4, 1, 32), 128, True),
])
def test_flash_attention_gradients_match_the_reference(shape, window, causal):
    q, k, v, do = _flash_case(sum(shape), *shape)
    kw = dict(causal=causal, window=window)
    for got, want in zip(_port_flash_grads(q, k, v, do, **kw),
                         _ref_flash_grads(q, k, v, do, **kw)):
        assert _rel(got, want) < TOL


def test_flash_attention_row_without_a_key_gets_zero_gradient():
    """With ``q_offset = -3`` the first three q rows see no key: the port's
    forward gives them zeros (the TPU kernel's choice) and its backward zero
    dq, and they add nothing to dk / dv.  The reference's dense oracle gives
    such a row uniform weights instead, so it is held with those rows' output
    gradient zeroed (their share of dk / dv is then 0 on both sides)."""
    q, k, v, do = _flash_case(7, 1, 96, 4, 2, 32)
    do[:, :3] = 0.0
    kw = dict(causal=True, q_offset=-3)
    got = _port_flash_grads(q, k, v, do, **kw)
    want = _ref_flash_grads(q, k, v, do, **kw)
    for g, w in zip(got, want):
        assert _rel(g, w) < TOL
    q2 = q.copy()
    _, _, _, do2 = _flash_case(8, 1, 96, 4, 2, 32)
    dq = _port_flash_grads(q2, k, v, do2, **kw)[0]
    assert np.all(dq[:, :3] == 0.0) and np.any(dq[:, 3:] != 0.0)


def test_flash_attention_plain_backward_equals_the_autograd_function():
    """The wrapper's backward and a direct call of the plain backward on the
    saved (out, lse) give the same gradients, bit for bit."""
    q, k, v, do = _flash_case(3, 1, 300, 4, 2, 16)
    qt, kt, vt = (torch.tensor(a) for a in (q, k, v))
    out, lse = fa.flash_attention(qt, kt, vt, window=50, return_lse=True)
    direct = fa.flash_attention_bwd(qt, kt, vt, out, lse, torch.tensor(do), window=50)
    via = _port_flash_grads(q, k, v, do, window=50)
    for a, b in zip(direct, via):
        assert np.array_equal(a.numpy(), b)


def _rglru_case(seed, b, t, d):
    rng = np.random.default_rng(seed)
    sig = lambda z: 1.0 / (1.0 + np.exp(-z))
    x = rng.standard_normal((b, t, d), dtype=np.float32)
    ap = rng.standard_normal((d,), dtype=np.float32)
    ig = sig(rng.standard_normal((b, t, d))).astype(np.float32)
    ag = sig(rng.standard_normal((b, t, d))).astype(np.float32)
    h0 = rng.standard_normal((b, d), dtype=np.float32)
    dy = rng.standard_normal((b, t, d), dtype=np.float32)
    dh = rng.standard_normal((b, d), dtype=np.float32)
    return (x, ap, ig, ag, h0), dy, dh


@pytest.mark.parametrize("t", [1024, 256])   # rglru_xla's custom VJP / rglru_reference
def test_rglru_gradients_match_the_reference(t):
    args, dy, dh = _rglru_case(t, 2, t, 16)
    f = lambda *a: ref_ops.rglru_scan(*a, impl="reference")
    _, vjp = jax.vjp(f, *map(jnp.asarray, args))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    tens = [torch.tensor(a, requires_grad=True) for a in args]
    y, h = rg.rglru_scan(*tens)
    got = torch.autograd.grad((y, h), tens, (torch.tensor(dy), torch.tensor(dh)))
    for name, g, w in zip(("x", "a_param", "input_gate", "a_gate", "h0"), got, want):
        assert _rel(g.numpy(), w) < TOL, name


def test_rglru_backward_takes_no_h0_and_no_last_state_gradient():
    """Without h0 the scan starts from zeros and returns no h0 gradient; a
    None gradient of h_last is zeros."""
    args, dy, _ = _rglru_case(5, 2, 40, 8)
    tens = [torch.tensor(a, requires_grad=True) for a in args[:4]]
    y, _ = rg.rglru_scan(*tens)
    got = torch.autograd.grad(y, tens, torch.tensor(dy))
    want = torch.autograd.grad(rg.rglru_scan_torch(*tens)[0], tens, torch.tensor(dy))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w.numpy()) < TOL


def test_scan_backward_is_the_reverse_recurrence():
    """The plain backward in the kernel's order: g_t = dy_t + a_{t+1} g_{t+1}
    (+ dh_last at the end), dx = g, da = g h_{t-1}, dh0 = a_0 g_0, checked
    against a float64 loop."""
    rng = np.random.default_rng(11)
    a, xb, dy = (rng.random((2, 9, 5)).astype(np.float32) for _ in range(3))
    h0, dh = (rng.standard_normal((2, 5)).astype(np.float32) for _ in range(2))
    y = rg.scan_torch(torch.tensor(a), torch.tensor(xb), torch.tensor(h0))
    da, dx, dh0 = rg.scan_bwd_torch(torch.tensor(a), y, torch.tensor(h0), torch.tensor(dy),
                                    torch.tensor(dh))
    yd = y.double().numpy()
    g = dh.astype(np.float64)
    for t in range(8, -1, -1):
        g = dy[:, t] + (a[:, t + 1] * g_next if t < 8 else g)
        g_next = g
        hp = yd[:, t - 1] if t else h0
        np.testing.assert_allclose(dx[:, t].numpy(), g, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(da[:, t].numpy(), g * hp, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dh0.numpy(), a[:, 0] * g, rtol=1e-6, atol=1e-6)
