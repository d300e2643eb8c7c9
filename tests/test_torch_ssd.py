"""The plain version of the port's Mamba-2 SSD kernel (K4) against the
reference on the CPU: the TPU kernel ``ssd_pallas`` run in interpret mode at
the four shapes of ``tests/test_kernels.py::test_ssd_sweep``, and the
sequential oracle ``ssd_reference`` at ragged T, at T = 1, without h0 and
without d_skip.  Same seeded NumPy inputs on both sides, float32.

Tolerances (those of ``test_ssd_sweep``): max |dy| / max |y| < 1e-4, h_last
within rtol = atol = 1e-4.  The chunked and the sequential forms sum in
different orders, and the port's chunk (64) is not the TPU kernel's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.ssd import ssd_pallas

from repro_torch.kernels import ops
from repro_torch.kernels import ssd as port_ssd

torch.set_num_threads(1)


def _inputs(seed, b, t, h, p, g, n, with_d=True, with_h0=True):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    x = f(b, t, h, p)
    dt = np.log1p(np.exp(f(b, t, h))).astype(np.float32)            # softplus: > 0
    a_log = (0.5 * f(h)).astype(np.float32)
    bm, cm = (0.3 * f(b, t, g, n)).astype(np.float32), (0.3 * f(b, t, g, n)).astype(np.float32)
    d_skip = f(h) if with_d else None
    h0 = (0.1 * f(b, h, p, n)).astype(np.float32) if with_h0 else None
    return x, dt, a_log, bm, cm, d_skip, h0


def _as(mod, arrays):
    return [None if a is None else mod(a) for a in arrays]


def _close(got, want):
    (y, h), (yr, hr) = got, want
    y, yr = np.asarray(y, np.float64), np.asarray(yr, np.float64)
    scale = np.abs(yr).max() + 1e-9
    assert np.abs(y - yr).max() / scale < 1e-4
    np.testing.assert_allclose(np.asarray(h), np.asarray(hr), rtol=1e-4, atol=1e-4)


def _port(args):
    y, h = port_ssd.ssd_chunked_torch(*_as(torch.from_numpy, args))
    return y.numpy(), h.numpy()


@pytest.mark.parametrize("b,t,h,p,g,n,ch", [
    (2, 256, 4, 32, 2, 64, 128),
    (1, 256, 4, 64, 1, 128, 64),
    (2, 128, 8, 16, 8, 32, 128),
    (1, 512, 2, 32, 1, 64, 256),
])
def test_plain_version_matches_the_pallas_kernel(b, t, h, p, g, n, ch):
    args = _inputs(t + h + g, b, t, h, p, g, n)
    want = ssd_pallas(*_as(jnp.asarray, args), chunk=ch, interpret=True)
    _close(_port(args), want)


@pytest.mark.parametrize("b,t,h,p,g,n,with_d,with_h0", [
    (2, 300, 4, 16, 2, 32, True, True),     # ragged: 4 chunks of 64 and one of 44
    (1, 1000, 2, 8, 1, 16, True, False),    # ragged, no h0
    (2, 1, 4, 16, 1, 32, True, True),       # one decode step
    (3, 1, 6, 8, 3, 8, False, True),        # one decode step, no d_skip
    (1, 64, 2, 16, 2, 16, False, False),    # exactly one chunk, neither
])
def test_plain_version_matches_the_sequential_oracle(b, t, h, p, g, n, with_d, with_h0):
    args = _inputs(t * 7 + n, b, t, h, p, g, n, with_d, with_h0)
    _close(_port(args), ref.ssd_reference(*_as(jnp.asarray, args)))


def test_chunks_carry_the_state_like_one_call():
    """Two calls, the second from the first's h_last, are one call."""
    args = _inputs(5, 2, 200, 4, 16, 2, 16)
    x, dt, a_log, bm, cm, d_skip, h0 = _as(torch.from_numpy, args)
    y, h = port_ssd.ssd_chunked_torch(x, dt, a_log, bm, cm, d_skip, h0)
    y1, h1 = port_ssd.ssd_chunked_torch(x[:, :90], dt[:, :90], a_log, bm[:, :90],
                                        cm[:, :90], d_skip, h0)
    y2, h2 = port_ssd.ssd_chunked_torch(x[:, 90:], dt[:, 90:], a_log, bm[:, 90:],
                                        cm[:, 90:], d_skip, h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h2, h, rtol=1e-5, atol=1e-5)


def test_masked_entries_select_and_never_poison_the_result():
    """A strongly decaying head makes exp(L_t - L_s) above the diagonal
    overflow to inf; the result stays finite and equals the oracle."""
    args = list(_inputs(9, 1, 128, 2, 8, 1, 8))
    args[2] = np.array([4.0, 4.5], np.float32)       # A = -e^4: L drops by ~50 a step
    y, h = _port(args)
    assert np.isfinite(y).all() and np.isfinite(h).all()
    _close((y, h), ref.ssd_reference(*_as(jnp.asarray, args)))


def test_bf16_inputs_round_y_once_to_bf16():
    args = _inputs(3, 1, 70, 2, 8, 1, 8)
    x, dt, a_log, bm, cm, d_skip, h0 = _as(torch.from_numpy, args)
    y, h = port_ssd.ssd_chunked_torch(x.bfloat16(), dt, a_log, bm.bfloat16(), cm.bfloat16(),
                                      d_skip, h0)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    y32, h32 = port_ssd.ssd_chunked_torch(x.bfloat16().float(), dt, a_log, bm.bfloat16().float(),
                                          cm.bfloat16().float(), d_skip, h0)
    assert torch.equal(y, y32.bfloat16()) and torch.equal(h, h32)


def test_wrapper_on_cpu_tensors_is_the_plain_version_and_launches_nothing():
    args = _as(torch.from_numpy, _inputs(4, 2, 100, 4, 16, 2, 16))
    before = port_ssd.ssd_chunked.launches
    got = ops.ssd_chunked(*args)
    want = port_ssd.ssd_chunked_torch(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert port_ssd.ssd_chunked.launches == before


def test_wrapper_raises_on_bad_shapes():
    x, dt, a_log, bm, cm, d_skip, h0 = _as(torch.from_numpy, _inputs(6, 2, 10, 4, 8, 2, 8))
    with pytest.raises(ValueError, match="dt must be"):
        ops.ssd_chunked(x, dt[:, :5], a_log, bm, cm, d_skip, h0)
    with pytest.raises(ValueError, match="grouped"):
        ops.ssd_chunked(x, dt, a_log, bm[:, :, :1].expand(2, 10, 3, 8), cm[:, :, :1].expand(
            2, 10, 3, 8), d_skip, h0)
    with pytest.raises(ValueError, match="h0 must be"):
        ops.ssd_chunked(x, dt, a_log, bm, cm, d_skip, h0[:, :, :4])
    with pytest.raises(ValueError, match="no time steps"):
        ops.ssd_chunked(x[:, :0], dt[:, :0], a_log, bm[:, :0], cm[:, :0], d_skip, h0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.ssd_chunked(x.to("meta"), dt.to("meta"), a_log.to("meta"), bm.to("meta"),
                        cm.to("meta"), None, None)
