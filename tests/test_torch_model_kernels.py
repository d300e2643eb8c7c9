"""The plain versions of the port's model kernels against the reference's
Pallas kernels run in interpret mode on the CPU: flash attention (K2) and the
RG-LRU scan (K3), on the same seeded NumPy inputs, at 2e-5 in float32 (LSE
1e-5), the tolerances of ``tests/test_kernels.py``.  On a CPU tensor the
wrappers run exactly these plain versions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.rglru import rglru_pallas

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rglru as rg

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _sigmoid(z):
    return (1.0 / (1.0 + np.exp(-z))).astype(np.float32)


# shapes of tests/test_kernels.py that cover window, MQA, q_offset and GQA
@pytest.mark.parametrize(
    "b,sq,skv,h,kvh,d,causal,window,qoff,bq,bkv",
    [
        (2, 256, 256, 4, 2, 64, True, None, 0, 128, 128),
        (2, 128, 512, 4, 1, 64, True, 128, 0, 64, 128),
        (1, 256, 512, 4, 4, 64, True, None, 256, 128, 256),
        (2, 256, 256, 2, 1, 64, True, 64, 0, 128, 64),
        (1, 128, 128, 8, 8, 128, False, None, 0, 128, 128),
        # the MoE / encoder-decoder / vision slice's forms: d 64 MHA,
        # non-causal, Sq != Skv with kv rows ragged to the card's 128-row
        # tiles (whisper's cross-attention); a GQA group of 6 (internvl2's 48:8)
        (2, 96, 300, 4, 4, 64, False, None, 0, 32, 100),
        (1, 128, 128, 12, 2, 64, True, None, 0, 64, 64),
        (1, 64, 64, 12, 2, 128, True, None, 0, 64, 64),
    ],
)
def test_flash_plain_version_matches_pallas_kernel(b, sq, skv, h, kvh, d, causal, window,
                                                   qoff, bq, bkv):
    q, k, v = (_normal(s, shp) for s, shp in
               ((1, (b, sq, h, d)), (2, (b, skv, kvh, d)), (3, (b, skv, kvh, d))))
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, window=window, q_offset=qoff,
                                  block_q=bq, block_kv=bkv, interpret=True)
    kw = dict(causal=causal, window=window, q_offset=qoff)
    got = fa.flash_attention_torch(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the wrapper on CPU tensors is the plain version, launches nothing
    before = fa.flash_attention.launches
    again = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), **kw)
    assert torch.equal(again, got) and fa.flash_attention.launches == before


def test_flash_lse_matches_pallas_kernel():
    q, k, v = _normal(4, (2, 256, 4, 64)), _normal(5, (2, 256, 2, 64)), _normal(6, (2, 256, 2, 64))
    want, want_lse = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            causal=True, interpret=True, return_lse=True)
    got, lse = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True, return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sq,skv,causal,qoff,window",
                         [(100, 1000, False, 0, None), (100, 1000, True, 900, 300),
                          (37, 53, True, 0, 8)])
def test_flash_ragged_shapes_match_the_oracle(monkeypatch, sq, skv, causal, qoff, window):
    """Shapes the TPU kernel hands to its oracle: the port computes them (in
    q blocks of 32 rows here, so block edges fall inside the rows)."""
    monkeypatch.setattr(fa, "_Q_CHUNK", 32)
    q, k, v = _normal(7, (1, sq, 2, 32)), _normal(8, (1, skv, 1, 32)), _normal(9, (1, skv, 1, 32))
    want, want_lse = ref.attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             causal=causal, window=window, q_offset=qoff,
                                             return_lse=True)
    got, lse = fa.flash_attention_torch(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v), causal=causal, window=window,
                                        q_offset=qoff, return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-5, atol=1e-5)


def test_flash_row_without_visible_keys_gives_zeros_like_the_tpu_kernel():
    q = torch.from_numpy(_normal(10, (1, 4, 1, 8)))
    k = torch.from_numpy(_normal(11, (1, 4, 1, 8)))
    out, lse = fa.flash_attention_torch(q, k, k, causal=True, q_offset=-2, return_lse=True)
    assert not out[0, :2].any() and out[0, 2:].abs().sum() > 0
    assert (lse[0, :2] <= -1e29).all()


def test_flash_rejects_what_it_does_not_take():
    q = torch.zeros((1, 4, 3, 8))
    k = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="grouped"):
        ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, q, q, window=0)
    with pytest.raises(NotImplementedError, match="bias"):
        ops.flash_attention(q, q, q, bias=torch.zeros((1, 1, 4, 4)))


# the reference's shapes, then widths the CUDA kernel copies element by
# element (d % 4 != 0, lanes past d) and a T that is not a multiple of
# block_t (the TPU kernel hands that one to its oracle)
@pytest.mark.parametrize("b,t,d,bt,with_h0", [(2, 512, 64, 256, True), (1, 256, 128, 128, True),
                                               (3, 128, 32, 64, False), (2, 600, 31, 200, True),
                                               (3, 600, 66, 256, False), (1, 330, 66, 110, True)])
def test_rglru_plain_version_matches_pallas_kernel(b, t, d, bt, with_h0):
    x = _normal(12, (b, t, d))
    ap = _normal(13, (d,))
    ig, ag = _sigmoid(_normal(14, (b, t, d))), _sigmoid(_normal(15, (b, t, d)))
    h0 = _normal(16, (b, d)) if with_h0 else None
    y, h = rglru_pallas(jnp.asarray(x), jnp.asarray(ap), jnp.asarray(ig), jnp.asarray(ag),
                        None if h0 is None else jnp.asarray(h0), block_t=bt, interpret=True)
    args = [torch.from_numpy(a) for a in (x, ap, ig, ag)] + \
        [None if h0 is None else torch.from_numpy(h0)]
    got_y, got_h = rg.rglru_scan_torch(*args)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(h), **TOL)
    before = rg.rglru_scan.launches
    wy, wh = ops.rglru_scan(*args)
    assert torch.equal(wy, got_y) and torch.equal(wh, got_h)
    assert rg.rglru_scan.launches == before


@pytest.mark.parametrize("t", [1, 37])
def test_rglru_lengths_the_tpu_kernel_hands_to_its_oracle(t):
    """T = 1 (every decode step) and T not a multiple of any block."""
    x = _normal(17, (2, t, 16))
    ap = _normal(18, (16,))
    ig, ag = _sigmoid(_normal(19, (2, t, 16))), _sigmoid(_normal(20, (2, t, 16)))
    h0 = _normal(21, (2, 16))
    y, h = ref.rglru_reference(*(jnp.asarray(a) for a in (x, ap, ig, ag, h0)))
    got_y, got_h = ops.rglru_scan(*(torch.from_numpy(a) for a in (x, ap, ig, ag, h0)))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(h), **TOL)


def test_rglru_keeps_the_input_type_and_an_fp32_state():
    x = torch.from_numpy(_normal(22, (1, 5, 8))).to(torch.bfloat16)
    g = torch.full((1, 5, 8), 0.5, dtype=torch.bfloat16)
    y, h = ops.rglru_scan(x, torch.zeros(8), g, g)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32 and h.shape == (1, 8)
    with pytest.raises(ValueError, match="h0"):
        ops.rglru_scan(x, torch.zeros(8), g, g, torch.zeros(2, 8))


@pytest.mark.parametrize("b,d,n_sms,group", [
    (1, 2560, 132, 8),      # the training shape: 320 one-warp blocks (32 channels: 80)
    (1, 2562, 132, 8),      # ... with a ragged group
    (2, 2560, 132, 8),      # 160 blocks of 32 channels fall short of 264
    (4, 2560, 132, 32),     # serving batch: 320 blocks of 32 channels
    (1, 31, 132, 8),
    (64, 2560, 132, 32),
    (1, 8448, 132, 32),     # 264 blocks of 32 channels: two a SM
    (1, 8447, 132, 32),
    (1, 8416, 132, 8)])     # 263 of 32 fall short
def test_rglru_bwd_group_pins_the_grid(b, d, n_sms, group):
    """The reverse scan's channels a warp: 32 when its one-warp blocks put
    two on every SM, else 8."""
    assert rg.bwd_group(b, d, n_sms) == group
    assert group in rg.BWD_GROUPS


def test_rglru_bwd_launch_refuses_a_group_the_kernel_lacks():
    a = torch.rand((1, 4, 8))
    with pytest.raises(ValueError, match="group must be one of"):
        rg._launch_bwd_cuda(a, a, None, a, None, group=12)
