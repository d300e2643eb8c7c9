"""K4's gradient and mamba2-780m's training in the port against the
reference, on the CPU, where the port runs the SSD's plain backward
(:func:`ssd_chunked_bwd_torch`, the chunked reverse loop the CUDA backward
computes).

* K4's gradients (x, dt, a_log, B, C, d_skip, h0, with a nonzero gradient of
  the last state) against ``jax.vjp`` of the reference's ``ops.ssd_chunked``
  with ``impl="reference"`` as its own tests run it on the CPU: autodiff of
  ``ssd_chunked_reference`` (chunks of 128) where T is a multiple of 128
  above it, else of the sequential ``ssd_reference``.  Float32 inputs from a
  seeded NumPy generator; max |diff| / max |grad| < 1e-5 per gradient.  The
  step sizes are Mamba-2's usual range (softplus(z - 3), ~0.05): the
  reference's chunked oracle takes ``exp(L_t - L_s)`` above the diagonal
  before its ``where`` drops it, and its gradient is NaN once a 128-step
  chunk's decay passes e^88 (dt ~0.7 does that; the port masks before the
  exp and stays finite).
* The plain backward against autograd through the plain forward, in float64
  (both sum in float64 there): 1e-6.
* mamba2-780m's smoke step (float32) against the reference's
  ``jax.value_and_grad``: the loss within 1e-5 relative, every gradient
  within 1e-4 of its max |grad|.  At 128 tokens the reference takes its
  sequential oracle and the port two chunks of 64; at 256 tokens both cross
  chunk boundaries (the reference's 128, the port's 64), with dt_bias at -3
  (dt ~0.05) so that the reference's chunked gradient is finite.
* The residency plan's lowering of ``ssm_out`` (K4's output held across a
  recomputation): keep, offload and remat give the loss and gradients of the
  forward without recomputation bit for bit, with the kernel's forwards
  counted.
* The launcher trains mamba2-780m at ``--smoke`` and recovers from injected
  failures bit-identically.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_helpers  # noqa: F401  (one intra-op thread per worker)

from repro.configs.registry import get_smoke_config as ref_get_smoke_config
from repro.kernels import ops as ref_ops
from repro.models import arch_forward as ref_arch_forward
from repro.models import arch_init_params as ref_arch_init_params
from repro.models import cross_entropy_loss as ref_cross_entropy_loss
from repro.runtime import SyntheticLM as RefSyntheticLM

from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ssd
from repro_torch.launch.train import train_main
from repro_torch.models import Decoder, arch_forward, arch_init_params, cross_entropy_loss
from repro_torch.models.decoder import check_supported, kernel_forwards
from repro_torch.models.remat import Residency, classes_of
from repro_torch.runtime import SyntheticLM

ARCH = "mamba2-780m"
TOL = 1e-5
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
GRADS = ("x", "dt", "a_log", "b_mat", "c_mat", "d_skip", "h0")


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / (np.max(np.abs(want)) + 1e-30))


def _ssd_case(seed, b, t, h, p, g, n, extras=True, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p))
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h)) - 3.0))
    a_log = 0.5 * rng.standard_normal(h)
    bm = 0.3 * rng.standard_normal((b, t, g, n))
    cm = 0.3 * rng.standard_normal((b, t, g, n))
    d_skip = rng.standard_normal(h) if extras else None
    h0 = 0.1 * rng.standard_normal((b, h, p, n)) if extras else None
    dy = rng.standard_normal((b, t, h, p))
    dh = rng.standard_normal((b, h, p, n))
    cast = lambda a: None if a is None else a.astype(dtype)  # noqa: E731
    return [cast(a) for a in (x, dt, a_log, bm, cm, d_skip, h0)], cast(dy), cast(dh)


def _port_grads(args, dy, dh):
    ts = [None if a is None else torch.tensor(a, requires_grad=True) for a in args]
    y, h_last = ssd.ssd_chunked(*ts)
    given = [t for t in ts if t is not None]
    return torch.autograd.grad((y, h_last), given, (torch.tensor(dy), torch.tensor(dh)))


# (b, t, h, p, g, n): T a multiple of the reference's chunk above it (its
# chunked oracle), T a multiple of the port's chunk only, a ragged T, T < 64,
# and G < H
@pytest.mark.parametrize("extras", [True, False])
@pytest.mark.parametrize("shape", [(2, 256, 4, 8, 2, 16), (1, 384, 2, 16, 1, 32),
                                   (1, 128, 3, 8, 3, 8), (2, 200, 4, 16, 1, 32),
                                   (1, 40, 6, 8, 2, 16)])
def test_ssd_gradients_match_the_reference(shape, extras):
    args, dy, dh = _ssd_case(sum(shape), *shape, extras)
    f = lambda *a: ref_ops.ssd_chunked(*a, impl="reference")  # noqa: E731
    _, vjp = jax.vjp(f, *[None if a is None else jnp.asarray(a) for a in args])
    want = [w for w in vjp((jnp.asarray(dy), jnp.asarray(dh))) if w is not None]
    names = [name for name, a in zip(GRADS, args) if a is not None]
    got = _port_grads(args, dy, dh)
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        assert np.all(np.isfinite(np.asarray(w))), name
        assert _rel(g.numpy(), w) < TOL, (name, _rel(g.numpy(), w))


@pytest.mark.parametrize("extras", [True, False])
@pytest.mark.parametrize("shape", [(2, 200, 4, 8, 2, 16), (1, 64, 2, 4, 1, 8),
                                   (1, 30, 3, 5, 3, 4)])
def test_plain_backward_is_autograd_of_the_plain_forward(shape, extras):
    """In float64, with the step sizes of the serving checks (softplus of a
    unit normal, ~0.7): the plain forward masks before its exp, so autograd
    through it stays finite too."""
    args, dy, dh = _ssd_case(7, *shape, extras, dtype=np.float64)
    rng = np.random.default_rng(8)
    args[1] = np.log1p(np.exp(rng.standard_normal(args[1].shape)))
    ts = [None if a is None else torch.tensor(a, requires_grad=True) for a in args]
    y, h_last = ssd.ssd_chunked_torch(*ts)
    assert y.dtype == torch.float64
    given = [t for t in ts if t is not None]
    want = torch.autograd.grad((y, h_last), given, (torch.tensor(dy), torch.tensor(dh)))
    got = [g for g in ssd.ssd_chunked_bwd_torch(*[None if t is None else t.detach() for t in ts],
                                                torch.tensor(dy), torch.tensor(dh))
           if g is not None]
    assert len(got) == len(want)
    for name, g, w in zip([n for n, a in zip(GRADS, args) if a is not None], got, want):
        assert bool(torch.isfinite(w).all()), name
        assert _rel(g.numpy(), w.numpy()) < 1e-6, name


def test_wrapper_backward_is_the_plain_backward_bit_for_bit():
    """The autograd function's backward and a direct call of the plain
    backward on the same inputs give the same gradients, bit for bit; a None
    gradient of the last state is zeros."""
    args, dy, dh = _ssd_case(3, 2, 150, 4, 8, 2, 16)
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    y, _ = ssd.ssd_chunked(*ts)
    via = torch.autograd.grad(y, ts, torch.tensor(dy))
    direct = ssd.ssd_chunked_bwd(*[t.detach() for t in ts], torch.tensor(dy))
    zeros = ssd.ssd_chunked_bwd(*[t.detach() for t in ts], torch.tensor(dy),
                                torch.zeros(dh.shape))
    for a, b, c in zip(via, direct, zeros):
        assert torch.equal(a, b) and torch.equal(b, c)


def test_no_h0_and_no_skip_give_no_such_gradients():
    args, dy, _ = _ssd_case(4, 1, 70, 2, 8, 1, 8, extras=False)
    got = ssd.ssd_chunked_bwd(*[None if a is None else torch.tensor(a) for a in args],
                              torch.tensor(dy))
    assert got[5] is None and got[6] is None
    assert [tuple(g.shape) for g in got[:5]] == [(1, 70, 2, 8), (1, 70, 2), (2,), (1, 70, 1, 8),
                                                 (1, 70, 1, 8)]


@pytest.mark.parametrize("dtype,t,tensor_cores", [
    (torch.bfloat16, 4096, True), (torch.bfloat16, 2, True), (torch.bfloat16, 1, True),
    (torch.float32, 4096, False), (torch.float32, 1, False)])
def test_backward_route_follows_type_and_length(dtype, t, tensor_cores):
    """bf16 at every T takes the tensor-core passes of ``csrc/ssd_bwd.cu``
    (hi + lo bf16 states, dB / dC whole from the chunk pass, the heads' sums
    alone); float32 the CUDA-core passes, with per-head dB / dC and their
    sums.  Each entry point is one of the source's C functions, the source
    has no other bf16 backward, and the scratch is the route's: hi + lo bf16
    states and no per-head dB / dC on the tensor cores."""
    import re
    from pathlib import Path

    names = ssd.bwd_entry_points(dtype)
    if tensor_cores:
        assert names == ("ssd_bwd_states_bf16_mma", "ssd_bwd_chunks_bf16_mma",
                         "ssd_bwd_reduce_heads")
    else:
        assert names == ("ssd_bwd_states_f32", "ssd_bwd_chunks_f32", "ssd_bwd_reduce_f32")
    source = (Path(ssd.__file__).parent / "csrc" / "ssd_bwd.cu").read_text()
    for name in names:
        assert f"int {name}(" in source, name
    entries = re.findall(r"^int (ssd_bwd_(?:states|chunks|reduce)_\w+)\(", source, re.M)
    assert sorted(entries) == sorted(
        ssd.bwd_entry_points(torch.bfloat16) + ssd.bwd_entry_points(torch.float32))
    scratch = ssd.bwd_scratch(dtype, 2, t, 4, 64, 128)
    nc = -(-t // ssd.CHUNK)
    state = ((2, 4, nc, 2, 64, 128), torch.bfloat16) if tensor_cores else \
        ((2, 4, nc, 64, 128), torch.float32)
    assert scratch["states"] == scratch["dstates"] == state
    assert scratch["head_part"] == ((2, 2, 4, nc), torch.float32)
    assert ("db_part" in scratch) == ("dc_part" in scratch) == (not tensor_cores)


def test_serving_takes_the_no_grad_path_and_counts_nothing():
    """Under no_grad (all serving) ``ssd_chunked`` runs the plain forward
    directly, no autograd node; with a gradient it is differentiable."""
    args, _, _ = _ssd_case(5, 1, 20, 2, 4, 1, 4)
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    with torch.no_grad():
        y, _ = ssd.ssd_chunked(*ts)
    assert y.grad_fn is None
    y2, _ = ssd.ssd_chunked(*ts)
    assert y2.grad_fn is not None and torch.equal(y, y2.detach())
    assert ssd.ssd_chunked.launches == 0 and ssd.ssd_chunked_bwd.launches == 0


# ---- mamba2-780m's training step against the reference ---------------------
@pytest.mark.parametrize("seq,dt_bias", [(128, None), (256, -3.0)])
def test_mamba2_train_step_matches_the_reference_in_float32(seq, dt_bias):
    ref_cfg, cfg = ref_get_smoke_config(ARCH), get_smoke_config(ARCH)
    assert cfg.dtype == "float32" and dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    check_supported(cfg)
    params = ref_arch_init_params(ref_cfg, jax.random.PRNGKey(0))
    if dt_bias is not None:
        params["layers"]["ssm"]["dt_bias"] = jnp.full_like(params["layers"]["ssm"]["dt_bias"],
                                                           dt_bias)
    tree = jax.tree.map(np.asarray, params)
    np_batch = RefSyntheticLM(ref_cfg, batch=2, seq_len=seq, seed=3).batch_at(0)

    def loss_fn(p):
        logits = ref_arch_forward(ref_cfg, p, {k: jnp.asarray(v) for k, v in np_batch.items()})
        return ref_cross_entropy_loss(ref_cfg, logits, jnp.asarray(np_batch["labels"]))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    model = Decoder(cfg, device="cpu", master=True)
    model.load_state_dict(convert.model_params_from_arrays(cfg, tree))
    batch = {k: torch.as_tensor(v).long() for k, v in np_batch.items()}
    got = cross_entropy_loss(cfg, arch_forward(cfg, model, batch), batch["labels"])
    got.backward()
    assert abs(float(got.detach()) - float(loss)) / abs(float(loss)) < LOSS_TOL
    got_tree = convert.model_params_to_arrays(cfg, {k: p.grad for k, p in
                                                    model.named_parameters()})
    want = jax.tree_util.tree_leaves_with_path(grads)
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got_tree))
    assert len(got_leaves) == len(want)
    for path, w in want:
        w = np.asarray(w)
        assert np.all(np.isfinite(w)), jax.tree_util.keystr(path)
        err = _rel(got_leaves[path], w)
        assert err < GRAD_TOL, (jax.tree_util.keystr(path), err)
    # and back: the port's gradients as the reference's tree, then as the
    # port's parameters again
    back = convert.model_params_from_arrays(cfg, got_tree)
    assert all(torch.equal(back[k], p.grad) for k, p in model.named_parameters())


# ---- the residency plan's lowering of ssm_out --------------------------------
def _loss_and_grads(cfg, model, batch, policy):
    for p in model.parameters():
        p.grad = None
    loss = cross_entropy_loss(cfg, arch_forward(cfg, model, batch, remat_policy=policy),
                              batch["labels"])
    loss.backward()
    if policy is not None:
        policy.clear()
    return loss.detach(), [p.grad.clone() for p in model.parameters()]


@pytest.fixture(scope="module")
def mamba2_smoke():
    cfg = get_smoke_config(ARCH)
    model = arch_init_params(cfg, torch.Generator().manual_seed(0), device="cpu", master=True)
    batch = {k: torch.as_tensor(v).long()
             for k, v in SyntheticLM(cfg, batch=2, seq_len=80, seed=1).batch_at(0).items()}
    base = _loss_and_grads(dataclasses.replace(cfg, remat="none"), model, batch, None)
    return cfg, model, batch, base


def _same(a, b) -> bool:
    return torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


@pytest.mark.parametrize("name", ["ssm_out", "resid_mid", "resid_out"])
@pytest.mark.parametrize("tier", ["keep", "offload", "remat"])
def test_ssm_out_keep_offload_remat_is_exact_and_counted(mamba2_smoke, name, tier):
    """The smoke model's four SSD layers run in two regions of two (the
    default scan group), so a recomputed layer runs three times (first
    forward, the group's replay, its own) and a held K4 output is computed
    once and handed back twice."""
    cfg, model, batch, base = mamba2_smoke
    assert classes_of(cfg) == {"ssm_out", "resid_mid", "resid_out"}
    others = tuple(sorted(classes_of(cfg) - {name}))
    policy = {"keep": Residency((name,)), "offload": Residency((), (name,)),
              "remat": Residency(others)}[tier]
    assert _same(_loss_and_grads(cfg, model, batch, policy), base)
    held = (name == "ssm_out") == (tier != "remat")
    assert policy.computed["ssm_out"] == (4 if held else 12)
    assert policy.replayed["ssm_out"] == (8 if held else 0)
    assert policy.seen["ssm_out"] == 12
    assert policy.computed["ssm_out"] == kernel_forwards(cfg, None, policy)["ssm_out"]
    # an offloaded K4 output: y (2 x 80 x 256, fp32) and h_last (2 x 16 x 16 x 16)
    want = 4 * (2 * 80 * 256 + 2 * 16 * 16 * 16) * 4 if (tier, name) == ("offload", "ssm_out") \
        else 0
    assert policy.offloaded_bytes == want


def test_a_plan_that_keeps_every_ssm_class_recomputes_nothing(mamba2_smoke):
    cfg, model, batch, base = mamba2_smoke
    policy = Residency(tuple(classes_of(cfg)))
    assert policy.recomputes_nothing(cfg)
    assert _same(_loss_and_grads(cfg, model, batch, policy), base)
    assert dict(policy.computed) == {"ssm_out": 4} and not policy.replayed


# ---- the launcher ----------------------------------------------------------
def test_launcher_trains_mamba2_and_recovers(tmp_path, capsys):
    argv = ["--arch", ARCH, "--smoke", "--steps", "5", "--device", "cpu", "--batch", "2",
            "--seq", "96", "--log-every", "1", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path / "a")]
    seen = []
    clean = train_main(argv, on_step=lambda s, m, dt: seen.append(float(m["loss"])))
    out = capsys.readouterr().out
    assert clean.step == 5 and "[plan] planner=greedy" in out and "restarts=0" in out
    assert all(np.isfinite(seen)) and seen[-1] < seen[0]
    failed = []
    drill = train_main(argv[:-1] + [str(tmp_path / "b"), "--fail-at", "3", "4"],
                       on_step=lambda s, m, dt: failed.append((s, float(m["loss"]))))
    assert "restarts=2" in capsys.readouterr().out
    assert [dict(failed)[s] for s in range(1, 6)] == seen
    for k, p in clean.params.items():
        assert torch.equal(p, drill.params[k]), k
