"""The MoE's sparse top-k dispatch (``kernels/moe_dispatch.py``) and which
dispatch the block takes (``models/blocks.py`` ``moe_branch``).

On the CPU, in float32: the order of the pairs; each plain version
(permute, grouped products, combine) and its backward against the same
function written as a dense einsum over one-hot or per-row expert weights;
the sparse path assembled from the plain versions against the block's dense
dispatch on the same weights and routing (output and the gradients of x,
the router and every expert weight), with experts that receive no token,
tied router logits, ``top_k == n_experts`` and a single token; the counters
on the sparse path; the branch each kind of input takes.

On the card (``gpu``; bf16 at granite-moe-1b-a400m's shapes): each kernel
against its plain version, forward and backward, two runs bit-equal and
the launch counters moved; and a training step of the smoke MoE in bf16
under ``torch.cuda.set_sync_debug_mode("error")``, so the dispatch reads
nothing back to the host.  Run there with::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_moe_sparse.py
"""
import dataclasses
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import moe_dispatch as md
from repro_torch.models import arch_init_params, blocks

torch.set_num_threads(1)

ARCH = "granite-moe-1b-a400m"
TOL = 1e-5


def _rel(a, b) -> float:
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _ids(n, k, e, seed):
    """(n, k) distinct expert ids a token, from random logits."""
    gen = torch.Generator().manual_seed(seed)
    return torch.topk(torch.randn((n, e), generator=gen), k, dim=-1).indices


# -- the order ---------------------------------------------------------------


@pytest.mark.parametrize("n,k,e", [(24, 2, 4), (1, 2, 4), (5, 4, 4), (7, 3, 16)])
def test_the_order_sorts_the_pairs_by_expert_stably(n, k, e):
    top_i = _ids(n, k, e, seed=n + k + e)
    order = md.moe_order(top_i, e)
    assert all(t.dtype == torch.int32 for t in order)
    tok, rop, off = (t.long() for t in order)
    flat = top_i.reshape(-1)
    assert sorted(rop.reshape(-1).tolist()) == list(range(n * k))
    pair_of_row = torch.empty(n * k, dtype=torch.long)
    pair_of_row[rop.reshape(-1)] = torch.arange(n * k)
    assert torch.equal(tok, pair_of_row // k)
    assert off.tolist() == [0] + torch.cumsum(torch.bincount(flat, minlength=e), 0).tolist()
    expert_of_row = flat[pair_of_row]
    for ex in range(e):
        assert (expert_of_row[off[ex]:off[ex + 1]] == ex).all()
        # stable: an expert's rows in (token, slot) order
        rows = pair_of_row[off[ex]:off[ex + 1]].tolist()
        assert rows == sorted(rows)


# -- each plain version against its dense einsum -----------------------------


def _expert_of_row(order, e):
    off = order.offsets.tolist()
    return torch.repeat_interleave(torch.arange(e), torch.tensor(off[1:]) - torch.tensor(off[:-1]))


def _case(n=24, k=2, e=4, d=16, f=12, seed=0):
    top_i = _ids(n, k, e, seed)
    order = md.moe_order(top_i, e)
    gen = torch.Generator().manual_seed(seed + 1)
    return order, gen, (n, k, e, d, f)


def _permute(order, gen, shape):
    n, k, e, d, _ = shape
    x = torch.randn((n, d), generator=gen, requires_grad=True)
    onehot = torch.nn.functional.one_hot(order.token_of_row.long(), n).float()    # (R, N)
    return (lambda: md.moe_permute(x, order)), (lambda: torch.einsum("rn,nd->rd", onehot, x)), \
        (x,)


def _grouped(order, gen, shape):
    n, k, e, d, f = shape
    a = torch.randn((n * k, d), generator=gen, requires_grad=True)
    w = torch.randn((e, d, f), generator=gen, requires_grad=True)
    sel = torch.nn.functional.one_hot(_expert_of_row(order, e), e).float()       # (R, E)
    return (lambda: md.grouped_mm(a, w, order.offsets)), \
        (lambda: torch.einsum("rk,ekf,re->rf", a, w, sel)), (a, w)


def _combine(order, gen, shape):
    n, k, e, d, _ = shape
    y = torch.randn((n * k, d), generator=gen, requires_grad=True)
    gate = torch.softmax(torch.randn((n, k), generator=gen), -1).requires_grad_()
    onehot = torch.nn.functional.one_hot(order.row_of_pair.long(), n * k).float()  # (N, k, R)
    return (lambda: md.moe_combine(y, gate, order)), \
        (lambda: torch.einsum("tjr,rd,tj->td", onehot, y, gate)), (y, gate)


def _grouped_pair(order, gen, shape):
    """The gate and up products as one: ``a @ [wg[e] | wi[e]]``."""
    n, k, e, d, f = shape
    a = torch.randn((n * k, d), generator=gen, requires_grad=True)
    wg, wi = (torch.randn((e, d, f), generator=gen, requires_grad=True) for _ in range(2))
    sel = torch.nn.functional.one_hot(_expert_of_row(order, e), e).float()       # (R, E)
    return (lambda: md.grouped_mm(a, wg, order.offsets, wi)), \
        (lambda: torch.einsum("rk,ekf,re->rf", a, torch.cat([wg, wi], 2), sel)), (a, wg, wi)


def _swiglu(order, gen, shape):
    n, k, _, _, f = shape
    gu = torch.randn((n * k, 2 * f), generator=gen, requires_grad=True)
    return (lambda: md.moe_swiglu(gu)), \
        (lambda: torch.nn.functional.silu(gu[:, :f]) * gu[:, f:]), (gu,)


@pytest.mark.parametrize("shape", [dict(), dict(n=1), dict(n=3, k=4, e=4), dict(n=6, e=16)],
                         ids=["routed", "one-token", "all-experts", "idle-experts"])
@pytest.mark.parametrize("op", [_permute, _grouped, _grouped_pair, _swiglu, _combine],
                         ids=["permute", "grouped_mm", "grouped_mm-pair", "swiglu", "combine"])
def test_each_plain_version_and_its_backward_equal_the_dense_einsum(op, shape):
    order, gen, dims = _case(**shape)
    sparse, dense, inputs = op(order, gen, dims)
    got, want = sparse(), dense()
    assert got.shape == want.shape and _rel(got, want) < TOL
    g = torch.randn(got.shape, generator=gen)
    grads = torch.autograd.grad(got, inputs, g)
    wants = torch.autograd.grad(want, inputs, g)
    for a, b in zip(grads, wants):
        assert a.shape == b.shape and _rel(a, b) < TOL


def test_an_expert_with_no_rows_gets_a_zero_weight_gradient():
    order = md.moe_order(torch.tensor([[0, 2], [2, 0], [0, 2]]), 4)
    assert order.offsets.tolist() == [0, 3, 3, 6, 6]
    gen = torch.Generator().manual_seed(3)
    a, g = torch.randn((6, 5), generator=gen), torch.randn((6, 7), generator=gen)
    dw = md.grouped_mm_wgrad(a, g, order.offsets)
    assert dw.shape == (4, 5, 7)
    assert not dw[1].any() and not dw[3].any() and dw[0].abs().sum() > 0
    assert _rel(dw[2], a[3:6].t() @ g[3:6]) < TOL
    dw0, dw1 = md.grouped_mm_wgrad(a, g[:, :6], order.offsets, split=3)
    assert torch.equal(dw0, md.grouped_mm_wgrad(a, g[:, :3], order.offsets))
    assert torch.equal(dw1, md.grouped_mm_wgrad(a, g[:, 3:6], order.offsets))


# -- the sparse path against the dense dispatch ------------------------------


def _pinned(monkeypatch, ids):
    """Route every token to ``ids (B, S, k)`` on both dispatches."""
    orig = blocks.moe_route

    def route(cfg, p, x):
        logits, _ = orig(cfg, p, x)
        return logits, ids

    monkeypatch.setattr(blocks, "moe_route", route)


def _smoke(**changes):
    cfg = dataclasses.replace(get_smoke_config(ARCH), **changes)
    model = arch_init_params(cfg, torch.Generator().manual_seed(0), device="cpu", master=True)
    return cfg, model.layers[0].mlp


CASES = {
    "routed": (dict(), (2, 24)),
    "single-token": (dict(), (1, 1)),
    "top_k-equals-n_experts": (dict(top_k=4), (2, 9)),
    "idle-experts": (dict(), (2, 8)),
    "ties": (dict(), (2, 8)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_the_sparse_path_equals_the_dense_dispatch(case, monkeypatch):
    changes, (b, s) = CASES[case]
    cfg, mlp = _smoke(**changes)
    gen = torch.Generator().manual_seed(11)
    x = torch.randn((b, s, cfg.d_model), generator=gen, requires_grad=True)
    if case == "idle-experts":        # every token to experts 1 and 3 of 4
        _pinned(monkeypatch, torch.tensor([3, 1]).expand(b, s, 2))
    if case == "ties":                # experts 0 and 2 tie on every token
        with torch.no_grad():
            mlp.master("router")[:, 2] = mlp.master("router")[:, 0]
        logits, top_i = blocks.moe_route(cfg, mlp, x)
        assert torch.equal(logits[..., 0], logits[..., 2])
    dout = torch.randn((b, s, cfg.d_model), generator=gen)
    params = dict(mlp.named_parameters())
    got = {}
    for branch in ("dense", "sparse"):
        logits, out = blocks._moe(cfg, mlp, x, None, branch)
        grads = torch.autograd.grad(out, [x, *params.values()], dout)
        got[branch] = (out, dict(zip(["x", *params], grads)))
    (out_d, g_d), (out_s, g_s) = got["dense"], got["sparse"]
    assert _rel(out_s, out_d) < TOL
    assert set(g_s) == {"x", "router", "wg", "wi", "wo"}
    for name in g_d:
        assert _rel(g_s[name], g_d[name]) < TOL, name
    if case == "idle-experts":
        for name in ("wi", "wo"):
            assert not g_s[name][0].any() and not g_s[name][2].any()


@pytest.mark.parametrize("changes", [dict(act="gelu"), dict(glu=False)], ids=["gelu", "non-GLU"])
def test_the_sparse_path_takes_swiglu_experts_only(changes):
    cfg, mlp = _smoke(**changes)
    x = torch.randn((1, 4, cfg.d_model))
    with pytest.raises(ValueError, match="SwiGLU"):
        blocks._moe(cfg, mlp, x, None, "sparse")


def test_the_sparse_path_counts_the_rows_it_runs(monkeypatch):
    cfg, mlp = _smoke()
    b, s = 2, 12
    x = torch.randn((b, s, cfg.d_model), generator=torch.Generator().manual_seed(5))
    counts = {}
    for branch in ("dense", "sparse"):
        monkeypatch.setattr(blocks, "moe_branch", lambda cfg, p, x, branch=branch: branch)
        with profile(activities=[ProfilerActivity.CPU]):
            blocks.moe(cfg, mlp, x)
        counts[branch] = tracing.summary()["counts"]
    assert counts["sparse"] == {"moe.pairs_routed": b * s * cfg.top_k,
                                "moe.pairs_computed": b * s * cfg.top_k}
    assert counts["dense"] == {"moe.pairs_routed": b * s * cfg.top_k,
                               "moe.pairs_computed": b * s * cfg.n_experts}


# -- which dispatch each input takes ------------------------------------------


@pytest.fixture
def fake_world():
    import torch.distributed as dist

    from repro_torch.launch.dryrun import fake_world as make

    make(2)
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _input(kind, cfg, mlp, request):
    """``(p, x)`` of one kind of input."""
    x = torch.zeros((1, 4, cfg.d_model))
    if kind in ("cuda-bf16", "cuda-float32"):
        request.getfixturevalue("monkeypatch").setattr(
            torch.Tensor, "is_cuda", property(lambda self: True))
        return mlp, x.to(torch.bfloat16 if kind == "cuda-bf16" else torch.float32)
    if kind == "cpu-bf16":
        return mlp, x.to(torch.bfloat16)
    if kind == "fake-cuda-bf16":
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode():
            return mlp, torch.empty((1, 4, cfg.d_model), dtype=torch.bfloat16, device="cuda")
    if kind.startswith("dtensor"):
        request.getfixturevalue("fake_world")
        from torch.distributed.tensor import DTensor, Replicate, Shard

        from repro_torch.launch.mesh import make_mesh

        mesh = make_mesh((2,), ("data",), device_type="cpu")
        on = (Shard(1),) if kind == "dtensor-seq" else (Replicate(),)
        w = {n: DTensor.from_local(getattr(mlp, n).detach(), mesh, (Replicate(),),
                                   run_check=False) for n in ("wg", "wi", "wo")}
        return types.SimpleNamespace(**w), DTensor.from_local(x, mesh, on, run_check=False)
    return mlp, x


@pytest.mark.parametrize("kind,branch", [
    ("cpu", "dense"), ("cpu-bf16", "dense"), ("cuda-bf16", "sparse"),
    ("cuda-float32", "dense"), ("fake-cuda-bf16", "dense"), ("dtensor-seq", "bmm"),
    ("dtensor-replicated", "dense")])
@pytest.mark.parametrize("arch", [ARCH, "mixtral-8x7b", "granite-gelu-experts"])
def test_moe_takes_the_branch_of_its_input(arch, kind, branch, request):
    """Every arch of the port with experts (granite, mixtral) has SwiGLU
    experts; other experts take the dense dispatch on the card too."""
    if arch == "granite-gelu-experts":
        cfg = dataclasses.replace(get_smoke_config(ARCH), act="gelu")
        branch = "dense" if branch == "sparse" else branch
    else:
        cfg = get_smoke_config(arch)
    mlp = arch_init_params(cfg, torch.Generator().manual_seed(0), device="cpu").layers[0].mlp
    p, x = _input(kind, cfg, mlp, request)
    assert blocks.moe_branch(cfg, p, x) == branch


# -- on the card ---------------------------------------------------------------

N_TOKENS, K, E, D, F = 2 * 4096, 8, 32, 1024, 512     # granite-moe-1b-a400m's training step


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _card_case(device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    top_i = torch.topk(torch.randn((N_TOKENS, E), generator=gen, device=device), K, -1).indices
    order = md.moe_order(top_i, E)

    def rand(*shape, dtype=torch.bfloat16, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=device)).to(dtype)

    return order, rand


def _twice(fn):
    """``fn()`` run twice; the launches counted; both results, equal bit for bit."""
    a = fn()
    b = fn()
    torch.cuda.synchronize()
    for u, v in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
        assert torch.equal(u, v)
    return a


@pytest.mark.gpu
def test_order_kernel_matches_its_plain_version(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    n0 = md.moe_order.launches
    for n, k, e in ((N_TOKENS, K, E), (3, 2, 8), (5, 8, 8), (1, 1, 4)):
        logits = torch.randn((n, e), generator=gen, device=cuda_device)
        top_i = torch.topk(logits, k, -1).indices
        got = _twice(lambda: md.moe_order(top_i, e))
        want = md.moe_order_torch(top_i, e)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (n, k, e)
    assert md.moe_order.launches == n0 + 8


@pytest.mark.gpu
def test_swiglu_kernels_match_their_plain_versions(cuda_device):
    order, rand = _card_case(cuda_device, 5)
    gu, dh = rand(N_TOKENS * K, 2 * F, scale=3.0), rand(N_TOKENS * K, F)
    n0, n1 = md.moe_swiglu.launches, md.moe_swiglu_bwd.launches
    h = _twice(lambda: md.moe_swiglu(gu))
    dgu = _twice(lambda: md.moe_swiglu_bwd(gu, dh))
    assert md.moe_swiglu.launches == n0 + 2 and md.moe_swiglu_bwd.launches == n1 + 2
    # both in fp32, rounded once: within a unit of bf16 rounding
    assert _rel(h.float(), md.moe_swiglu_torch(gu).float()) < 1e-2
    assert _rel(dgu.float(), md.moe_swiglu_bwd_torch(gu, dh).float()) < 1e-2


@pytest.mark.gpu
def test_permute_kernels_match_their_plain_versions(cuda_device):
    order, rand = _card_case(cuda_device, 1)
    x, dxs = rand(N_TOKENS, D), rand(N_TOKENS * K, D)
    n0, n1 = md.moe_permute.launches, md.moe_permute_bwd.launches
    got = _twice(lambda: md.moe_permute(x, order))
    dx = _twice(lambda: md.moe_permute_bwd(dxs, order.row_of_pair))
    assert md.moe_permute.launches == n0 + 2 and md.moe_permute_bwd.launches == n1 + 2
    assert torch.equal(got, md.moe_permute_torch(x, order.token_of_row))
    assert torch.equal(dx, md.moe_permute_bwd_torch(dxs, order.row_of_pair))


# (tokens, k, experts, depth, columns): granite-moe-1b-a400m's, and a ragged
# case (experts left idle, rows, depth and columns short of a tile)
GROUPED_SHAPES = {"granite": (N_TOKENS, K, E, D, F), "ragged": (37, 2, 8, 24, 40)}


@pytest.mark.gpu
@pytest.mark.parametrize("tile", sorted(md.GEMM_TILES))
@pytest.mark.parametrize("shape", list(GROUPED_SHAPES))
@pytest.mark.parametrize("pair", [True, False], ids=["gate-up", "down"])
def test_grouped_mm_kernels_match_their_plain_versions(cuda_device, monkeypatch, pair, shape,
                                                       tile):
    """The forward, the rows' gradient and the weights' (the gate and up
    products as one, or the down product; granite's down product has depth
    d_ff and d_model columns) against the plain versions in fp32 on the
    same bf16 inputs."""
    monkeypatch.setattr(md, "MM_TILE", tile)
    monkeypatch.setattr(md, "WGRAD_TILE", tile)
    n, k, e, d, f = GROUPED_SHAPES[shape]
    k_in, n_out = (d, f) if pair else (f, d)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    logits = torch.randn((n, e), generator=gen, device=cuda_device)
    if shape == "ragged":
        logits[:, ::3] = -1e9                  # experts 0, 3, 6 get no row
    order = md.moe_order(torch.topk(logits, k, -1).indices, e)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=cuda_device)).to(torch.bfloat16)

    a = rand(n * k, k_in).requires_grad_()
    ws = [rand(e, k_in, n_out, scale=k_in ** -0.5).requires_grad_() for _ in range(1 + pair)]
    g = rand(n * k, n_out * len(ws))
    n0, n1 = md.grouped_mm.launches, md.grouped_mm_wgrad.launches

    def run():
        out = md.grouped_mm(a, ws[0], order.offsets, *ws[1:])
        return (out, *torch.autograd.grad(out, [a, *ws], g))

    got = _twice(run)
    assert md.grouped_mm.launches == n0 + 4 and md.grouped_mm_wgrad.launches == n1 + 2
    a32 = a.detach().float().requires_grad_()
    ws32 = [w.detach().float().requires_grad_() for w in ws]
    out32 = md.grouped_mm_torch(a32, ws32[0], order.offsets, *ws32[1:])
    want = (out32, *torch.autograd.grad(out32, [a32, *ws32], g.float()))
    for name, x, y in zip(["out", "a", *(f"w{i}" for i in range(len(ws)))], got, want):
        assert x.dtype == torch.bfloat16 and x.shape == y.shape
        assert _rel(x.float(), y) < 1e-2, name
    if shape == "ragged":
        for w in got[2:]:
            assert not w[::3].any()


@pytest.mark.gpu
def test_combine_kernels_match_their_plain_versions(cuda_device):
    order, rand = _card_case(cuda_device, 3)
    y, dout = rand(N_TOKENS * K, D), rand(N_TOKENS, D)
    gate = torch.softmax(rand(N_TOKENS, K, dtype=torch.float32), -1)
    n0, n1 = md.moe_combine.launches, md.moe_combine_bwd.launches
    out = _twice(lambda: md.moe_combine(y, gate, order))
    dy, dgate = _twice(lambda: md.moe_combine_bwd(dout, y, gate, order.row_of_pair))
    assert md.moe_combine.launches == n0 + 2 and md.moe_combine_bwd.launches == n1 + 2
    assert _rel(out.float(), md.moe_combine_torch(y, gate, order.row_of_pair).float()) < 1e-2
    want_dy, want_dgate = md.moe_combine_bwd_torch(dout, y, gate, order.row_of_pair)
    assert torch.equal(dy, want_dy)
    assert _rel(dgate, want_dgate) < 1e-5


@pytest.mark.gpu
def test_a_moe_training_step_on_the_card_syncs_nothing(cuda_device):
    """The smoke granite in bf16 (fp32 masters): a step's MoE blocks take the
    sparse path, launch every kernel, read nothing back to the host, and two
    steps from the same state give the same bits."""
    from repro_torch.models import Decoder, init_params_
    from repro_torch.runtime import SyntheticLM, TrainState, adamw, make_train_step

    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="bfloat16")
    model = init_params_(Decoder(cfg, device=cuda_device, master=True),
                         torch.Generator(device=cuda_device).manual_seed(0))
    first = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = adamw(lr=1e-3)
    step = make_train_step(cfg, opt, model)
    batch = {k: torch.as_tensor(v).long().to(cuda_device)
             for k, v in SyntheticLM(cfg, batch=2, seq_len=256, seed=0).batch_at(0).items()}
    kernels = (md.moe_order, md.moe_permute, md.grouped_mm, md.moe_swiglu, md.moe_combine,
               md.moe_permute_bwd, md.grouped_mm_wgrad, md.moe_swiglu_bwd, md.moe_combine_bwd)
    launches = [f.launches for f in kernels]
    runs = []
    for i in range(3):
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(first[k])
        state = TrainState(dict(model.named_parameters()), opt.init(dict(model.named_parameters())),
                           0)
        if i:                         # the first step builds the kernels
            torch.cuda.set_sync_debug_mode("error")
        try:
            _, metrics = step(state, batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        runs.append((metrics["loss"].clone(),
                     {k: p.detach().clone() for k, p in model.named_parameters()}))
    after = [f.launches for f in kernels]
    assert all(b > a for a, b in zip(launches, after))
    assert torch.equal(runs[1][0], runs[2][0])
    assert all(torch.equal(runs[1][1][k], runs[2][1][k]) for k in first)
