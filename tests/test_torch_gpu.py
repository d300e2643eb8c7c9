"""Tests of the port that need an NVIDIA GPU and ``nvcc``: the CUDA
schedule-DP kernel against its plain PyTorch version, bit for bit, the
evaluator on the card against the NumPy engine, the flash-attention kernel
(2e-5 in float32, 2e-2 in bfloat16, LSE 1e-5; bfloat16 on the tensor cores,
float32 on the CUDA cores), the RG-LRU scan kernel (bit for bit) and the
Mamba-2 SSD kernel (1e-4 relative in float32; y 2e-2 relative, h_last 1e-4
with bfloat16 x/B/C, a prefill on the tensor cores) against their plain
versions, which kernel each input takes (the entry point its wrapper resolves), and
smoke-size recurrentgemma-2b and mamba2-780m models served on the card
against the CPU (same ids, logits within 1e-4), and the device-resident
search (its round captured as a CUDA graph) against the same search on the
CPU, bit for bit, with its sequential prefix-sum kernel against
``np.cumsum``; the solve service served on the card against solo solves on
the card, and two threads running one launch shape at once.  They import
the port only
(no JAX, no reference package), skip with a reason where there is no GPU,
and run on the card with::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.core import device_search as ds
from repro_torch.core import random_instance
from repro_torch.core.eval_batch import BatchEvaluator, pack_solutions
from repro_torch.core.greedy import STRATEGIES, construct_greedy
from repro_torch.core.solution import exact_schedule, heads_tails
from repro_torch.core.tabu import TSParams, _cc_moves, _n7_moves, apply_move, tabu_search
from repro_torch.kernels import schedule_dp as sdp

pytestmark = pytest.mark.gpu

EDGES = [31, 32, 33, 63, 64, 65]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: torch.cuda.is_available() is False")
    return torch.device("cuda")


def candidate_batch(seed, n_tasks, n_data=90, max_k=24):
    inst = random_instance(seed, n_tasks=n_tasks, n_data=n_data)
    sol = construct_greedy(inst, "slack_first", rng=seed)
    sched = exact_schedule(inst, sol)
    r, _, _, crit = heads_tails(inst, sol, sched)
    moves = _n7_moves(sol, crit) + _cc_moves(inst, sol, crit, r, sched.start, 5)
    cands = [sol]
    for m in moves[:: max(1, len(moves) // (max_k - 1))][: max_k - 1]:
        c = sol.copy()
        apply_move(c, m)
        cands.append(c)
    return inst, cands


def operands(inst, cands, dtype, device):
    eng = BatchEvaluator(inst, backend="numpy")
    packed = pack_solutions(inst, cands)
    dur = eng._durations(packed)
    g = sdp.dense_graph(inst)

    def up(a, fill, dt):
        out = np.full((packed.k, g.n_b), fill, dtype=dt)
        out[:, : inst.n_tasks] = a
        return torch.from_numpy(out).to(device)

    return g.to(device), up(dur, 0.0, dtype), up(packed.mpred, -1, np.int32), \
        up(packed.msucc, -1, np.int32)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_tasks", EDGES)
def test_cuda_kernel_equals_plain_version(cuda_device, n_tasks, dtype):
    inst, cands = candidate_batch(n_tasks % 7, n_tasks)
    g, dur, mpred, msucc = operands(inst, cands, dtype, cuda_device)
    for tails in (False, True):
        before = sdp.sweep.launches
        got = sdp.sweep(g, dur, mpred, msucc, tails=tails)
        torch.cuda.synchronize()
        assert sdp.sweep.launches == before + 1
        want = sdp.sweep_torch(g.pred_mat, g.succ_mat, dur, mpred, msucc, g.n, tails=tails)
        for a, b in zip(got, want):
            assert torch.equal(a, b)                    # tolerance 0


def test_cuda_backward_only_with_active_rows(cuda_device):
    inst, cands = candidate_batch(3, 65)
    g, dur, mpred, msucc = operands(inst, cands, np.float64, cuda_device)
    start, finish, _, n_done, q = sdp.sweep(g, dur, mpred, msucc, tails=True)
    active = n_done == g.n
    active[::3] = False
    got = sdp.backward_q(g, finish - start, msucc, active)
    torch.cuda.synchronize()
    want = sdp.backward_q_torch(g.succ_mat, finish - start, msucc, g.n, active[:, None])
    assert torch.equal(got, want)
    assert torch.equal(got[active], q[active]) and not got[~active].any()


def test_cuda_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    inst, cands = candidate_batch(0, 31)
    g, dur, mpred, msucc = operands(inst, cands, np.float64, cuda_device)
    with pytest.raises(TypeError, match="float32 or float64"):
        sdp.sweep(g, dur.to(torch.float16), mpred, msucc)
    with pytest.raises(ValueError, match="contiguous"):
        sdp.sweep(g, dur.t().contiguous().t(), mpred, msucc)
    with pytest.raises(ValueError, match="expected"):
        sdp.sweep(g, dur, mpred.cpu(), msucc)
    with pytest.raises(TypeError, match="DenseGraph.to"):
        sdp.sweep(sdp.dense_graph(inst), dur, mpred, msucc)
    with pytest.raises(ValueError, match="padded to"):
        sdp.sweep(g, dur[:, :16].contiguous(), mpred[:, :16].contiguous(),
                  msucc[:, :16].contiguous())
    before = sdp.sweep.launches                     # no plain route on the card:
    sdp.sweep(g, dur, mpred, msucc, tails=False)    # CUDA tensors launch the kernel
    sdp.backward_q(g, dur, msucc)
    torch.cuda.synchronize()
    assert sdp.sweep.launches == before + 2
    n_b = sdp.MAX_TASKS + 32
    wide = sdp.DenseGraph(n=n_b, n_b=n_b, pred_mat=np.full((n_b, 1), -1, np.int32),
                          succ_mat=np.full((n_b, 1), -1, np.int32)).to(cuda_device)
    links = torch.full((1, n_b), -1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="at most 8192 tasks"):
        sdp.sweep(wide, torch.ones((1, n_b), dtype=torch.float64, device=cuda_device),
                  links, links)


def scattered_graph(n, max_deg, seed, nnz=None):
    """A random DAG over ``n`` tasks (task i's predecessors drawn from the
    tasks before it) whose -1 padding is scattered through each row of
    ``pred_mat`` / ``succ_mat`` instead of trailing the real slots.  With
    ``nnz``, the DAG has exactly ``nnz`` links (``max_deg`` is then unused)."""
    rng = np.random.default_rng(seed)
    n_b = sdp.bucket(n)
    if nnz is None:
        preds = [rng.choice(i, size=min(i, int(rng.integers(0, max_deg + 1))), replace=False)
                 for i in range(n)]
    else:   # nnz distinct pairs (j, i), j < i, of the strict lower triangle
        flat = rng.choice(n * (n - 1) // 2, size=nnz, replace=False)
        i_of = np.floor((1 + np.sqrt(1 + 8 * flat)) / 2).astype(np.int64)
        i_of -= (i_of * (i_of - 1) // 2 > flat)         # guard the float sqrt
        i_of += ((i_of + 1) * i_of // 2 <= flat)
        j_of = flat - i_of * (i_of - 1) // 2
        preds = [j_of[i_of == i] for i in range(n)]
    succs = [[] for _ in range(n)]
    for i, ps in enumerate(preds):
        for j in ps:
            succs[j].append(i)

    def scatter(lists):
        width = max(len(x) for x in lists) + 3
        mat = np.full((n_b, width), -1, dtype=np.int32)
        for i, links in enumerate(lists):
            mat[i, np.sort(rng.choice(width, size=len(links), replace=False))] = links
        return mat

    return sdp.DenseGraph(n=n, n_b=n_b, pred_mat=scatter(preds), succ_mat=scatter(succs))


def machine_links(n, n_b, rows, seed):
    """Per row, the tasks dealt onto 10 cores in one order: index order (a
    topological order of ``scattered_graph``: feasible) on even rows, a random
    order (mostly cyclic) on odd rows.  Returns (mpred, msucc) (rows, n_b)."""
    rng = np.random.default_rng(seed)
    mpred = np.full((rows, n_b), -1, dtype=np.int32)
    msucc = np.full((rows, n_b), -1, dtype=np.int32)
    for r in range(rows):
        order = np.arange(n) if r % 2 == 0 else rng.permutation(n)
        core = rng.integers(0, 10, size=n)
        for c in range(10):
            chain = order[core[order] == c]
            mpred[r, chain[1:]] = chain[:-1]
            msucc[r, chain[:-1]] = chain[1:]
    return mpred, msucc


def _csr_in_smem(n_b, nnz, dtype) -> bool:
    import ctypes

    from repro_torch.kernels import _build

    fn = _build.load("schedule_dp").schedule_dp_csr_in_smem
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return bool(fn(n_b, nnz, 8 if dtype == np.float64 else 4))


# (tasks, max in-degree): scattered -1 slots with the CSR in shared memory and
# 1, 2 or 5 tasks a thread; then a graph whose CSR (~70,000 links) does not
# fit beside the row's state, so the kernel reads it from device memory
SCATTERED = [(250, 28, True), (1500, 12, True), (5000, 6, True), (2000, 70, False)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n,max_deg,fits", SCATTERED)
def test_cuda_kernel_takes_scattered_padding_and_csr_in_device_memory(
        cuda_device, n, max_deg, fits, dtype):
    g = scattered_graph(n, max_deg, seed=n)
    rows = 6
    trailing = all((row[: (row >= 0).sum()] >= 0).all() for row in g.pred_mat)
    assert not trailing                                  # padding inside the rows
    nnz = max(g.pred_csr[1].size, g.succ_csr[1].size)
    assert _csr_in_smem(g.n_b, nnz, dtype) == fits
    rng = np.random.default_rng(n)
    dur = np.zeros((rows, g.n_b), dtype=dtype)
    dur[:, :n] = rng.uniform(0.5, 5.0, size=(rows, n))
    mpred, msucc = machine_links(n, g.n_b, rows, seed=n + 1)
    dg = g.to(cuda_device)
    dur_t, mpred_t, msucc_t = (torch.from_numpy(a).to(cuda_device) for a in (dur, mpred, msucc))
    for tails in (False, True):
        before = sdp.sweep.launches
        got = sdp.sweep(dg, dur_t, mpred_t, msucc_t, tails=tails)
        torch.cuda.synchronize()
        assert sdp.sweep.launches == before + 1
        want = sdp.sweep_torch(dg.pred_mat, dg.succ_mat, dur_t, mpred_t, msucc_t, n,
                               tails=tails)
        for a, b in zip(got, want):
            assert torch.equal(a, b)                     # tolerance 0
    start, finish, _, n_done, q = want
    feasible = n_done == n
    assert 0 < int(feasible.sum()) < rows               # mixed rows
    active = feasible.clone()
    active[0] = False
    got_q = sdp.backward_q(dg, finish - start, msucc_t, active)
    torch.cuda.synchronize()
    want_q = sdp.backward_q_torch(dg.succ_mat, finish - start, msucc_t, n, active[:, None])
    assert torch.equal(got_q, want_q) and torch.equal(got_q[active], q[active])


def _boundary_links(n_b, dtype) -> int:
    """Links at which a row's shared memory (a 16-byte counter, 2 values and
    2 ints a task, n_b + 1 offsets and the links) is exactly the 232,448
    bytes one block may use on an H100."""
    es = 8 if dtype == np.float64 else 4
    return (232448 - 16 - n_b * (2 * es + 8) - (n_b + 1) * 4) // 4


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("extra,fits", [(0, True), (1, False)])
def test_cuda_kernel_at_the_shared_memory_boundary(cuda_device, dtype, extra, fits):
    """A CSR that fills the block's shared memory to the last byte stays in
    shared memory; one link more sends it to device memory.  Both launch and
    are bit-equal to the plain version in all three modes."""
    n = 2048
    nnz = _boundary_links(sdp.bucket(n), dtype) + extra
    g = scattered_graph(n, 0, seed=7, nnz=nnz)
    assert g.pred_csr[1].size == g.succ_csr[1].size == nnz
    assert _csr_in_smem(g.n_b, nnz, dtype) == fits
    rows = 4
    rng = np.random.default_rng(nnz)
    dur = np.zeros((rows, g.n_b), dtype=dtype)
    dur[:, :n] = rng.uniform(0.5, 5.0, size=(rows, n))
    mpred, msucc = machine_links(n, g.n_b, rows, seed=nnz + 1)
    dg = g.to(cuda_device)
    dur_t, mpred_t, msucc_t = (torch.from_numpy(a).to(cuda_device) for a in (dur, mpred, msucc))
    for tails in (False, True):
        got = sdp.sweep(dg, dur_t, mpred_t, msucc_t, tails=tails)
        want = sdp.sweep_torch(dg.pred_mat, dg.succ_mat, dur_t, mpred_t, msucc_t, n,
                               tails=tails)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))    # tolerance 0
    start, finish, _, n_done, q = want
    active = n_done == n
    got_q = sdp.backward_q(dg, finish - start, msucc_t, active)
    want_q = sdp.backward_q_torch(dg.succ_mat, finish - start, msucc_t, n, active[:, None])
    torch.cuda.synchronize()
    assert torch.equal(got_q, want_q)


def test_evaluator_on_the_card_equals_numpy_engine(cuda_device):
    inst, cands = candidate_batch(2, 64)
    ref = BatchEvaluator(inst, backend="numpy").evaluate(cands, tails=True, peaks=True)
    before = sdp.sweep.launches
    ev = BatchEvaluator(inst).evaluate(cands, tails=True, peaks=True)   # torch on cuda
    assert sdp.sweep.launches == before + 1
    f = ref.feasible
    assert np.array_equal(ev.feasible, f) and np.array_equal(ev.makespan, ref.makespan)
    for name in ("start", "finish", "level", "slack", "critical", "peaks"):
        assert np.array_equal(getattr(ev, name)[f], getattr(ref, name)[f]), name
    assert np.array_equal(ev.q, ref.q) and np.array_equal(ev.mem_ok, ref.mem_ok)


# --------------------------------------------------------------------------- #
# model path: K2 (flash attention), K3 (RG-LRU scan)                          #
# --------------------------------------------------------------------------- #
FLASH_CASES = [  # (b, sq, skv, h, kvh, d, causal, window, q_offset)
    (2, 256, 256, 4, 2, 64, True, None, 0),
    (2, 128, 512, 4, 1, 64, True, 128, 0),
    (1, 256, 512, 4, 4, 64, True, None, 256),
    (1, 128, 128, 8, 8, 128, False, None, 0),
    (1, 100, 1000, 2, 1, 32, True, 300, 900),
    (2, 77, 77, 10, 1, 256, True, 48, 0),
]


def _flash_inputs(case, dtype, device):
    b, sq, skv, h, kvh, d, causal, window, qoff = case
    g = torch.Generator(device=device).manual_seed(sq + skv)
    mk = lambda *shape: torch.randn(shape, generator=g, device=device).to(dtype)  # noqa: E731
    return (mk(b, sq, h, d), mk(b, skv, kvh, d), mk(b, skv, kvh, d),
            dict(causal=causal, window=window, q_offset=qoff))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain_version(cuda_device, case, dtype, tol):
    from repro_torch.kernels import flash_attention as fa

    q, k, v, kw = _flash_inputs(case, dtype, cuda_device)
    before = fa.flash_attention.launches
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want, want_lse = fa.flash_attention_torch(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)


# bf16 on the tensor cores: a ragged head_dim (72, 40: zero-padded to 80, 48),
# groups of 2 and 10 q heads per kv head, the serving head_dim with MQA
FLASH_BF16_CASES = [
    (2, 200, 200, 4, 2, 72, True, None, 0),
    (2, 130, 130, 4, 2, 64, True, 64, 0),
    (1, 333, 333, 10, 1, 72, True, 100, 0),
    (2, 150, 150, 4, 2, 40, False, None, 0),
    (1, 512, 512, 10, 1, 256, True, 256, 0),
]


@pytest.mark.parametrize("case", FLASH_BF16_CASES)
def test_flash_bf16_kernel_matches_plain_version(cuda_device, case):
    from repro_torch.kernels import flash_attention as fa

    q, k, v, kw = _flash_inputs(case, torch.bfloat16, cuda_device)
    before = fa.flash_attention.launches
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want, want_lse = fa.flash_attention_torch(q, k, v, return_lse=True, **kw)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)


def test_flash_bf16_rows_without_a_visible_key_give_zeros(cuda_device):
    """q_offset -10 with the causal mask: the first 10 positions see no key."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, _ = _flash_inputs((1, 64, 64, 4, 2, 64, True, None, 0), torch.bfloat16, cuda_device)
    out, lse = fa.flash_attention(q, k, v, causal=True, q_offset=-10, return_lse=True)
    torch.cuda.synchronize()
    want, want_lse = fa.flash_attention_torch(q, k, v, causal=True, q_offset=-10,
                                              return_lse=True)
    assert not out[:, :10].any() and bool((lse[:, :10] == -1e30).all())
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)


def test_flash_bf16_takes_rows_that_are_not_16_byte_aligned(cuda_device):
    """q one element into a wider tensor (its rows start 2 bytes off a 16-byte
    boundary) and k with an odd row stride: the kernel loads such rows
    element by element and gives what contiguous copies give."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda_device).manual_seed(5)
    wide = torch.randn((2, 130, 4, 65), generator=g, device=cuda_device).bfloat16()
    q = wide[..., 1:]
    k = torch.randn((2, 130, 2, 67), generator=g, device=cuda_device).bfloat16()[..., :64]
    v = torch.randn((2, 130, 2, 64), generator=g, device=cuda_device).bfloat16()
    out = fa.flash_attention(q, k, v, causal=True, window=50)
    again = fa.flash_attention(q.contiguous(), k.contiguous(), v, causal=True, window=50)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    want = fa.flash_attention_torch(q, k, v, causal=True, window=50)
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2, atol=2e-2)


def _entry_points(monkeypatch, module) -> list:
    """Names of the C entry points the wrapper in ``module`` resolves from now
    on (the profiler's kernel names are not used: on the card it has stopped
    recording for the rest of a process)."""
    seen, orig = [], module._c_fn

    def spy(*args):
        fn = orig(*args)
        seen.append(fn.__name__)
        return fn

    monkeypatch.setattr(module, "_c_fn", spy)
    return seen


def _entry_kernels(name: str) -> list:
    """Mangled names of the kernel functions in the library of ``name``."""
    from repro_torch.kernels import _build

    return re.findall(r"Compiling entry function '([^']+)'", _build.build_log(name))


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "flash_attention_fwd_bf16"),
                                         (torch.float32, "flash_attention_fwd_f32")])
def test_flash_takes_the_tensor_cores_in_bf16_only(cuda_device, monkeypatch, dtype, entry):
    """bf16 goes to the entry point whose only kernels are the tensor-core ones
    (the library holds no bf16 instance of the CUDA-core kernel); float32 to
    the CUDA-core kernel."""
    from repro_torch.kernels import flash_attention as fa

    seen = _entry_points(monkeypatch, fa)
    q, k, v, kw = _flash_inputs(FLASH_CASES[0], dtype, cuda_device)
    fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert seen == [entry]
    kernels = _entry_kernels("flash_attention")
    assert sum("flash_fwd_mma_kernel" in k for k in kernels) == 3          # d <= 64, 128, 256
    assert sum("flash_fwd_kernelI" in k for k in kernels) == 3
    assert len(kernels) == 6


def test_flash_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    from repro_torch.kernels import flash_attention as fa

    q, k, v, _ = _flash_inputs(FLASH_CASES[0], torch.float32, cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="q is"):
        fa.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros((1, 4, 1, 512), device=cuda_device)
        fa.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="unit stride"):
        fa.flash_attention(q.transpose(1, 3).contiguous().transpose(1, 3), k, v)
    with pytest.raises(ValueError, match="expected"):
        fa.flash_attention(q, k.cpu(), v)


# the reference's shapes, then the kernel's edges: T = 4097 (a partial last
# tile), d = 2562, 66 and 31 (rows not 16-byte aligned, lanes past d), T = 1
# and a T shorter than one tile
@pytest.mark.parametrize("b,t,d,with_h0", [(2, 512, 64, True), (3, 128, 32, False),
                                            (2, 1, 96, True), (3, 1000, 200, True),
                                            (1, 4097, 2562, True), (2, 4097, 64, False),
                                            (3, 300, 31, True), (2, 20, 66, False),
                                            (2, 1, 31, False), (2, 1, 2562, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_kernel_is_bit_equal_to_plain_version(cuda_device, b, t, d, with_h0, dtype):
    from repro_torch.kernels import rglru as rg

    g = torch.Generator(device=cuda_device).manual_seed(t + d)
    mk = lambda *shape: torch.randn(shape, generator=g, device=cuda_device)  # noqa: E731
    x, ig, ag = mk(b, t, d).to(dtype), mk(b, t, d).sigmoid().to(dtype), \
        mk(b, t, d).sigmoid().to(dtype)
    a_param, h0 = 0.1 * mk(d), (mk(b, d) if with_h0 else None)
    before = rg.rglru_scan.launches
    y, h = rg.rglru_scan(x, a_param, ig, ag, h0)
    torch.cuda.synchronize()
    assert rg.rglru_scan.launches == before + 1
    want_y, want_h = rg.rglru_scan_torch(x, a_param, ig, ag, h0)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)     # tolerance 0


def test_rglru_library_holds_the_pipelined_and_the_step_kernels(cuda_device):
    """One entry point, three kernels: the pipelined scan with 16-byte and
    with element copies, and the single step."""
    kernels = _entry_kernels("rglru")
    assert sum("rglru_scan_kernelILb1E" in k for k in kernels) == 1
    assert sum("rglru_scan_kernelILb0E" in k for k in kernels) == 1
    assert sum("rglru_scan_step_kernel" in k for k in kernels) == 1 and len(kernels) == 3


def test_smoke_model_served_on_the_card_matches_the_cpu(cuda_device):
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as rg
    from repro_torch.launch.model_serve import serve
    from repro_torch.models import Decoder, arch_init_params

    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-2b"), n_layers=8)
    model = arch_init_params(cfg, torch.Generator(device=cuda_device).manual_seed(3),
                             device=cuda_device)
    cpu_model = Decoder(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    prompts = torch.randint(1, cfg.vocab_size, (2, 80), generator=torch.Generator().manual_seed(0))
    before = (fa.flash_attention.launches, rg.rglru_scan.launches)
    res = serve(cfg, model, prompts.to(cuda_device), 6, device=cuda_device)
    assert (fa.flash_attention.launches - before[0], rg.rglru_scan.launches - before[1]) == \
        (2, 6 * 6)       # 2 attention layers once; 6 rec layers at the prefill + 5 steps
    ref = serve(cfg, cpu_model, prompts, 6, device="cpu")
    assert np.array_equal(res.ids, ref.ids)
    # the logits themselves, teacher-forced with the served ids past the ring
    # wrap (window 64 < 80 + 6): within 1e-4 of max |logit| (float32)
    ids = torch.from_numpy(res.ids)
    on_card = _teacher_forced(cfg, model, prompts.to(cuda_device), ids.to(cuda_device),
                              cuda_device)
    on_cpu = _teacher_forced(cfg, cpu_model, prompts, ids, "cpu")
    for i, (got, want) in enumerate(zip(on_card, on_cpu)):
        err = float((got.cpu() - want).abs().max() / want.abs().max())
        assert err <= 1e-4, f"step {i}: card vs CPU {err:.3g} of max |logit|"


# (b, t, h, p, g, n): the four shapes of tests/test_kernels.py::test_ssd_sweep,
# ragged T, one decode step at the serving width, a smoke-model decode step
SSD_CASES = [
    (2, 256, 4, 32, 2, 64), (1, 256, 4, 64, 1, 128), (2, 128, 8, 16, 8, 32),
    (1, 512, 2, 32, 1, 64), (2, 300, 4, 16, 2, 32), (1, 1000, 2, 64, 1, 128),
    (4, 1, 48, 64, 1, 128), (2, 1, 16, 16, 1, 16),
]


def ssd_inputs(case, dtype, device, with_extras, seed=0):
    b, t, h, p, g, n = case
    gen = torch.Generator(device=device).manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
    x = mk(b, t, h, p).to(dtype)
    dt = torch.nn.functional.softplus(mk(b, t, h))
    a_log = 0.5 * mk(h)
    bm, cm = (0.3 * mk(b, t, g, n)).to(dtype), (0.3 * mk(b, t, g, n)).to(dtype)
    d_skip = mk(h) if with_extras else None
    h0 = 0.1 * mk(b, h, p, n) if with_extras else None
    return x, dt, a_log, bm, cm, d_skip, h0


def _rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.parametrize("with_extras", [True, False])
@pytest.mark.parametrize("dtype,y_tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_kernel_matches_plain_version(cuda_device, case, dtype, y_tol, with_extras):
    from repro_torch.kernels import ssd

    args = ssd_inputs(case, dtype, cuda_device, with_extras, seed=sum(case))
    before = ssd.ssd_chunked.launches
    y, h = ssd.ssd_chunked(*args)
    torch.cuda.synchronize()
    assert ssd.ssd_chunked.launches == before + 1
    want_y, want_h = ssd.ssd_chunked_torch(*args)
    assert y.dtype == dtype and h.dtype == torch.float32
    assert _rel(y, want_y) < y_tol
    assert _rel(h, want_h) < 1e-4


def test_ssd_kernel_takes_strided_views_like_the_model_hands_it(cuda_device):
    """x, B and C as views into one (B, T, H*P + 2 N) tensor, as ssm_block
    splits them, give what contiguous copies give."""
    from repro_torch.kernels import ssd

    b, t, h, p, n = 2, 130, 4, 16, 32
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    xbc = torch.randn((b, t, h * p + 2 * n), generator=gen, device=cuda_device)
    x, bm, cm = torch.split(xbc, [h * p, n, n], dim=-1)
    x, bm, cm = x.reshape(b, t, h, p), bm.reshape(b, t, 1, n), cm.reshape(b, t, 1, n)
    dt = torch.rand((b, t, h), generator=gen, device=cuda_device)
    a_log = torch.zeros(h, device=cuda_device)
    y, hl = ssd.ssd_chunked(x, dt, a_log, bm, cm)
    y2, hl2 = ssd.ssd_chunked(x.contiguous(), dt, a_log, bm.contiguous(), cm.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(hl, hl2)


# bf16 prefills on the tensor cores: T just below, at and above a chunk (64)
# and two; head_dim 16, 32 and 64 against the kernel's 32-column slices;
# G > 1; a state N that is not a multiple of 16 (zero-padded)
SSD_BF16_CASES = [
    (2, 63, 4, 32, 2, 64), (2, 64, 4, 32, 2, 64), (2, 65, 4, 32, 2, 64), (2, 129, 4, 32, 1, 128),
    (2, 2, 4, 64, 1, 128), (1, 200, 4, 16, 1, 128), (1, 200, 8, 64, 4, 64),
    (1, 130, 4, 48, 2, 40),
]


@pytest.mark.parametrize("with_extras", [True, False])
@pytest.mark.parametrize("case", SSD_BF16_CASES)
def test_ssd_bf16_prefill_matches_plain_version(cuda_device, case, with_extras):
    from repro_torch.kernels import ssd

    args = ssd_inputs(case, torch.bfloat16, cuda_device, with_extras, seed=sum(case))
    before = ssd.ssd_chunked.launches
    y, h = ssd.ssd_chunked(*args)
    torch.cuda.synchronize()
    assert ssd.ssd_chunked.launches == before + 1
    want_y, want_h = ssd.ssd_chunked_torch(*args)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all())
    assert _rel(y, want_y) < 2e-2
    assert bool(((h - want_h).abs() <= 1e-4 * (1 + want_h.abs())).all())


def test_ssd_bf16_takes_the_models_strided_views(cuda_device):
    """bf16 x, B and C as views into one (B, T, H*P + 2 N) tensor, as ssm_block
    splits the conv output (16-byte aligned rows), and one view that is not
    16-byte aligned (loaded element by element): each gives what contiguous
    copies give, and all are within the plain version's tolerance."""
    from repro_torch.kernels import ssd

    b, t, h, p, n = 2, 300, 8, 64, 128
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    xbc = torch.randn((b, t, h * p + 2 * n), generator=gen, device=cuda_device).bfloat16()
    x, bm, cm = torch.split(xbc, [h * p, n, n], dim=-1)
    x, bm, cm = x.reshape(b, t, h, p), bm.reshape(b, t, 1, n), cm.reshape(b, t, 1, n)
    dt = torch.rand((b, t, h), generator=gen, device=cuda_device)
    a_log = torch.zeros(h, device=cuda_device)
    y, hl = ssd.ssd_chunked(x, dt, a_log, bm, cm)
    y2, hl2 = ssd.ssd_chunked(x.contiguous(), dt, a_log, bm.contiguous(), cm.contiguous())
    off = torch.randn((b, t, h, p + 1), generator=gen, device=cuda_device).bfloat16()[..., 1:]
    y3, hl3 = ssd.ssd_chunked(off, dt, a_log, bm, cm)
    y4, hl4 = ssd.ssd_chunked(off.contiguous(), dt, a_log, bm, cm)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(hl, hl2)
    assert torch.equal(y3, y4) and torch.equal(hl3, hl4)
    for got_y, got_h, xx in ((y, hl, x), (y3, hl3, off)):
        want_y, want_h = ssd.ssd_chunked_torch(xx, dt, a_log, bm, cm)
        assert _rel(got_y, want_y) < 2e-2
        assert bool(((got_h - want_h).abs() <= 1e-4 * (1 + want_h.abs())).all())


@pytest.mark.parametrize("dtype,t,entry", [
    (torch.bfloat16, 1, "ssd_chunked_bf16"), (torch.bfloat16, 2, "ssd_chunked_bf16_mma"),
    (torch.bfloat16, 300, "ssd_chunked_bf16_mma"), (torch.float32, 300, "ssd_chunked_f32")])
def test_ssd_route_follows_type_and_length(cuda_device, monkeypatch, dtype, t, entry):
    """bf16 with T >= TENSOR_CORE_MIN_T takes the tensor-core entry point; a
    bf16 decode step and float32 take the CUDA-core kernel."""
    from repro_torch.kernels import ssd

    assert ssd.on_tensor_cores(dtype, t) == entry.endswith("_mma")
    seen = _entry_points(monkeypatch, ssd)
    args = ssd_inputs((2, t, 4, 64, 1, 128), dtype, cuda_device, True, seed=t)
    y, h = ssd.ssd_chunked(*args)
    torch.cuda.synchronize()
    assert seen == [entry]
    kernels = _entry_kernels("ssd")
    assert sum("ssd_chunk_mma_kernel" in k for k in kernels) == 1 and len(kernels) == 3
    want_y, want_h = ssd.ssd_chunked_torch(*args)
    assert _rel(y, want_y) < (2e-2 if dtype == torch.bfloat16 else 1e-4)
    assert bool(((h - want_h).abs() <= 1e-4 * (1 + want_h.abs())).all())


def test_ssd_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    from repro_torch.kernels import ssd

    x, dt, a_log, bm, cm, d_skip, h0 = ssd_inputs((1, 8, 2, 16, 1, 16), torch.float32,
                                                  cuda_device, True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd.ssd_chunked(x.half(), dt, a_log, bm.half(), cm.half())
    with pytest.raises(TypeError, match="b_mat is"):
        ssd.ssd_chunked(x, dt, a_log, bm.bfloat16(), cm)
    with pytest.raises(TypeError, match="dt in float32"):
        ssd.ssd_chunked(x, dt.bfloat16(), a_log, bm, cm)
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros((1, 8, 1, 128), device=cuda_device)
        ssd.ssd_chunked(big, dt[:, :, :1], a_log[:1], bm, cm)
    with pytest.raises(ValueError, match="x is on"):
        ssd.ssd_chunked(x, dt.cpu(), a_log, bm, cm)


def test_mamba2_smoke_model_served_on_the_card_matches_the_cpu(cuda_device):
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ssd
    from repro_torch.launch.model_serve import serve
    from repro_torch.models import Decoder, arch_init_params

    cfg = get_smoke_config("mamba2-780m")
    model = arch_init_params(cfg, torch.Generator(device=cuda_device).manual_seed(3),
                             device=cuda_device)
    cpu_model = Decoder(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    prompts = torch.randint(1, cfg.vocab_size, (2, 150), generator=torch.Generator().manual_seed(0))
    before = ssd.ssd_chunked.launches
    res = serve(cfg, model, prompts.to(cuda_device), 6, device=cuda_device)
    assert ssd.ssd_chunked.launches - before == cfg.n_layers * 6   # prefill + 5 steps
    ref = serve(cfg, cpu_model, prompts, 6, device="cpu")
    assert np.array_equal(res.ids, ref.ids)
    ids = torch.from_numpy(res.ids)
    on_card = _teacher_forced(cfg, model, prompts.to(cuda_device), ids.to(cuda_device),
                              cuda_device)
    on_cpu = _teacher_forced(cfg, cpu_model, prompts, ids, "cpu")
    for i, (got, want) in enumerate(zip(on_card, on_cpu)):
        err = float((got.cpu() - want).abs().max() / want.abs().max())
        assert err <= 1e-4, f"step {i}: card vs CPU {err:.3g} of max |logit|"


def _teacher_forced(cfg, model, prompts, ids, device):
    """Prefill logits, then each decode step's logits, feeding ``ids``."""
    from repro_torch.models import arch_decode_step
    from repro_torch.runtime import make_prefill_step

    plen, gen = prompts.shape[1], ids.shape[1]
    logits, cache = make_prefill_step(cfg, max_len=plen + gen, device=device)(
        model, {"tokens": prompts})
    out = [logits.float()]
    for i in range(gen - 1):
        logits, cache = arch_decode_step(cfg, model, cache, ids[:, i:i + 1], plen + i)
        out.append(logits.float())
    return out


# --------------------------------------------------------------------------- #
# the device-resident search: the round as a CUDA graph that launches K1     #
# --------------------------------------------------------------------------- #
def _same_result(a, b):
    assert a.history == b.history
    assert a.best_makespan == b.best_makespan
    assert (a.iterations, a.n_exact_evals, a.n_approx_evals, a.n_perturbations,
            a.stop_reason) == (b.iterations, b.n_exact_evals, b.n_approx_evals,
                               b.n_perturbations, b.stop_reason)
    for wa, wb in zip(a.per_walk, b.per_walk):
        assert wa.history == wb.history and wa.best_makespan == wb.best_makespan
        assert np.array_equal(wa.best.assign, wb.best.assign)
        assert np.array_equal(wa.best.mem, wb.best.mem)
        assert wa.best.proc_seq == wb.best.proc_seq


@pytest.mark.parametrize("walks", [1, 8])
def test_device_search_on_the_card_equals_the_cpu_bit_for_bit(cuda_device, walks):
    """Two cores and four tasks: the tabu table saturates, so walks stall
    and the perturbation fires (its branch is on the card as on the CPU)."""
    inst = random_instance(0, n_tasks=4, n_data=8, n_fast_cores=1, n_slow_cores=1)
    inits = [construct_greedy(inst, STRATEGIES[w % 4], rng=3 + w) for w in range(walks)]
    kw = dict(seed=3, max_unimproved=10**6, time_limit=1e9, top_k=4, max_iters=40,
              mem_update_period=ds.MEM_UPDATE_DISABLED)
    cfg = ds.DeviceConfig(sync_every=16, crit_cap=32)
    cpu = ds.device_multiwalk(inst, [s.copy() for s in inits],
                              TSParams(torch_device="cpu", **kw), config=cfg)
    gpu = ds.device_multiwalk(inst, [s.copy() for s in inits],
                              TSParams(torch_device="cuda", **kw), config=cfg)
    assert gpu.n_perturbations > 0
    _same_result(gpu, cpu)


def test_device_search_with_alg3_at_syncs_equals_the_cpu(cuda_device):
    inst = random_instance(5, n_tasks=64, n_data=150)
    inits = [construct_greedy(inst, STRATEGIES[w % 4], rng=5 + w) for w in range(8)]
    kw = dict(seed=5, max_unimproved=12, time_limit=1e9, top_k=4, max_iters=24)
    cfg = ds.DeviceConfig(sync_every=8)
    cpu = ds.device_multiwalk(inst, [s.copy() for s in inits],
                              TSParams(torch_device="cpu", **kw), config=cfg)
    gpu = ds.device_multiwalk(inst, [s.copy() for s in inits],
                              TSParams(torch_device="cuda", **kw), config=cfg)
    _same_result(gpu, cpu)


def test_replayed_round_reads_nothing_back_and_launches_k1_as_its_code_says(cuda_device):
    inst = random_instance(1, n_tasks=48, n_data=120)
    params = TSParams(seed=1, max_unimproved=10**6, time_limit=1e9, top_k=5, max_iters=50,
                      mem_update_period=ds.MEM_UPDATE_DISABLED, torch_device="cuda")
    inits = [construct_greedy(inst, STRATEGIES[w % 4], rng=1 + w) for w in range(3)]
    k1, cs = sdp.sweep.launches, sdp.seq_cumsum.launches
    res = ds.device_multiwalk(inst, inits, params, config=ds.DeviceConfig(sync_every=16))
    st = res.device_stats
    assert st["k1_launches"] == sdp.sweep.launches - k1 > 0
    assert st["k1_per_round"] == 1 + st["chunk_cap"] + 1     # tails, J chunks, perturbation
    assert st["seq_cumsum_per_round"] == 2 * (st["k1_per_round"] - 1)
    assert sdp.seq_cumsum.launches - cs == st["seq_cumsum_launches"] > 0
    # replays alone, with every synchronising call an error
    batch = ds.InstanceBatch.from_instances([inst])
    sols, scheds = ds._start_walks([inst], [inits], params)
    launch, _ = ds._get_launch(batch, 3, params, batch.n_b, 1,
                               ds.DeviceConfig(sync_every=16), cuda_device)
    launch.load_instances(batch)
    launch.load_state({k: np.stack([v]) for k, v in
                       ds.pack_state(batch.packs[0], sols[0], scheds[0], 1).items()})
    if launch.graph is None:
        launch._capture()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            launch.graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # four rounds committed, unless the one exact-evaluation chunk overflowed
    it = int(launch.state["it"][0])
    assert it == 4 or (it < 4 and bool(launch.state["chunk_overflow"][0]))
    # the kernels the card ran in two more replays, as the profiler saw them
    ran = profiled_kernel_counts(lambda: [launch.graph.replay() for _ in range(2)])
    assert ran.get("sweep_kernel", 0) == 2 * launch.k1_per_round
    assert ran.get("seq_cumsum", 0) == 2 * launch.cumsum_per_round


def profiled_kernel_counts(fn) -> dict:
    """Launches of K1 (``sweep_kernel``) and ``seq_cumsum`` that
    ``torch.profiler`` records on the card while ``fn`` runs."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            for name in ("sweep_kernel", "seq_cumsum"):
                if name in e.key:
                    counts[name] = counts.get(name, 0) + e.count
    return counts


def test_same_bucket_instances_share_one_captured_round(cuda_device):
    """Two instances of one bucket through one cached graph, each against
    the port's NumPy search (a stale instance buffer would show)."""
    kw = dict(seed=3, max_unimproved=15, time_limit=1e9, top_k=5, max_iters=40,
              mem_update_period=ds.MEM_UPDATE_DISABLED)
    cfg = ds.DeviceConfig(sync_every=16, crit_cap=32)
    insts = [random_instance(s, n_tasks=40, n_data=100) for s in (0, 4)]
    hits = []
    for inst in insts:
        init = construct_greedy(inst, "slack_first", rng=3)
        ref = tabu_search(inst, init.copy(), TSParams(backend="numpy", **kw))
        dev = ds.device_multiwalk(inst, [init.copy()], TSParams(torch_device="cuda", **kw),
                                  config=cfg)
        assert dev.history == ref.history and dev.n_exact_evals == ref.n_exact_evals
        hits.append(ds.launch_cache_info()["hits"])
    assert hits[1] > hits[0]
    inits = [[construct_greedy(i, "slack_first", rng=3)] for i in insts]
    both = ds.solve_instances(insts, inits, TSParams(torch_device="cuda", **kw), config=cfg)
    for inst, il, res in zip(insts, inits, both):
        solo = ds.device_multiwalk(inst, [s.copy() for s in il],
                                   TSParams(torch_device="cpu", **kw), config=cfg)
        assert res.history == solo.history and res.n_exact_evals == solo.n_exact_evals


def test_warm_launches_captures_what_solve_instances_then_replays(cuda_device):
    inst = random_instance(6, n_tasks=56, n_data=130)     # a shape no other test uses
    kw = dict(seed=6, max_unimproved=15, time_limit=1e9, top_k=5, max_iters=20,
              mem_update_period=ds.MEM_UPDATE_DISABLED)
    cfg = ds.DeviceConfig(sync_every=8, crit_cap=64)
    warm = ds.warm_launches([inst], 2, TSParams(torch_device="cuda", **kw), config=cfg,
                            batch_sizes=(1,))
    assert warm["per_size"][1]["fresh"] and warm["compile_seconds"] > 0
    inits = [[construct_greedy(inst, s, rng=6) for s in ("slack_first", "r_first")]]
    res = ds.solve_instances([inst], inits, TSParams(torch_device="cuda", **kw), config=cfg)[0]
    cpu = ds.solve_instances([inst], [[s.copy() for s in inits[0]]],
                             TSParams(torch_device="cpu", **kw), config=cfg)[0]
    assert res.history == cpu.history and res.n_exact_evals == cpu.n_exact_evals
    # the warmed rounds served the run: nothing was captured again, unless
    # a round overflowed both warmed chunk counts (one and two)
    assert res.compile_seconds == 0.0 or res.device_stats["chunk_cap"] > 2


@pytest.mark.parametrize("width", [1, 31, 128, 255, 256, 257, 1280, 3072, 4096])
def test_seq_cumsum_kernel_equals_plain_version_and_numpy(cuda_device, width):
    rng = np.random.default_rng(width)
    v = rng.random((80, width)) * rng.integers(1, 15000, (80, width))
    v[:, ::7] = 0.0
    got = sdp.seq_cumsum(torch.from_numpy(v).to(cuda_device))
    torch.cuda.synchronize()
    want = np.concatenate([np.zeros((80, 1)), np.cumsum(v, axis=1)], axis=1)
    assert np.array_equal(got.cpu().numpy(), want)
    assert torch.equal(got.cpu(), sdp.seq_cumsum_torch(torch.from_numpy(v)))


# --------------------------------------------------------------------------- #
# the solve service and the device engine under threads, on the card          #
# --------------------------------------------------------------------------- #
SERVE_KW = dict(max_unimproved=10**9, time_limit=1e9, top_k=5,
                mem_update_period=ds.MEM_UPDATE_DISABLED)


def _outcome(res):
    return (res.best_makespan, res.history, res.iterations, res.n_exact_evals,
            res.best.assign.tolist(), res.best.mem.tolist(),
            [list(map(int, s)) for s in res.best.proc_seq])


def test_served_on_the_card_equals_solo_on_the_card(cuda_device):
    import asyncio

    from repro_torch import Budget, solve
    from repro_torch.serve import BatchPolicy, EngineConfig, SolveService, WarmSpec

    insts = [random_instance(s, n_tasks=40, n_data=100) for s in range(3)]
    budget = Budget(max_iters=8)
    params = TSParams(**SERVE_KW)
    cfg = EngineConfig(backend="device", sync_every=4, crit_cap=32, batch_sizes=(1, 2, 4))

    async def go():
        svc = SolveService(config=cfg, policy=BatchPolicy(max_batch=4, max_wait=0.01),
                           params=params, warm=[WarmSpec(i, 2, budget) for i in insts])
        await svc.start()
        rids = [await svc.submit(i, budget, seed=s, walks=2) for s, i in zip((3, 9, 4), insts)]
        out = [await svc.result(r) for r in rids]
        await svc.shutdown()
        return out, svc.metrics()

    results, metrics = asyncio.run(go())
    assert metrics["warmup"]["compile_seconds"] > 0 and not metrics["errors"]
    for seed, inst, rr in zip((3, 9, 4), insts, results):
        solo = solve(inst, "tabu_device", walks=2, budget=budget, seed=seed, params=params,
                     device={"sync_every": 4, "crit_cap": 32})
        assert rr.metrics["backend"] == "device"
        assert rr.metrics["launch_cache"]["misses"] == 0
        assert (rr.report.makespan, rr.report.history, rr.report.n_exact_evals) == \
            (solo.makespan, solo.history, solo.n_exact_evals)
        assert np.array_equal(rr.report.solution.assign, solo.solution.assign)
        assert rr.report.solution.proc_seq == solo.solution.proc_seq
        assert rr.metrics["launch_cache"]["k1_replayed"] == \
            rr.report.extras["device_stats"]["k1_replayed"] > 0


def test_two_threads_on_one_launch_shape_on_the_card(cuda_device):
    """Two runs of one launch shape at once, held at their first sync
    until both are inside: the second runs a launch of its own (captured
    while the first replays), and each equals its run alone."""
    import threading

    from repro_torch.core.api import multiwalk_inits

    params = TSParams(max_iters=16, **SERVE_KW)
    cfg = ds.DeviceConfig(sync_every=4, crit_cap=32)
    a = random_instance(0, n_tasks=30, n_data=70)
    b = random_instance(1, n_tasks=30, n_data=70)
    both = ds.InstanceBatch.from_instances([a, b])
    pin = dict(n_b=both.n_b, p_b=both.p_b, d_b=both.d_b, widths=both.widths, e_b=both.e_b)
    ba, bb = (ds.InstanceBatch.from_instances([i], **pin) for i in (a, b))
    assert ba.bucket_key == bb.bucket_key

    def go(batch, inst, seed, cbs=None):
        inits = [multiwalk_inits(inst, 3, seed)[0]]
        return ds.solve_instances(batch, inits, params, config=cfg, seeds=[seed],
                                  callbacks=cbs)[0]

    want = [_outcome(go(ba, a, 3)), _outcome(go(bb, b, 5))]
    barrier = threading.Barrier(2)

    class Meet:
        on_improvement = None
        met = False

        def on_iteration(self, ev):
            if not self.met:
                self.met = True
                barrier.wait(timeout=120)

    got, errors = [None, None], []
    uncached = ds.launch_cache_info()["uncached"]

    def worker(k, batch, inst, seed):
        try:
            got[k] = _outcome(go(batch, inst, seed, [Meet()]))
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=worker, args=(0, ba, a, 3)),
               threading.Thread(target=worker, args=(1, bb, b, 5))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    torch.cuda.synchronize()
    assert not errors, errors
    assert got == want
    assert ds.launch_cache_info()["uncached"] == uncached + 1
