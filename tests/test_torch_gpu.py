"""Tests of the port that need an NVIDIA GPU and ``nvcc``: the CUDA
schedule-DP kernel against its plain PyTorch version, bit for bit, the
evaluator on the card against the NumPy engine, the flash-attention kernel
(2e-5 in float32, 2e-2 in bfloat16, LSE 1e-5; bfloat16 on the tensor cores,
float32 on the CUDA cores), the RG-LRU scan kernel (bit for bit) and the
Mamba-2 SSD kernel (1e-4 relative in float32; y 2e-2 relative, h_last 1e-4
with bfloat16 x/B/C, a prefill on the tensor cores) against their plain
versions, which kernel each input takes (the entry point its wrapper resolves), and
K2's backward (1e-5 / 2e-2 of max |grad|), K3's (bit for bit) and K4's (1e-4 /
2e-2 of max |grad|, bit-identical repeats) against their plain versions,
smoke-size recurrentgemma-2b and mamba2-780m training steps on the card
against the CPU,
smoke-size recurrentgemma-2b, mamba2-780m, qwen2.5-14b, granite-moe-1b-a400m,
mixtral-8x7b, whisper-medium and internvl2-26b models served on the card
against the CPU (same ids, logits within 1e-4), and the
device-resident search (its round captured as a CUDA graph) against the same
search on the CPU, bit for bit, crashed and resumed from a checkpoint on the
card, with its sequential prefix-sum kernel against
``np.cumsum``; the solve service served on the card against solo solves on
the card, two threads running one launch shape at once, and the analysis
CLI's ``certify`` through the torch and device backends on the card.  They import
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
# groups of 2 and 10 q heads per kv head, the serving head_dim with MQA, and
# the global-attention decoders' d 128, causal, no window: qwen2.5-14b's
# 40:8 heads (a group of 5 straddles the 128-row tile) and an MHA 32:32
FLASH_BF16_CASES = [
    (2, 200, 200, 4, 2, 72, True, None, 0),
    (2, 130, 130, 4, 2, 64, True, 64, 0),
    (1, 333, 333, 10, 1, 72, True, 100, 0),
    (2, 150, 150, 4, 2, 40, False, None, 0),
    (1, 512, 512, 10, 1, 256, True, 256, 0),
    (2, 300, 300, 40, 8, 128, True, None, 0),
    (1, 257, 257, 32, 32, 128, True, None, 0),
    # the MoE / encoder-decoder / vision slice: d 64 GQA 16:8 (granite);
    # d 64 MHA non-causal over 1500 rows, 11 x 128 + 92 (whisper's encoder),
    # and from 200 rows over those 1500 (its cross-attention, Sq != Skv); a
    # group of 6 across the 128-row tile (internvl2's 48:8)
    (2, 300, 300, 16, 8, 64, True, None, 0),
    (1, 1500, 1500, 16, 16, 64, False, None, 0),
    (2, 200, 1500, 16, 16, 64, False, None, 0),
    (2, 300, 300, 48, 8, 128, True, None, 0),
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
    """The forward entry point's three kernels: the pipelined scan with
    16-byte and with element copies, and the single step; the backward
    entry point's reverse scan in each group (8 and 32 channels a warp),
    with either copy; and the probe of the backward's dependent chain."""
    kernels = _entry_kernels("rglru")
    assert sum("rglru_scan_kernelILb1E" in k for k in kernels) == 1
    assert sum("rglru_scan_kernelILb0E" in k for k in kernels) == 1
    assert sum("rglru_scan_step_kernel" in k for k in kernels) == 1
    for group in (8, 32):
        assert sum(f"rglru_scan_bwd_kernelILi{group}ELb1E" in k for k in kernels) == 1
        assert sum(f"rglru_scan_bwd_kernelILi{group}ELb0E" in k for k in kernels) == 1
    assert sum("bwd_chain_probe_kernel" in k for k in kernels) == 1 and len(kernels) == 8


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
    res = serve(cfg, model, {"tokens": prompts.to(cuda_device)}, 6, device=cuda_device)
    assert (fa.flash_attention.launches - before[0], rg.rglru_scan.launches - before[1]) == \
        (2, 6 * 6)       # 2 attention layers once; 6 rec layers at the prefill + 5 steps
    ref = serve(cfg, cpu_model, {"tokens": prompts}, 6, device="cpu")
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


def test_qwen_smoke_model_served_on_the_card_matches_the_cpu(cuda_device):
    """qwen2.5-14b's smoke config (global attention through K2, a linear
    cache, nonzero qkv and output biases, an untied head) on the card and on
    the CPU: the same ids, the logits within 1e-4 of max |logit| (float32)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.model_serve import serve
    from repro_torch.models import Decoder, arch_init_params

    cfg = get_smoke_config("qwen2.5-14b")
    model = arch_init_params(cfg, torch.Generator(device=cuda_device).manual_seed(3),
                             device=cuda_device)
    with torch.no_grad():
        for layer in model.layers:
            for name in ("bq", "bk", "bv", "bo"):
                getattr(layer.attn, name).normal_(
                    generator=torch.Generator(device=cuda_device).manual_seed(4))
    cpu_model = Decoder(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    prompts = torch.randint(1, cfg.vocab_size, (2, 80), generator=torch.Generator().manual_seed(0))
    before = fa.flash_attention.launches
    res = serve(cfg, model, {"tokens": prompts.to(cuda_device)}, 6, device=cuda_device)
    assert fa.flash_attention.launches - before == cfg.n_layers   # every layer's prefill
    ref = serve(cfg, cpu_model, {"tokens": prompts}, 6, device="cpu")
    assert np.array_equal(res.ids, ref.ids)
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
    res = serve(cfg, model, {"tokens": prompts.to(cuda_device)}, 6, device=cuda_device)
    assert ssd.ssd_chunked.launches - before == cfg.n_layers * 6   # prefill + 5 steps
    ref = serve(cfg, cpu_model, {"tokens": prompts}, 6, device="cpu")
    assert np.array_equal(res.ids, ref.ids)
    ids = torch.from_numpy(res.ids)
    on_card = _teacher_forced(cfg, model, prompts.to(cuda_device), ids.to(cuda_device),
                              cuda_device)
    on_cpu = _teacher_forced(cfg, cpu_model, prompts, ids, "cpu")
    for i, (got, want) in enumerate(zip(on_card, on_cpu)):
        err = float((got.cpu() - want).abs().max() / want.abs().max())
        assert err <= 1e-4, f"step {i}: card vs CPU {err:.3g} of max |logit|"


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mixtral-8x7b", "whisper-medium",
                                  "internvl2-26b"])
def test_slice_smoke_models_served_on_the_card_match_the_cpu(cuda_device, arch):
    """The MoE (granite's global attention, mixtral's ring of 64 slots that
    the 80-token prompt wraps), the encoder-decoder (32 frames, K2 over the
    encoder, the decoder and the cross-attention) and the vision-token
    decoder (8 vision embeddings) at their smoke configs, every bias drawn
    nonzero: the same ids on the card and on the CPU, K2 launched at every
    attention of the prefill only, the logits within 1e-4 of max |logit|
    (float32)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.model_serve import make_batch, serve
    from repro_torch.models import arch_init_params

    cfg = get_smoke_config(arch)
    model = arch_init_params(cfg, torch.Generator(device=cuda_device).manual_seed(3),
                             device=cuda_device)
    with torch.no_grad():
        gen = torch.Generator(device=cuda_device).manual_seed(4)
        for name, p in model.named_parameters():
            if re.search(r"(^|\.)(b[qkvio]|\w+_b)$", name):
                p.normal_(generator=gen)
    cpu_model = arch_init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    batch = make_batch(cfg, 2, 80, torch.Generator().manual_seed(0), device="cpu")
    on_dev = {k: v.to(cuda_device) for k, v in batch.items()}
    before = fa.flash_attention.launches
    res = serve(cfg, model, on_dev, 6, device=cuda_device)
    want = cfg.encoder_layers + 2 * cfg.n_layers if cfg.encoder_layers else cfg.n_layers
    assert fa.flash_attention.launches - before == want
    ref = serve(cfg, cpu_model, batch, 6, device="cpu")
    assert np.array_equal(res.ids, ref.ids)
    ids = torch.from_numpy(res.ids)
    on_card = _teacher_forced(cfg, model, on_dev, ids.to(cuda_device), cuda_device)
    on_cpu = _teacher_forced(cfg, cpu_model, batch, ids, "cpu")
    for i, (got, want) in enumerate(zip(on_card, on_cpu)):
        err = float((got.cpu() - want).abs().max() / want.abs().max())
        assert err <= 1e-4, f"step {i}: card vs CPU {err:.3g} of max |logit|"


def _teacher_forced(cfg, model, prompts, ids, device):
    """Prefill logits, then each decode step's logits, feeding ``ids``;
    ``prompts`` is the tokens or the whole batch dict."""
    from repro_torch.models import arch_decode_step
    from repro_torch.runtime import make_prefill_step

    batch = prompts if isinstance(prompts, dict) else {"tokens": prompts}
    plen, gen = batch["tokens"].shape[1], ids.shape[1]
    logits, cache = make_prefill_step(cfg, max_len=plen + gen, device=device)(model, batch)
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


@pytest.mark.parametrize("walks", [1, 8])
def test_crash_resume_on_the_card_equals_the_uncrashed_run(cuda_device, walks, tmp_path):
    """Lost at the first sync (after its checkpoint), saved, loaded and
    resumed on the card: equal to the run that never crashed, and to the
    same run on the CPU."""
    from repro_torch.faults import FaultPlan, plan_context
    from repro_torch.faults import checkpoint as ckpt
    from repro_torch.faults.errors import DeviceLost

    inst = random_instance(0, n_tasks=40, n_data=100)
    inits = [construct_greedy(inst, STRATEGIES[w % 4], rng=3 + w) for w in range(walks)]
    kw = dict(seed=3, max_unimproved=10**9, time_limit=1e9, top_k=5, max_iters=40,
              mem_update_period=ds.MEM_UPDATE_DISABLED)
    cfg = ds.DeviceConfig(sync_every=16, crit_cap=32)
    params = TSParams(torch_device="cuda", **kw)
    ref = ds.device_multiwalk(inst, [s.copy() for s in inits], params, config=cfg)
    got = []
    with plan_context(FaultPlan(seed=0, rate=1.0, kinds=("device_lost",),
                                points=("device_search.sync",))):
        with pytest.raises(DeviceLost):
            ds.device_multiwalk(inst, [s.copy() for s in inits], params, config=cfg,
                                on_checkpoint=got.append)
    path = ckpt.save(got[-1], str(tmp_path / "crash.npz"))
    resumed = ds.device_multiwalk(inst, [], params, config=cfg, resume_from=ckpt.load(path))
    _same_result(resumed, ref)
    assert resumed.device_stats["rounds_replayed"] == kw["max_iters"] - got[-1].iteration
    cpu = ds.device_multiwalk(inst, [s.copy() for s in inits],
                              TSParams(torch_device="cpu", **kw), config=cfg)
    _same_result(resumed, cpu)


def test_a_checkpoint_taken_on_the_cpu_resumes_on_the_card(cuda_device):
    """Where a run executes is not in the fingerprints: a CPU checkpoint
    resumes on the card to the CPU run's result, Algorithm 3 at syncs."""
    inst = random_instance(5, n_tasks=64, n_data=150)
    inits = [construct_greedy(inst, STRATEGIES[w % 4], rng=5 + w) for w in range(4)]
    kw = dict(seed=5, max_unimproved=12, time_limit=1e9, top_k=4, max_iters=24)
    cfg = ds.DeviceConfig(sync_every=8)
    got = []
    cpu = ds.device_multiwalk(inst, [s.copy() for s in inits],
                              TSParams(torch_device="cpu", **kw), config=cfg,
                              on_checkpoint=got.append)
    resumed = ds.device_multiwalk(inst, [], TSParams(torch_device="cuda", **kw), config=cfg,
                                  resume_from=got[0])
    _same_result(resumed, cpu)


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


# ---- the training path: K2's and K3's backwards -------------------------------
FLASH_BWD_CASES = [(2, 512, 512, 4, 2, 32, True, None, 0), (2, 512, 512, 4, 2, 32, True, 128, 0),
                   (2, 77, 90, 6, 3, 40, False, None, 0), (1, 96, 96, 8, 1, 256, True, None, -5),
                   # qwen2.5-14b's grouping (40 q heads over 8) at d 128, a short length
                   (1, 200, 200, 40, 8, 128, True, None, 0),
                   # MQA, d 256, a window, lengths that are not multiples of 64
                   (1, 333, 333, 10, 1, 256, True, 100, 0),
                   # a continuation: q_offset > 0, more keys than queries
                   (2, 150, 230, 4, 2, 64, True, None, 80),
                   # d not a multiple of 8: the bf16 kernels' element-wise loads
                   (1, 70, 70, 4, 2, 20, True, None, 0)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_flash_bwd_kernel_matches_plain_version(cuda_device, case, dtype, tol):
    """dq, dk, dv of the backward kernel against the plain backward on the same
    saved (out, lse), max |diff| / max |grad|; no-key rows get zero dq."""
    from repro_torch.kernels import flash_attention as fa

    b, sq, skv, h, kvh, d, causal, window, qoff = case
    g = torch.Generator(device=cuda_device).manual_seed(sq + d)
    q, k, v, do = (torch.randn(s, generator=g, device=cuda_device).to(dtype)
                   for s in ((b, sq, h, d), (b, skv, kvh, d), (b, skv, kvh, d), (b, sq, h, d)))
    kw = dict(causal=causal, window=window, q_offset=qoff)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 1
    want = fa.flash_attention_bwd_torch(q, k, v, out, lse, do, **kw)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype
        assert float((a.float() - w.float()).abs().max() / w.float().abs().max()) < tol
    if qoff < 0:
        assert bool((got[0][:, :-qoff] == 0).all())


def test_flash_bwd_kernel_is_deterministic(cuda_device):
    """Two calls on the same inputs give bit-identical dq, dk and dv in both
    input types (no atomics: every sum in a fixed order), and bf16 takes the
    tensor-core kernels: the library holds a dk / dv and a dq ``mma_kernel``
    for each head-dim bound and no bf16 instance of the CUDA-core ones."""
    from repro_torch.kernels import flash_attention as fa

    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device=cuda_device).manual_seed(5)
        q, do = (torch.randn((1, 333, 10, 256), generator=g, device=cuda_device).to(dtype)
                 for _ in range(2))
        k, v = (torch.randn((1, 333, 1, 256), generator=g, device=cuda_device).to(dtype)
                for _ in range(2))
        kw = dict(causal=True, window=100)
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        first = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        again = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    kernels = _entry_kernels("flash_attention_bwd")
    assert sum("flash_bwd_dkdv_mma_kernel" in k for k in kernels) == 3     # d <= 64, 128, 256
    assert sum("flash_bwd_dq_mma_kernel" in k for k in kernels) == 3
    assert not any("kernelI13__nv_bfloat16Li" in k for k in kernels)
    assert sum("kernelIfLi" in k for k in kernels) == 6                    # f32 dk/dv and dq


def _rglru_bwd_operands(b, t, d, with_h0, device):
    from repro_torch.kernels import rglru as rg

    g = torch.Generator(device=device).manual_seed(t + d)
    a = torch.rand((b, t, d), generator=g, device=device)
    xb = torch.randn((b, t, d), generator=g, device=device)
    h0 = torch.randn((b, d), generator=g, device=device) if with_h0 else None
    y = rg.scan_torch(a, xb, h0)
    dy = torch.randn((b, t, d), generator=g, device=device)
    return a, y, h0, dy, torch.randn((b, d), generator=g, device=device)


# the training shape (1, 4096, 2560) takes 8 channels a warp, its ragged twin
# a partial first tile and a ragged group, batch 4 the 32-channel grid; 31 and
# 66 are no multiple of a group
@pytest.mark.parametrize("b,t,d,with_h0", [(2, 512, 64, True), (3, 1000, 200, False),
                                           (2, 33, 31, True), (2, 1, 96, True),
                                           (1, 4096, 2560, True), (1, 4096, 2560, False),
                                           (1, 4097, 2562, True), (1, 4097, 2562, False),
                                           (1, 1, 2560, True), (1, 1, 2560, False),
                                           (4, 4096, 2560, True), (4, 4096, 2560, False),
                                           (3, 33, 66, False)])
def test_rglru_bwd_kernel_is_bit_equal_to_plain_version(cuda_device, b, t, d, with_h0):
    from repro_torch.kernels import rglru as rg

    a, y, h0, dy, dh_last = _rglru_bwd_operands(b, t, d, with_h0, cuda_device)
    for dh in (None, dh_last):
        got = rg.rglru_scan_bwd(a, y, h0, dy, dh)
        want = rg.scan_bwd_torch(a, y, h0, dy, dh)
        assert all(torch.equal(x, w) for x, w in zip(got, want))


@pytest.mark.parametrize("group", [8, 32])
@pytest.mark.parametrize("b,t,d", [(1, 4097, 2562), (2, 100, 2552), (3, 70, 31)])
def test_rglru_bwd_kernel_is_bit_equal_in_every_group(cuda_device, group, b, t, d):
    """Each group, 16-byte copies (2552) and element copies (2562, 31), is
    held bit for bit, whichever the wrapper would pick at the shape."""
    from repro_torch.kernels import rglru as rg

    a, y, h0, dy, dh = _rglru_bwd_operands(b, t, d, True, cuda_device)
    got = rg._launch_bwd_cuda(a, y, h0, dy, dh, group=group)
    want = rg.scan_bwd_torch(a, y, h0, dy, dh)
    assert all(torch.equal(x, w) for x, w in zip(got, want))


def test_rglru_bwd_kernel_repeats_bit_for_bit_at_the_training_shape(cuda_device):
    from repro_torch.kernels import rglru as rg

    a, y, h0, dy, _ = _rglru_bwd_operands(1, 4096, 2560, False, cuda_device)
    first = rg.rglru_scan_bwd(a, y, h0, dy)
    again = rg.rglru_scan_bwd(a, y, h0, dy)
    assert all(torch.equal(x, w) for x, w in zip(first, again))


def test_smoke_training_step_on_the_card_matches_the_cpu(cuda_device):
    """recurrentgemma-2b's smoke config (float32) trained one step on the card
    and on the CPU from the same parameters and batch: the loss within 1e-4
    relative and every gradient within 1e-3 of its max |grad|."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as rg
    from repro_torch.models import Decoder, arch_forward, cross_entropy_loss, init_params_
    from repro_torch.runtime import SyntheticLM

    cfg = get_smoke_config("recurrentgemma-2b")
    cpu = init_params_(Decoder(cfg, device="cpu", master=True), torch.Generator().manual_seed(0))
    gpu = Decoder(cfg, device=cuda_device, master=True)
    gpu.load_state_dict(cpu.state_dict())
    batch = {k: torch.as_tensor(v).long()
             for k, v in SyntheticLM(cfg, batch=2, seq_len=128, seed=0).batch_at(0).items()}
    out = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda_device)):
        bt = {k: v.to(dev) for k, v in batch.items()}
        loss = cross_entropy_loss(cfg, arch_forward(cfg, model, bt), bt["labels"])
        loss.backward()
        out.append((float(loss.detach()), {k: p.grad.cpu() for k, p in model.named_parameters()}))
    assert fa.flash_attention_bwd.launches > 0 and rg.rglru_scan_bwd.launches > 0
    (lc, gc), (lg, gg) = out
    assert abs(lg - lc) / abs(lc) < 1e-4
    for k in gc:
        assert float((gg[k] - gc[k]).abs().max() / gc[k].abs().max().clamp_min(1e-30)) < 1e-3, k


# K4's backward: the forward's cases and T < 64 with G < H; with h0, d_skip and
# a nonzero last-state gradient, and without them; then the edges of the
# tensor-core passes (bf16): T past a chunk boundary at full width, head_dim
# 16 and 32, state 32 and 64, G = H, 1 < G < H, and T = 1 (one chunk of one
# step)
SSD_BWD_CASES = SSD_CASES + [(2, 40, 6, 32, 3, 64), (1, 4097, 48, 64, 1, 128),
                             (2, 200, 6, 16, 2, 64), (2, 130, 4, 32, 1, 32),
                             (1, 300, 4, 64, 4, 64), (2, 1, 4, 64, 1, 128)]
SSD_GRAD_NAMES = ("dx", "ddt", "da_log", "dB", "dC", "dd_skip", "dh0")


def _ssd_bwd_inputs(case, dtype, device, with_extras, seed=0):
    args = ssd_inputs(case, dtype, device, with_extras, seed)
    b, t, h, p, g, n = case
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    dy = torch.randn((b, t, h, p), generator=gen, device=device).to(dtype)
    dh = torch.randn((b, h, p, n), generator=gen, device=device) if with_extras else None
    return args, dy, dh


@pytest.mark.parametrize("with_extras", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", SSD_BWD_CASES)
def test_ssd_bwd_kernel_matches_plain_version(cuda_device, case, dtype, tol, with_extras):
    from repro_torch.kernels import ssd

    args, dy, dh = _ssd_bwd_inputs(case, dtype, cuda_device, with_extras, seed=sum(case))
    before = ssd.ssd_chunked_bwd.launches
    got = ssd.ssd_chunked_bwd(*args, dy, dh)
    torch.cuda.synchronize()
    assert ssd.ssd_chunked_bwd.launches == before + 1
    want = ssd.ssd_chunked_bwd_torch(*args, dy, dh)
    for name, a, w in zip(SSD_GRAD_NAMES, got, want):
        assert (a is None) == (w is None), name
        if w is not None:
            # da_log of one step from a zero state is exactly 0 on both sides
            err = float((a.float() - w.float()).abs().max()
                        / w.float().abs().max().clamp_min(1e-30))
            assert a.dtype == w.dtype and a.shape == w.shape, name
            assert bool(torch.isfinite(a.float()).all()) and err < tol, name


def test_ssd_bwd_kernel_repeats_bit_for_bit_at_the_training_shape(cuda_device):
    from repro_torch.kernels import ssd

    args, dy, _ = _ssd_bwd_inputs((1, 4096, 48, 64, 1, 128), torch.bfloat16, cuda_device, False)
    first = ssd.ssd_chunked_bwd(*args, dy)
    again = ssd.ssd_chunked_bwd(*args, dy)
    assert all(torch.equal(a, b) for a, b in zip(first, again) if a is not None)


def test_ssd_gradient_through_the_models_views_launches_the_kernels(cuda_device):
    """x, B and C as bf16 views into one tensor that requires a gradient, as
    ssm_block hands them: autograd through ``ssd_chunked`` launches the
    forward and the backward once each, and every gradient is the plain
    versions' (``ssd_chunked_torch_grad``) within 2e-2 of its max |grad|."""
    from repro_torch.kernels import ssd

    b, t, h, p, n = 2, 150, 4, 16, 32
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    base = (0.5 * torch.randn((b, t, h * p + 2 * n), generator=gen, device=cuda_device)).bfloat16()
    dt0 = torch.nn.functional.softplus(torch.randn((b, t, h), generator=gen, device=cuda_device))
    al0 = 0.5 * torch.randn(h, generator=gen, device=cuda_device)
    d0 = torch.randn(h, generator=gen, device=cuda_device)
    w = torch.randn((b, t, h, p), generator=gen, device=cuda_device)

    def grads(fn):
        xbc, dt, a_log, d_skip = (v.clone().requires_grad_() for v in (base, dt0, al0, d0))
        x, bm, cm = torch.split(xbc, [h * p, n, n], dim=-1)
        y, _ = fn(x.reshape(b, t, h, p), dt, a_log, bm.reshape(b, t, 1, n),
                  cm.reshape(b, t, 1, n), d_skip)
        (y.float() * w).sum().backward()
        return [v.grad for v in (xbc, dt, a_log, d_skip)]

    fwd, bwd = ssd.ssd_chunked.launches, ssd.ssd_chunked_bwd.launches
    got = grads(ssd.ssd_chunked)
    torch.cuda.synchronize()
    assert (ssd.ssd_chunked.launches, ssd.ssd_chunked_bwd.launches) == (fwd + 1, bwd + 1)
    want = grads(ssd.ssd_chunked_torch_grad)
    assert (ssd.ssd_chunked.launches, ssd.ssd_chunked_bwd.launches) == (fwd + 1, bwd + 1)
    for a, b_ in zip(got, want):
        assert a.dtype == b_.dtype and _rel(a, b_) < 2e-2


@pytest.mark.parametrize("lead", [0, 1])
def test_ssd_bwd_kernels_take_the_models_strided_views(cuda_device, lead):
    """bf16 x, B and C as ssm_block hands them, views into the conv output
    (row stride lead + h p + 2 n), with 16-byte row starts (lead 0) and with
    every row start one element off them (lead 1, the element-by-element loads):
    the tensor-core passes' gradients are the plain backward's within 2e-2 of
    max |grad|, at mamba2-780m's width."""
    from repro_torch.kernels import ssd

    b, t, h, p, n = 1, 700, 48, 64, 128
    gen = torch.Generator(device=cuda_device).manual_seed(11 + lead)
    conv = (0.5 * torch.randn((b, t, lead + h * p + 2 * n), generator=gen,
                              device=cuda_device)).bfloat16()
    x, bm, cm = torch.split(conv[..., lead:], [h * p, n, n], dim=-1)
    x, bm, cm = x.reshape(b, t, h, p), bm.reshape(b, t, 1, n), cm.reshape(b, t, 1, n)
    dt = torch.nn.functional.softplus(torch.randn((b, t, h), generator=gen, device=cuda_device))
    a_log = 0.5 * torch.randn(h, generator=gen, device=cuda_device)
    d_skip = torch.randn(h, generator=gen, device=cuda_device)
    dy = torch.randn((b, t, h, p), generator=gen, device=cuda_device).bfloat16()
    assert x.stride()[1] == lead + h * p + 2 * n and (x.data_ptr() % 16 == 0) == (lead == 0)
    before = ssd.ssd_chunked_bwd.launches
    got = ssd.ssd_chunked_bwd(x, dt, a_log, bm, cm, d_skip, None, dy)
    torch.cuda.synchronize()
    assert ssd.ssd_chunked_bwd.launches == before + 1
    want = ssd.ssd_chunked_bwd_torch(x, dt, a_log, bm, cm, d_skip, None, dy)
    for name, a, w in zip(SSD_GRAD_NAMES, got, want):
        assert (a is None) == (w is None), name
        if w is not None:
            assert a.dtype == w.dtype and a.shape == w.shape, name
            assert bool(torch.isfinite(a.float()).all()) and _rel(a, w) < 2e-2, name


@pytest.mark.parametrize("dtype,t", [(torch.bfloat16, 300), (torch.bfloat16, 1),
                                     (torch.float32, 300)])
def test_ssd_bwd_route_follows_type_and_length(cuda_device, monkeypatch, dtype, t):
    """bf16, also a step of T = 1, resolves the tensor-core entry points,
    whose kernels are in the build log; float32 the CUDA-core ones."""
    from repro_torch.kernels import ssd

    seen, orig = [], ssd._c_bwd_fns

    def spy(names):
        seen.append(names)
        return orig(names)

    monkeypatch.setattr(ssd, "_c_bwd_fns", spy)
    args, dy, dh = _ssd_bwd_inputs((2, t, 4, 64, 1, 128), dtype, cuda_device, True, seed=t)
    got = ssd.ssd_chunked_bwd(*args, dy, dh)
    torch.cuda.synchronize()
    assert seen == [ssd.bwd_entry_points(dtype)]
    assert seen[0][0].endswith("_mma") == (dtype == torch.bfloat16)
    kernels = _entry_kernels("ssd_bwd")
    for name in ("ssd_bwd_states_mma_kernel", "ssd_bwd_chunk_mma_kernel",
                 "ssd_bwd_dbdc_mma_kernel"):
        assert sum(name in k for k in kernels) == 1, name
    want = ssd.ssd_chunked_bwd_torch(*args, dy, dh)
    for name, a, w in zip(SSD_GRAD_NAMES, got, want):
        if w is not None:
            assert _rel(a, w) < (2e-2 if dtype == torch.bfloat16 else 1e-4), name


def test_ssd_bwd_wrapper_raises_on_what_the_kernels_do_not_take(cuda_device):
    from repro_torch.kernels import ssd

    args, dy, dh = _ssd_bwd_inputs((1, 8, 2, 16, 1, 16), torch.float32, cuda_device, True)
    with pytest.raises(TypeError, match="dy"):
        ssd.ssd_chunked_bwd(*args, dy.bfloat16(), dh)
    with pytest.raises(TypeError, match="dh_last"):
        ssd.ssd_chunked_bwd(*args, dy, dh.double())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        x, dt, a_log, bm, cm, d_skip, h0 = args
        ssd.ssd_chunked_bwd(x.half(), dt, a_log, bm.half(), cm.half(), d_skip, h0, dy.half())
    with pytest.raises(ValueError, match="dy must be"):
        ssd.ssd_chunked_bwd(*args, dy[:, :4], dh)


def test_mamba2_smoke_training_step_on_the_card_matches_the_cpu(cuda_device):
    """mamba2-780m's smoke config (float32) trained one step on the card and
    on the CPU from the same parameters and batch (K4 forward and backward on
    the card): the loss within 1e-4 relative and every gradient within 1e-3
    of its max |grad|."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ssd
    from repro_torch.models import Decoder, arch_forward, cross_entropy_loss, init_params_
    from repro_torch.runtime import SyntheticLM

    cfg = get_smoke_config("mamba2-780m")
    cpu = init_params_(Decoder(cfg, device="cpu", master=True), torch.Generator().manual_seed(0))
    gpu = Decoder(cfg, device=cuda_device, master=True)
    gpu.load_state_dict(cpu.state_dict())
    batch = {k: torch.as_tensor(v).long()
             for k, v in SyntheticLM(cfg, batch=2, seq_len=200, seed=0).batch_at(0).items()}
    before = ssd.ssd_chunked_bwd.launches
    out = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda_device)):
        bt = {k: v.to(dev) for k, v in batch.items()}
        loss = cross_entropy_loss(cfg, arch_forward(cfg, model, bt), bt["labels"])
        loss.backward()
        out.append((float(loss.detach()), {k: p.grad.cpu() for k, p in model.named_parameters()}))
    assert ssd.ssd_chunked_bwd.launches == before + cfg.n_layers
    (lc, gc), (lg, gg) = out
    assert abs(lg - lc) / abs(lc) < 1e-4
    for k in gc:
        assert float((gg[k] - gc[k]).abs().max() / gc[k].abs().max().clamp_min(1e-30)) < 1e-3, k


def test_cli_certify_on_the_card(cuda_device, tmp_path):
    """``python -m repro_torch.analysis certify`` on the card: the torch
    backend (K1) and the device backend (the captured round) certify the
    smoke suite, the torch rows equal to the same run on the CPU, bit for
    bit, and the kernels counted."""
    import json

    from repro_torch.analysis.cli import main

    base = ["certify", "--suite", "smoke", "--max-iters", "4"]
    rows = {}
    for backend, dev in (("torch", "cpu"), ("torch", "cuda"), ("device", "cuda")):
        sdp.sweep.launches = sdp.seq_cumsum.launches = 0
        report = tmp_path / f"{backend}-{dev}.json"
        assert main([*base, "--backend", backend, "--torch-device", dev,
                     "--report", str(report)]) == 0
        got = json.loads(report.read_text())
        assert got["n_failed"] == 0 and len(got["rows"]) == 7
        rows[backend, dev] = [(r["makespan"], r["history"]) for r in got["rows"]]
        if dev == "cuda":
            assert sdp.sweep.launches > 0
        if backend == "device":
            assert sdp.seq_cumsum.launches > 0
    assert rows["torch", "cuda"] == rows["torch", "cpu"]


def test_one_rank_nccl_sharded_train_step_equals_the_unsharded_step(cuda_device):
    """The multi-device layer on the card: qwen2.5-14b's smoke model trained
    with DTensor parameters on a one-rank NCCL ("data", "model") mesh of
    shape (1, 1) under its rules; the loss and every gradient equal the
    unsharded step's bit for bit, K2 and K2 bwd launched through
    ``local_map``, and a second, optimizer step finite."""
    import socket

    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import (Decoder, arch_forward, cross_entropy_loss,
                                    distribute_params, init_params_)
    from repro_torch.runtime import SyntheticLM, TrainState, adamw, make_train_step
    from repro_torch.runtime.train import shard_batch
    from repro_torch.sharding import make_rules, set_mesh
    from repro_torch.sharding.partitioning import active

    cfg = get_smoke_config("qwen2.5-14b")
    batch = {k: torch.as_tensor(v, device=cuda_device).long()
             for k, v in SyntheticLM(cfg, batch=2, seq_len=64, seed=0).batch_at(0).items()}

    def build():
        return init_params_(Decoder(cfg, device=cuda_device, master=True),
                            torch.Generator(device=cuda_device).manual_seed(0))

    model = build()
    k2, k2b = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    loss = cross_entropy_loss(cfg, arch_forward(cfg, model, batch), batch["labels"])
    loss.backward()
    want_launches = (fa.flash_attention.launches - k2, fa.flash_attention_bwd.launches - k2b)
    want = {k: p.grad.clone() for k, p in model.named_parameters()}
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        rules = make_rules(shard_heads=True, batch_axes=("data",))
        set_mesh(mesh)
        sharded = distribute_params(build(), mesh, rules)
        k2, k2b = fa.flash_attention.launches, fa.flash_attention_bwd.launches
        with active(rules):
            placed = shard_batch(batch, mesh, rules)
            got = cross_entropy_loss(cfg, arch_forward(cfg, sharded, placed, rules=rules),
                                     placed["labels"])
            got.backward()
        # the forward's K2 runs again in each recompute region's replay
        assert (fa.flash_attention.launches - k2, fa.flash_attention_bwd.launches - k2b) \
            == want_launches and want_launches[1] == cfg.n_layers
        assert torch.equal(got.full_tensor(), loss)
        for k, p in sharded.named_parameters():
            assert torch.equal(p.grad.to_local(), want[k]), k
        params = dict(sharded.named_parameters())
        opt = adamw()
        _, m = make_train_step(cfg, opt, sharded, rules=rules)(
            TrainState(params, opt.init(params), 0), batch)
        assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    finally:
        set_mesh(None)
        dist.destroy_process_group()
