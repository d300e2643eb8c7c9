"""The port's tracer (``repro_torch.tracing``) on the CPU at the smoke size.

Off, a train step and a serve record nothing, make no CUDA event and no
profiler range, and add no autograd node.  Under the CPU profiler
the spans nest under their parents and carry their unit, the ``repro.*``
ranges lie in the profiler's own events, the MoE block's backward is a span
of its own with the recompute regions' replays outside it, recomputes count
as backward, the counters are the shapes' products, and a new session drops
the last one's spans."""
import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as launch
from repro_torch.launch.model_serve import serve
from repro_torch.models import arch_init_params, blocks
from repro_torch.models.decoder import layer_replays

torch.set_num_threads(1)

ARCH = "granite-moe-1b-a400m"
B, SEQ = 2, 32


def _trainer(planner="none"):
    return launch.build_trainer(launch.parse_args(
        ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", str(B), "--seq", str(SEQ),
         "--planner", planner]))


def _steps(tr, n, first=1):
    state = tr.state
    for i in range(first, first + n):
        state, _ = tr.step_fn(state, tr.batch_at(i))
    tr.state = state


def _serve(cfg, model, prompt=SEQ):
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(1, cfg.vocab_size, (B, prompt), generator=gen)
    return serve(cfg, model, {"tokens": tokens}, gen=1, device="cpu")


def _recording():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def trainer():
    return _trainer()


@pytest.fixture(scope="module")
def server():
    cfg = get_smoke_config(ARCH)
    return cfg, arch_init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def _nodes(t: torch.Tensor) -> int:
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return len(seen)


def test_off_a_step_and_a_serve_record_nothing(trainer, server, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the tracer made a CUDA event or a profiler range while off")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(tracing, "_RecordFunctionFast", refuse)
    session = tracing._session
    spans, counts = list(session.spans), dict(session.counts)
    _steps(trainer, 1)
    _serve(*server)
    assert tracing._session is session and session.ended
    assert session.spans == spans and dict(session.counts) == counts


def test_off_the_moe_adds_no_autograd_node(trainer):
    """On, the block's two backward marks are its only extra nodes; off the
    graph has exactly two fewer, so the off span adds none."""
    cfg, layer = trainer.cfg, trainer.model.layers[0]
    x = torch.randn(B, SEQ, cfg.d_model, requires_grad=True)
    off = _nodes(blocks.moe(cfg, layer.mlp, x))
    with _recording():
        on = _nodes(blocks.moe(cfg, layer.mlp, x))
    assert on == off + 2
    with torch.no_grad(), _recording():
        assert blocks.moe(cfg, layer.mlp, x).grad_fn is None


def test_train_spans_nest_and_carry_their_step(trainer):
    _steps(trainer, 1)                                   # ends any earlier session
    with _recording() as prof:
        _steps(trainer, 2, first=2)
    recs = tracing.records()
    by = collections.Counter((r.name, r.parent, r.unit, r.backward) for r in recs)
    L = trainer.cfg.n_layers
    for u in (0, 1):
        assert by["repro.train.step", None, u, False] == 1
        for phase in ("forward", "backward", "optimizer"):
            assert by[f"repro.train.{phase}", "repro.train.step", u, False] == 1
        assert by["repro.moe", "repro.train.forward", u, False] == L
        assert by["repro.norm", "repro.train.forward", u, False] == 2 * L + 1
        assert by["repro.rope", "repro.train.forward", u, False] == 2 * L
    assert {r.unit for r in recs} == {0, 1}
    # on the CPU the device time is the host time
    assert all(r.device_ms == r.host_ms > 0 for r in recs)
    names = {e.name for e in prof.events()}
    assert {"repro.train.step", "repro.train.forward", "repro.train.backward",
            "repro.train.optimizer", "repro.moe", "repro.norm", "repro.rope"} <= names
    s = tracing.summary()
    assert s["units"] == {"repro.train.step": 2}
    step = s["spans"]["repro.train.step"]["forward"]
    phases = sum(s["spans"][f"repro.train.{p}"]["forward"]["host_ms"]
                 for p in ("forward", "backward", "optimizer"))
    assert step["calls"] == 2 and 0 < phases <= step["host_ms"]


def test_serve_spans_carry_their_request(server):
    cfg, model = server
    with _recording():
        for _ in range(3):
            _serve(cfg, model)
    recs = tracing.records()
    units = [r for r in recs if r.name == "repro.serve.request"]
    assert [r.unit for r in units] == [0, 1, 2] and all(r.parent is None for r in units)
    inner = [r for r in recs if r.name != "repro.serve.request"]
    assert inner and all(r.parent == "repro.serve.request" and not r.backward for r in inner)
    assert collections.Counter(r.unit for r in inner) == {u: 5 * cfg.n_layers + 1
                                                          for u in (0, 1, 2)}
    assert "alloc.device_allocs" not in tracing.summary()["counts"]   # no CUDA allocator


@pytest.mark.parametrize("planner", ["none", "greedy"])
def test_the_moe_backward_is_timed_and_recomputes_are_backward(planner):
    """Each layer's MoE backward is a span under the step's backward; the
    block's replays in recompute regions run outside it, so no span nests
    in a MoE span; each norm is recomputed in the backward."""
    tr = _trainer(planner)
    _steps(tr, 1)
    with _recording():
        _steps(tr, 1, first=2)
    s = tracing.summary()
    L = tr.cfg.n_layers
    replays = sum(layer_replays(tr.cfg, tr.scan_group, tr.policy))
    moe = s["spans"]["repro.moe"]
    assert moe["forward"]["calls"] == L
    assert moe["backward"]["calls"] == L + replays
    assert moe["backward"]["device_ms"] > 0
    norm = s["spans"]["repro.norm"]
    # every norm runs in a recompute region of its own, run again in the
    # backward, and its layer's two norms run in each of the layer's replays
    assert norm["forward"]["calls"] == 2 * L + 1
    assert norm["backward"]["calls"] == 2 * L + 1 + 2 * replays
    recs = tracing.records()
    assert not [r for r in recs if r.parent == "repro.moe"]
    assert all(r.parent == "repro.train.backward" for r in recs
               if r.name == "repro.moe" and r.backward)


def test_counters_are_the_shapes_products(trainer, server):
    cfg, model = server
    with _recording():
        _serve(cfg, model, prompt=24)
    counts = tracing.summary()["counts"]
    L = cfg.n_layers
    assert counts == {"moe.pairs_routed": L * B * 24 * cfg.top_k,
                      "moe.pairs_computed": L * B * 24 * cfg.n_experts}
    _steps(trainer, 1)
    with _recording():
        _steps(trainer, 1, first=2)
    counts = tracing.summary()["counts"]
    assert counts["moe.pairs_routed"] % (B * SEQ * cfg.top_k) == 0
    assert counts["moe.pairs_routed"] * cfg.n_experts == \
        counts["moe.pairs_computed"] * cfg.top_k


@pytest.mark.parametrize("between", ["an unrecorded step", "a summary"])
def test_a_new_session_drops_the_last_ones_spans(trainer, between):
    with _recording():
        _steps(trainer, 2)
    assert tracing.summary()["units"] == {"repro.train.step": 2}
    if between == "an unrecorded step":
        _steps(trainer, 1, first=3)
    with _recording():
        _steps(trainer, 1, first=4)
    s = tracing.summary()
    assert s["units"] == {"repro.train.step": 1}
    assert {r.unit for r in tracing.records()} == {0}
    assert s["spans"]["repro.moe"]["forward"]["calls"] == trainer.cfg.n_layers
