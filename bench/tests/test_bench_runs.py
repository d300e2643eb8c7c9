"""Whole runs on the CPU at the smoke size, past the look for a chip: a
sound run of each cell is correct and its result line has the contract's
shape; with the timed path broken underneath (each fault a cell can have)
``correct`` comes out false."""
from __future__ import annotations

import json
import time

import pytest
import torch

from bench.harness import runner, spec
from bench.tests import smoke

torch.set_num_threads(1)
TRAIN = "granite-moe-1b-a400m.train.2x4096"
PREFILL = "qwen2.5-14b.prefill.longdoc"
SEED = 2 ** 31 + 77


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke.make_root(tmp_path_factory.mktemp("bench"))


def run(root, name, trace=False):
    return runner.run_cell(name, SEED, 0.5, trace, "cpu", time.perf_counter(), root)


@pytest.mark.parametrize("name", [TRAIN, PREFILL])
def test_a_sound_run_is_correct_and_its_line_has_the_contracts_shape(root, name):
    out, rec = run(root, name)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    cell = spec.cell(name, root)
    assert {m["name"]: m["unit"] for m in cell.end_to_end} == \
        {k: v["unit"] for k, v in out["metrics"].items()}
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["checks"]) == set(cell.limits)
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and 0 <= c["value"] < 1e-4   # float32 smoke
    json.dumps(out)
    if name == TRAIN:
        assert rec.spans["plan_s"] > 0 and rec.notes["plan"] is not None


@pytest.fixture
def broken_step(monkeypatch):
    """Replace the launcher's train step by ``fault(step)``."""
    import repro_torch.launch.train as launch

    made = launch.make_train_step

    def use(fault):
        monkeypatch.setattr(launch, "make_train_step",
                            lambda *a, **k: fault(made(*a, **k)))
    return use


def _unchanged(step):
    """A step that returns its state unchanged: it runs, then every
    parameter and moment is put back."""
    def run_step(state, batch):
        keep = {k: v.detach().clone() for k, v in state.params.items()}
        moments = {n: {k: v.clone() for k, v in d.items()} for n, d in state.opt_state.items()}
        _, metrics = step(state, batch)
        with torch.no_grad():
            for k, v in keep.items():
                state.params[k].copy_(v)
            for n, d in moments.items():
                for k, v in d.items():
                    state.opt_state[n][k].copy_(v)
        return state, metrics
    return run_step


def _half_batch(step):
    """Half the batch left out: the loss is the mean over the rest."""
    def run_step(state, batch):
        n = batch["tokens"].shape[0] // 2
        return step(state, {k: v[:n] for k, v in batch.items()})
    return run_step


@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
def test_a_broken_train_step_is_not_correct(root, broken_step, fault):
    broken_step(fault)
    out, _ = run(root, TRAIN)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_an_altered_token_is_not_correct(root, monkeypatch):
    import repro_torch.launch.model_serve as serve

    pick = serve.next_token
    monkeypatch.setattr(serve, "next_token",
                        lambda cfg, logits, *a, **k: (pick(cfg, logits, *a, **k) + 1)
                        % cfg.vocab_size)
    out, _ = run(root, PREFILL)
    assert out["correct"] is False and out["checks"]["token_gap"]["value"] > \
        out["checks"]["token_gap"]["limit"]


def test_a_prefill_of_the_wrong_prompt_is_not_correct(root, monkeypatch):
    """The prefill step's logits are judged, not only the token picked from
    them: a step that leaves out the prompt's last token reads a logit error
    past the limit."""
    import repro_torch.launch.model_serve as serve

    make = serve.make_prefill_step

    def short(*a, **k):
        step = make(*a, **k)
        return lambda model, batch: step(model, {**batch, "tokens": batch["tokens"][:, :-1]})

    monkeypatch.setattr(serve, "make_prefill_step", short)
    out, _ = run(root, PREFILL)
    assert out["correct"] is False and out["checks"]["logit_err"]["value"] > \
        out["checks"]["logit_err"]["limit"]


def test_a_batched_prefill_mix_is_data_alone(tmp_path):
    """A prefill mix of two prompts a request runs from its traffic file
    alone: each row's token is checked, the tokens counted per row."""
    root = smoke.make_root(tmp_path)
    path = root / "bench/traffic/prefill.longdoc.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), "batch": 2}))
    out, rec = run(root, PREFILL)
    assert out["correct"] is True and all(u.batch == 2 and u.tokens == 2 * u.seq
                                          for u in rec.units)
    checked = rec.notes["checked"]
    assert len(checked["gaps"]) == len(checked["logit_errs"]) == 2 * len(checked["requests"])
