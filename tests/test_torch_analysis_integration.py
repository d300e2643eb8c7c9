"""The port's analysis CLI (``python -m repro_torch.analysis``): ``lint``,
``lint --ratchet``, ``lint --json``, ``selftest`` and ``certify`` on every
backend, held against the reference's CLI where both run the same engine.
"""
import json
import pathlib

import pytest
import torch

from repro.analysis.cli import main as ref_main
from repro_torch.analysis import cli
from repro_torch.analysis.cli import main as cli_main
from repro_torch.instances.suites import get_suite

ROOT = pathlib.Path(__file__).resolve().parents[1]

torch.set_num_threads(1)


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_cli_lint_clean_port(capsys):
    rc, out = _run(cli_main, ["lint"], capsys)
    assert rc == 0
    assert "0 finding(s)" in out


def test_cli_lint_ratchet(capsys):
    rc, out = _run(cli_main, ["lint", "--ratchet"], capsys)
    assert rc == 0
    assert "no regressions" in out


@pytest.mark.parametrize("fixture,rule", [
    ("lint_torch/rpr101_tensor_branch.py", "RPR101"),
    ("lint/rpr302_np_random.py", "RPR302"),
])
def test_cli_lint_json_on_fixture(fixture, rule, capsys):
    rc, out = _run(cli_main, ["lint", str(ROOT / "tests/fixtures" / fixture), "--json"],
                   capsys)
    payload = json.loads(out)
    assert rc == 1
    assert payload["ok"] is False
    assert payload["findings"][0]["rule"] == rule


def test_cli_lint_update_baseline_then_ratchet(tmp_path, capsys):
    fixture = str(ROOT / "tests/fixtures/lint_torch/rpr102_host_sync.py")
    base = str(tmp_path / "ratchet.json")
    rc, _ = _run(cli_main, ["lint", fixture, "--update-baseline", "--baseline", base], capsys)
    assert rc == 0
    assert json.loads(pathlib.Path(base).read_text())["counts"] == \
        {"RPR102:rpr102_host_sync.py": 4}
    rc, out = _run(cli_main, ["lint", fixture, "--ratchet", "--baseline", base], capsys)
    assert rc == 0 and "no regressions" in out


def test_cli_selftest_catches_injections(capsys):
    rc, out = _run(cli_main, ["selftest", "--json"], capsys)
    payload = json.loads(out)
    assert rc == 0
    assert payload["lint_detected"] and payload["certify_detected"]
    assert {"RPR101", "RPR102"} <= set(payload["lint_rules"])
    assert "jax" not in cli._BAD_SNIPPET


def test_cli_usage_error_exits_2(capsys):
    with pytest.raises(SystemExit) as e:
        cli_main(["certify", "--backend", "jax"])
    assert e.value.code == 2
    capsys.readouterr()


# ------------------------------------------------------------------ #
# certify                                                            #
# ------------------------------------------------------------------ #
_CERTIFY = ["certify", "--suite", "smoke", "--max-iters", "4", "--json"]


@pytest.fixture(scope="module")
def numpy_rows():
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli_main(_CERTIFY + ["--backend", "numpy"]) == 0
    return json.loads(out.getvalue())["rows"]


def _cert(row):
    c = row["certificate"]
    return c["ok"], sorted({v["kind"] for v in c["violations"]})


def test_certify_numpy_agrees_with_the_references_cli(numpy_rows, capsys):
    rc, out = _run(ref_main, _CERTIFY + ["--backend", "numpy"], capsys)
    ref_rows = json.loads(out)["rows"]
    assert rc == 0 and len(numpy_rows) == len(ref_rows) == len(get_suite("smoke").items)
    for ours, theirs in zip(numpy_rows, ref_rows):
        assert ours["instance"] == theirs["instance"]
        assert (ours["makespan"], ours["feasible"], _cert(ours)) == \
            (theirs["makespan"], theirs["feasible"], _cert(theirs))
        assert ours["certificate"]["ok"]


@pytest.mark.parametrize("backend", ["torch", "device"])
def test_certify_on_the_cpu_backends(backend, numpy_rows, tmp_path, capsys):
    report = tmp_path / "certify.json"
    rc, _ = _run(cli_main, _CERTIFY + ["--backend", backend, "--torch-device", "cpu",
                                       "--report", str(report)], capsys)
    payload = json.loads(report.read_text())
    assert rc == 0 and payload["n_failed"] == 0
    assert payload["torch_device"] == "cpu"
    assert len(payload["rows"]) == len(get_suite("smoke").items) == 7
    assert all(r["certificate"]["ok"] for r in payload["rows"])
    if backend == "torch":
        # the batched engine's trajectories are the NumPy engine's, bit for bit
        assert [(r["makespan"], r["history"], r["n_exact_evals"]) for r in payload["rows"]] \
            == [(r["makespan"], r["history"], r["n_exact_evals"]) for r in numpy_rows]


def test_certify_defaults_to_the_card(capsys):
    """``--backend torch`` / ``device`` go to the GPU unless asked for the
    CPU (``--torch-device cuda`` is the default): without a card they raise
    through ``_device.resolve_device`` instead of carrying on on the host."""
    assert cli.build_parser().parse_args(["certify"]).torch_device == "cuda"
    if torch.cuda.is_available():
        return
    for backend in ("torch", "device"):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            cli_main(_CERTIFY + ["--backend", backend])
    capsys.readouterr()
