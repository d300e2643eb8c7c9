"""The port's linter (``repro_torch.analysis.lint`` + ``rules/``): one torch
fixture per re-aimed rule, the carried-over rules held to the reference's
findings on the reference's fixtures, suppression semantics, the ratchet,
the captured round's discovery, and the port itself linting clean.

Each fixture under ``tests/fixtures/lint_torch/`` holds the bad pattern its
rule exists for *plus* near misses that must NOT fire.
"""
import ast
import pathlib

import pytest

from repro.analysis import lint as ref_lint
from repro_torch.analysis.lint import (
    LintReport,
    lint_paths,
    lint_source,
    load_baseline,
    module_path,
    ratchet_regressions,
    write_baseline,
)
from repro_torch.analysis.rules import all_rules
from repro_torch.analysis.rules._shared import capture_regions, captured_functions

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "lint_torch"
REF_FIXTURES = ROOT / "tests" / "fixtures" / "lint"

# fixture file, modpath it is linted as, expected rule, expected count
CASES = [
    ("rpr101_tensor_branch.py", "core/fixture.py", "RPR101", 4),
    ("rpr102_host_sync.py", "core/fixture.py", "RPR102", 4),
    ("rpr103_cumsum.py", "core/eval_batch.py", "RPR103", 2),
    ("rpr105_static_buffer.py", "core/fixture.py", "RPR105", 2),
]


@pytest.mark.parametrize("fname,modpath,rule,count", CASES, ids=[c[2] for c in CASES])
def test_rule_fixture(fname, modpath, rule, count):
    src = (FIXTURES / fname).read_text()
    findings, suppressed = lint_source(src, modpath)
    hits = [f for f in findings if f.rule == rule]
    assert len(hits) == count, [f"{f.rule}@{f.line}" for f in findings]
    # the bad lines are the ones the fixture marks, and no near miss fires
    lines = src.splitlines()
    assert all(f"# {rule}" in lines[f.line - 1] for f in hits), \
        [lines[f.line - 1] for f in hits]
    assert sum(f"# {rule}" in text for text in lines) == count
    others = [f for f in findings if f.rule != rule]
    assert not others, [f"{f.rule}@{f.line}: {f.message}" for f in others]
    assert not suppressed


def test_cumsum_rule_is_scoped_to_the_parity_modules():
    src = (FIXTURES / "rpr103_cumsum.py").read_text()
    findings, _ = lint_source(src, "models/fixture.py")
    assert not findings


def test_the_rule_ids_are_the_references():
    from repro.analysis.rules import all_rules as ref_rules

    assert [r.id for r in all_rules()] == [r.id for r in ref_rules()]


# ------------------------------------------------------------------ #
# the carried-over rules, against the reference                      #
# ------------------------------------------------------------------ #
REF_CASES = [
    ("rpr104_cache_key.py", "core/fixture.py"),
    ("rpr201_assert.py", "core/fixture.py"),
    ("rpr301_serve_lock.py", "serve/fixture.py"),
    ("rpr302_np_random.py", "core/fixture.py"),
    ("rpr303_swallow.py", "serve/fixture.py"),
    ("rpr304_inject_point.py", "serve/fixture.py"),
]


@pytest.mark.parametrize("fname,modpath", REF_CASES, ids=[c[0][:6].upper() for c in REF_CASES])
def test_carried_over_rules_give_the_references_findings(fname, modpath):
    src = (REF_FIXTURES / fname).read_text()
    ours, ours_sup = lint_source(src, modpath)
    theirs, theirs_sup = ref_lint.lint_source(src, modpath)
    assert theirs                                   # each fixture has its bad pattern
    assert [(f.rule, f.line, f.col) for f in ours] == \
        [(f.rule, f.line, f.col) for f in theirs]
    assert len(ours_sup) == len(theirs_sup) == 0


@pytest.mark.parametrize("fname", ["rpr101_tracer_leak.py", "rpr102_host_sync.py",
                                   "rpr103_cumsum.py", "rpr105_donate.py"])
def test_the_references_jax_fixtures_find_nothing_to_capture(fname):
    """The JAX patterns (jit, donate_argnums, jnp.cumsum) record no CUDA
    graph and make no torch tensor: the re-aimed rules stay silent."""
    src = (REF_FIXTURES / fname).read_text()
    modpath = "core/eval_batch.py" if "cumsum" in fname else "core/fixture.py"
    findings, _ = lint_source(src, modpath)
    assert not [f for f in findings if f.rule.startswith("RPR1")]


def test_cache_key_rule_follows_a_key_function():
    """RPR104 reads a key built by a key function of the module (the
    port's ``_launch_key``): a parameter the key function drops fires, one
    it reads is covered."""
    src = (
        "def _key(a, b, unused):\n"
        "    n = a + 1\n"
        "    return (n, b)\n\n\n"
        "def bad(cache, a, b, c):\n"
        "    key = _key(a, b, c)\n"
        "    fn = cache.get(key)\n"
        "    if fn is None:\n"
        "        fn = object()\n"
        "        cache.put(key, fn)\n"
        "    return fn\n\n\n"
        "def good(cache, a, b):\n"
        "    key = _key(a, b, 0)\n"
        "    fn = cache.get(key)\n"
        "    if fn is None:\n"
        "        fn = object()\n"
        "        cache.put(key, fn)\n"
        "    return fn\n")
    findings, _ = lint_source(src, "core/fixture.py")
    assert [(f.rule, f.line) for f in findings] == [("RPR104", 8)]
    assert "`c`" in findings[0].message


def test_findings_are_span_accurate():
    src = (FIXTURES / "rpr102_host_sync.py").read_text()
    findings, _ = lint_source(src, "core/fixture.py")
    lines = src.splitlines()
    starts = [lines[f.line - 1][f.col:] for f in findings]
    assert starts[0].startswith("x.max().item()")
    assert starts[1].startswith("np.asarray(x)")


# ------------------------------------------------------------------ #
# the captured round                                                 #
# ------------------------------------------------------------------ #
def test_captured_functions_of_the_device_round():
    """``core/device_search.py`` records ``_Launch._round_all`` between
    ``capture_begin`` and ``capture_end``: the round, its loop condition,
    its closures and the module helpers it calls are captured; the host
    loop around the replays is not."""
    tree = ast.parse((ROOT / "src/repro_torch/core/device_search.py").read_text())
    ((site, region),) = capture_regions(tree)
    assert site.name == "_capture_locked"
    assert [ast.unparse(n) for n in region] == ["self._round_all()"]
    names = {fn.name for fn in captured_functions(tree)}
    assert {"_round_all", "_round", "_running", "apply_and_eval", "durations",
            "chunk_sizes", "_true_first", "perturbation_pick", "_mix32"} <= names
    assert not names & {"run", "_capture", "_capture_locked", "_drive", "load_state",
                        "load_instances", "__init__"}


def test_a_host_sync_in_the_device_round_is_caught():
    """The faults the CPU tests cannot see, planted in the port's own
    round: a branch on the state, ``.item()`` and ``int()`` of a tensor."""
    path = ROOT / "src/repro_torch/core/device_search.py"
    src = path.read_text()
    anchor = "        it = st[\"it\"] + 1\n"
    assert src.count(anchor) == 1
    planted = src.replace(anchor, anchor + "        if st[\"stop\"]:\n            pass\n"
                          "        k = it.item() + int(it) + int(self.W) + len(st)\n")
    findings, _ = lint_source(planted, module_path(path))
    at = src[: src.index(anchor)].count("\n") + 2
    assert sorted((f.rule, f.line) for f in findings) == \
        [("RPR101", at), ("RPR102", at + 2), ("RPR102", at + 2)]


def test_torch_cumsum_in_the_device_round_is_caught():
    path = ROOT / "src/repro_torch/core/device_search.py"
    src = path.read_text().replace("sdp.seq_cumsum(vals)", "torch.cumsum(vals, dim=1)")
    findings, _ = lint_source(src, "core/device_search.py")
    assert [f.rule for f in findings] == ["RPR103"]


# ------------------------------------------------------------------ #
# suppression semantics                                              #
# ------------------------------------------------------------------ #
_BAD = "import numpy as np\n\n\ndef f():\n    return np.random.rand()\n"


@pytest.mark.parametrize("src,rules,n_suppressed", [
    # a justified suppression moves the finding
    (_BAD.replace("rand()", "rand()  # lint: allow[RPR302] test seam; DESIGN §9 exception"),
     [], 1),
    # a bare one keeps it and adds RPR000
    (_BAD.replace("rand()", "rand()  # lint: allow[RPR302]"), ["RPR000", "RPR302"], 0),
    # a comment-line suppression covers the code below its continuation
    ("import numpy as np\n\n\ndef f():\n"
     "    # lint: allow[RPR302] justification spanning\n"
     "    # a continuation comment line; DESIGN §9\n"
     "    return np.random.rand()\n", [], 1),
    # it is rule-scoped: an allow of another rule silences nothing
    (_BAD.replace("rand()", "rand()  # lint: allow[RPR101] wrong rule"), ["RPR302"], 0),
], ids=["justified", "bare", "comment-line", "rule-scoped"])
def test_suppression(src, rules, n_suppressed):
    findings, suppressed = lint_source(src, "core/x.py")
    assert sorted(f.rule for f in findings) == rules
    assert len(suppressed) == n_suppressed
    if suppressed:
        assert suppressed[0].finding.rule == "RPR302"
        assert suppressed[0].justification.startswith("justification spanning") or \
            "DESIGN" in suppressed[0].justification


def test_a_suppression_in_a_capture_region_is_honoured():
    src = (FIXTURES / "rpr102_host_sync.py").read_text().replace(
        "best = x.max().item()  # RPR102: a device read in the round",
        "best = x.max().item()  # lint: allow[RPR102] DESIGN §8: a test seam")
    findings, suppressed = lint_source(src, "core/fixture.py")
    assert len(findings) == 3 and [s.finding.rule for s in suppressed] == ["RPR102"]


# ------------------------------------------------------------------ #
# ratchet                                                            #
# ------------------------------------------------------------------ #
def _report_with_one_finding() -> LintReport:
    findings, _ = lint_source(_BAD, "core/x.py")
    assert len(findings) == 1
    return LintReport(findings=findings, suppressed=[], n_files=1)


@pytest.mark.parametrize("baseline,regresses", [
    ({}, True),                                  # a new finding
    ({"RPR302:core/x.py": 1}, False),            # baselined
    ({"RPR302:core/other.py": 5}, True),         # another bucket does not help
], ids=["new", "baselined", "other-bucket"])
def test_ratchet(baseline, regresses):
    regs = ratchet_regressions(_report_with_one_finding(), baseline)
    assert bool(regs) == regresses
    if regs:
        assert "RPR302:core/x.py" in regs[0]


def test_baseline_roundtrip_and_missing_file(tmp_path):
    report = _report_with_one_finding()
    path = write_baseline(report, tmp_path / "ratchet.json")
    assert load_baseline(path) == {"RPR302:core/x.py": 1}
    assert ratchet_regressions(report, load_baseline(path)) == []
    assert load_baseline(tmp_path / "absent.json") == {}


def test_the_committed_baseline_is_the_ports_and_empty():
    assert load_baseline() == {}
    assert (ROOT / ".lint-ratchet-torch.json").exists()


# ------------------------------------------------------------------ #
# the port itself must be clean                                      #
# ------------------------------------------------------------------ #
def test_module_path_is_relative_to_the_port():
    assert module_path(ROOT / "src/repro_torch/core/device_search.py") == \
        "core/device_search.py"
    assert module_path(ROOT / "chip_smoke.py") == "chip_smoke.py"


def test_port_has_zero_unsuppressed_findings():
    report = lint_paths()
    assert report.n_files > 80
    assert report.ok, [
        f"{f.path}:{f.line}: {f.rule} {f.message}" for f in report.findings
    ]
    # every suppression in the port carries a justification citing DESIGN
    for s in report.suppressed:
        assert "DESIGN" in s.justification, s.finding.as_json()
