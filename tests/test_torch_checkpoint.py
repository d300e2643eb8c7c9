"""The port's crash-surviving search state (``repro_torch.faults.checkpoint``)
against the reference's (``repro.faults.checkpoint``), and crash / resume of
the port's ``device_multiwalk`` on the CPU, where its round runs eagerly
with the plain K1.

The checkpoint half of ``tests/test_faults.py``: the save / load round trip,
a deep snapshot, ``check_compatible`` refusing each mismatch, the
fingerprints equal to the reference's integers, a reference-layout file
refused by name; then a run crashed at a sync by a seeded ``device_lost``,
saved, loaded and resumed, equal field for field to the run that never
crashed (W = 1 and W = 8, Alg. 3 off and on), a resume on the wrong
instance refused, and a time budget carried over."""
import dataclasses

import numpy as np
import pytest
from torch_port_helpers import port_instance

from repro.core import random_instance as ref_random_instance
from repro.core.device_search import pack_state as ref_pack_state
from repro.core.greedy import construct_greedy as ref_construct_greedy
from repro.core.solution import exact_schedule as ref_exact_schedule
from repro.core.tabu import TSParams as RefTSParams
from repro.faults import checkpoint as ref_ckpt
from repro.instances.batch import pack_instance as ref_pack_instance

from repro_torch.core import device_search as ds
from repro_torch.core.greedy import STRATEGIES, construct_greedy
from repro_torch.core.tabu import TSParams
from repro_torch.faults import checkpoint as fckpt
from repro_torch.faults import inject as finj
from repro_torch.faults.errors import DeviceLost

# iteration-bound only, so the run spans several sync boundaries (the
# reference test's profile)
PARAMS = TSParams(seed=3, max_unimproved=10**9, time_limit=1e9, top_k=5, max_iters=40,
                  mem_update_period=ds.MEM_UPDATE_DISABLED, torch_device="cpu")
CFG = ds.DeviceConfig(sync_every=16, crit_cap=32)
CRASH_AT_FIRST_SYNC = finj.FaultPlan(seed=0, rate=1.0, kinds=("device_lost",),
                                     points=("device_search.sync",))


def toy_checkpoint():
    rng = np.random.default_rng(0)
    state = {k: rng.integers(0, 9, size=(2, 3)).astype(np.int32) for k in fckpt.STATE_FIELDS}
    state.update(best_mk=np.array([41.5, 50.0]), active=np.array([True, False]),
                 it=np.int64(12), stop=np.bool_(False), chunk_overflow=np.bool_(True))
    return fckpt.snapshot(
        instance_fp=123, params_fp=456, walks=2, sync_index=3, crit_cap=16, chunk_cap=2,
        iteration=12, elapsed=1.25, n_exact_host=9, g_best=41.5, init_mk_min=60.0,
        g_hist=[(0, 60.0), (12, 41.5)], histories=[[(0, 60.0)], [(4, 50.0), (12, 41.5)]],
        state=state)


def outcome(res):
    return (res.best_makespan, res.history, res.iterations, res.n_exact_evals,
            res.n_approx_evals, res.stop_reason, res.initial_makespan,
            res.n_perturbations, res.best.assign.tolist(), res.best.mem.tolist(),
            res.best.proc_seq, [(w.history, w.best_makespan, w.stop_reason)
                                for w in res.per_walk])


# --------------------------------------------------------------------------- #
# the file and its checks                                                     #
# --------------------------------------------------------------------------- #
def test_checkpoint_save_load_roundtrip(tmp_path):
    ck = toy_checkpoint()
    path = fckpt.save(ck, str(tmp_path / "sub" / "state.npz"))
    back = fckpt.load(path)
    for f in dataclasses.fields(fckpt.SearchCheckpoint):
        if f.name != "state":
            assert getattr(back, f.name) == getattr(ck, f.name), f.name
    assert set(back.state) == set(ck.state) == set(fckpt.STATE_FIELDS)
    for k in ck.state:
        assert np.array_equal(back.state[k], ck.state[k])
        assert back.state[k].dtype == np.asarray(ck.state[k]).dtype
    assert isinstance(back.state["it"], np.int64) and isinstance(back.state["stop"], np.bool_)
    assert [p.name for p in tmp_path.joinpath("sub").iterdir()] == ["state.npz"]


def test_save_is_atomic(tmp_path, monkeypatch):
    """A write that fails leaves the previous checkpoint whole and no
    temporary file behind."""
    path = str(tmp_path / "state.npz")
    fckpt.save(toy_checkpoint(), path)
    first = tmp_path.joinpath("state.npz").read_bytes()

    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken)
    with pytest.raises(OSError, match="disk full"):
        fckpt.save(toy_checkpoint(), path)
    assert tmp_path.joinpath("state.npz").read_bytes() == first
    assert [p.name for p in tmp_path.iterdir()] == ["state.npz"]


def test_checkpoint_snapshot_is_deep():
    state = {"mk": np.array([5.0])}
    hist = [[(0, 5.0)]]
    ck = fckpt.snapshot(
        instance_fp=1, params_fp=2, walks=1, sync_index=0, crit_cap=8, chunk_cap=1,
        iteration=0, elapsed=0.0, n_exact_host=0, g_best=5.0, init_mk_min=5.0,
        g_hist=[], histories=hist, state=state)
    state["mk"][0] = -1.0
    hist[0].append((3, 4.0))
    assert ck.state["mk"][0] == 5.0 and ck.histories == [[(0, 5.0)]]


@pytest.mark.parametrize("kw, match", [
    ({"instance_fp": 99}, "different instance"),
    ({"params_fp": 99}, "different TSParams"),
    ({"walks": 3}, "W=2"),
])
def test_check_compatible_rejects_mismatches(kw, match):
    ck = toy_checkpoint()
    fckpt.check_compatible(ck, instance_fp=123, params_fp=456, walks=2)
    with pytest.raises(fckpt.CheckpointMismatch, match=match):
        fckpt.check_compatible(ck, **{"instance_fp": 123, "params_fp": 456, "walks": 2, **kw})


def test_check_compatible_rejects_another_version_and_another_state():
    ck = toy_checkpoint()
    with pytest.raises(fckpt.CheckpointMismatch, match="version 7"):
        fckpt.check_compatible(dataclasses.replace(ck, version=7), instance_fp=123,
                               params_fp=456, walks=2)
    state = dict(ck.state)
    del state["chunk_overflow"]
    with pytest.raises(fckpt.CheckpointMismatch, match="chunk_overflow"):
        fckpt.check_compatible(dataclasses.replace(ck, state=state), instance_fp=123,
                               params_fp=456, walks=2)


def test_state_fields_are_pack_states():
    inst = port_instance(ref_random_instance(0, n_tasks=12, n_data=30))
    init = construct_greedy(inst, "slack_first", rng=0)
    from repro_torch.core.solution import exact_schedule

    state = ds.pack_state(ds.pack_instance(inst), [init], [exact_schedule(inst, init)], 0)
    assert tuple(state) == fckpt.STATE_FIELDS


def ref_layout_checkpoint(inst, params):
    """A real checkpoint of the reference's layout: its ``pack_state`` of a
    walk on ``inst``, snapshotted by its ``snapshot``."""
    init = ref_construct_greedy(inst, "slack_first", rng=3)
    state = ref_pack_state(ref_pack_instance(inst), [init], [ref_exact_schedule(inst, init)],
                           params.seed)
    mk = float(state["best_mk"].min())
    return ref_ckpt.snapshot(
        instance_fp=ref_ckpt.instance_fingerprint(inst),
        params_fp=ref_ckpt.params_fingerprint(params), walks=1, sync_index=1, crit_cap=32,
        elapsed=0.5, n_exact_host=0, g_best=mk, init_mk_min=mk, g_hist=[(0, mk)],
        histories=[[(0, mk)]], state=state)


def test_a_reference_layout_file_is_refused_by_its_fields(tmp_path):
    ref_inst = ref_random_instance(0, n_tasks=40, n_data=100)
    ref_params = RefTSParams(**{f.name: getattr(PARAMS, f.name)
                                for f in dataclasses.fields(RefTSParams)})
    ck = ref_layout_checkpoint(ref_inst, ref_params)
    path = ref_ckpt.save(ck, str(tmp_path / "ref.npz"))
    with pytest.raises(fckpt.CheckpointMismatch, match=r"missing \['chunk_overflow'\]"
                       r".*unknown \['key'\]"):
        fckpt.load(path)
    # the reference's object itself: its fingerprints are the port's, but its
    # state is not the port's, so the resume stops before any launch
    inst = port_instance(ref_inst)
    assert ck.instance_fp == fckpt.instance_fingerprint(inst)
    assert ck.params_fp == fckpt.params_fingerprint(PARAMS)
    with pytest.raises(fckpt.CheckpointMismatch, match="key"):
        ds.device_multiwalk(inst, [], PARAMS, config=CFG, resume_from=ck)


@pytest.mark.parametrize("seed, n_tasks, n_data", [(0, 40, 100), (5, 250, 600), (2, 12, 30)])
def test_instance_fingerprint_equals_the_references(seed, n_tasks, n_data):
    ref = ref_random_instance(seed, n_tasks=n_tasks, n_data=n_data)
    assert fckpt.instance_fingerprint(port_instance(ref)) == ref_ckpt.instance_fingerprint(ref)


@pytest.mark.parametrize("kw", [
    {},
    {"seed": 3, "max_unimproved": 10**9, "time_limit": 1e9, "top_k": 5, "max_iters": 40,
     "mem_update_period": ds.MEM_UPDATE_DISABLED},
    {"max_evals": 500, "mem_update_scalar": True, "sanitize": True, "backend": "scalar"},
])
def test_params_fingerprint_equals_the_references(kw):
    """The same field values give the reference's integer, wherever the port
    runs (``torch_device`` is not a field of the reference's TSParams)."""
    ref = RefTSParams(**{"backend": "numpy", **kw})
    want = ref_ckpt.params_fingerprint(ref)
    for dev in ("cpu", "cuda"):
        port = TSParams(**{"backend": "numpy", **kw}, torch_device=dev)
        assert fckpt.params_fingerprint(port) == want
    other = TSParams(**{"backend": "numpy", **kw, "top_k": 7}, torch_device="cpu")
    assert fckpt.params_fingerprint(other) != want


# --------------------------------------------------------------------------- #
# crash / resume (device engine, CPU)                                         #
# --------------------------------------------------------------------------- #
def resume_roundtrip(walks: int, tmp_path, params=PARAMS):
    inst = port_instance(ref_random_instance(0, n_tasks=40, n_data=100))
    inits = [construct_greedy(inst, STRATEGIES[w % len(STRATEGIES)], rng=3 + w)
             for w in range(walks)]
    ref_ckpts = []
    ref = ds.device_multiwalk(inst, [s.copy() for s in inits], params, config=CFG,
                              on_checkpoint=ref_ckpts.append)
    assert len(ref_ckpts) >= 2, "need a mid-run sync to resume from"

    # crash mid-run: device_lost at sync 1, after its checkpoint
    got = []
    with finj.plan_context(CRASH_AT_FIRST_SYNC):
        with pytest.raises(DeviceLost, match=r"device_search\.sync \(key 1\)"):
            ds.device_multiwalk(inst, [s.copy() for s in inits], params, config=CFG,
                                on_checkpoint=got.append)
    assert len(got) == 1                       # the checkpoint lands before the crash
    for f in ("sync_index", "crit_cap", "chunk_cap", "iteration", "g_hist", "histories"):
        assert getattr(got[0], f) == getattr(ref_ckpts[0], f), f
    for k in fckpt.STATE_FIELDS:
        assert np.array_equal(got[0].state[k], ref_ckpts[0].state[k]), k

    path = fckpt.save(got[-1], str(tmp_path / "crash.npz"))
    resumed = ds.device_multiwalk(inst, [s.copy() for s in inits], params, config=CFG,
                                  resume_from=fckpt.load(path))
    assert outcome(resumed) == outcome(ref)
    # the incumbents never go up across the seam
    mks = [m for _, m in resumed.history]
    assert mks == sorted(mks, reverse=True)
    return ref, resumed, got[0]


@pytest.mark.parametrize("walks", [1, 8])
def test_crash_resume_bit_parity(walks, tmp_path):
    ref, resumed, ck = resume_roundtrip(walks, tmp_path)
    assert ck.iteration == CFG.sync_every and ref.iterations == PARAMS.max_iters
    # the resumed run's own device stats count from the resume
    assert resumed.device_stats["crit_cap"] == ck.crit_cap


def test_crash_resume_with_algorithm_3_at_syncs(tmp_path):
    """Alg. 3 at every sync (the default period): the host work the
    checkpoint follows is in it, and the resumed run equals the uncrashed
    one at the iteration budget."""
    params = dataclasses.replace(PARAMS, mem_update_period=1)
    ref, _, ck = resume_roundtrip(2, tmp_path, params)
    assert ck.n_exact_host == 2 and ref.n_exact_evals > ck.n_exact_host


def test_resume_rejects_wrong_instance():
    params = dataclasses.replace(PARAMS, max_unimproved=15)
    inst = port_instance(ref_random_instance(0, n_tasks=40, n_data=100))
    ckpts = []
    ds.device_multiwalk(inst, [construct_greedy(inst, "slack_first", rng=3)], params,
                        config=CFG, on_checkpoint=ckpts.append)
    assert ckpts
    other = port_instance(ref_random_instance(1, n_tasks=40, n_data=100))
    with pytest.raises(fckpt.CheckpointMismatch, match="different instance"):
        ds.device_multiwalk(other, [construct_greedy(other, "slack_first", rng=3)], params,
                            config=CFG, resume_from=ckpts[0])
    with pytest.raises(fckpt.CheckpointMismatch, match="different TSParams"):
        ds.device_multiwalk(inst, [], dataclasses.replace(params, top_k=4), config=CFG,
                            resume_from=ckpts[0])


def test_a_time_budget_carries_over():
    """A checkpoint past the time limit resumes into an immediate stop: the
    elapsed time is carried over, not restarted."""
    params = dataclasses.replace(PARAMS, time_limit=30.0)
    inst = port_instance(ref_random_instance(0, n_tasks=40, n_data=100))
    ckpts = []
    ds.device_multiwalk(inst, [construct_greedy(inst, "slack_first", rng=3)], params,
                        config=CFG, on_checkpoint=ckpts.append)
    late = dataclasses.replace(ckpts[0], elapsed=31.0)
    res = ds.device_multiwalk(inst, [], params, config=CFG, resume_from=late)
    assert res.stop_reason == "time_limit" and res.iterations == ckpts[0].iteration
    assert res.elapsed >= 31.0 and res.device_stats["rounds_replayed"] == 0
