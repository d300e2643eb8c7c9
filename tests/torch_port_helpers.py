"""Helpers shared by the ``test_torch_*`` parity tests: the same data goes
through ``repro`` (the JAX/NumPy reference package) and ``repro_torch`` (the
PyTorch/CUDA port) as plain NumPy arrays."""
import re

import jax.numpy as jnp
import numpy as np
import torch

from repro.core import random_instance as ref_random_instance
from repro.core.greedy import construct_greedy as ref_construct_greedy
from repro.core.solution import exact_schedule as ref_exact_schedule
from repro.core.solution import heads_tails as ref_heads_tails
from repro.core.tabu import _cc_moves, _n7_moves, apply_move

from repro_torch import convert

# The tensors here are tiny: one intra-op thread is as fast as many, and it
# keeps several test worker processes from oversubscribing the cores.
torch.set_num_threads(1)


def instance_fields(inst) -> dict:
    """Field dict of any object shaped like an ``Instance``."""
    return {f: getattr(inst, f) for f in convert.INSTANCE_FIELDS}


def solution_fields(sol) -> dict:
    lens = np.array([len(s) for s in sol.proc_seq], dtype=np.int64)
    indptr = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=indptr[1:])
    return {"assign": sol.assign, "mem": sol.mem, "proc_seq_indptr": indptr,
            "proc_seq_idx": np.array([t for s in sol.proc_seq for t in s],
                                     dtype=np.int64)}


def port_instance(inst):
    """A ``repro`` Instance as a ``repro_torch`` Instance."""
    return convert.instance_from_arrays(instance_fields(inst))


def port_solution(sol):
    return convert.solution_from_arrays(solution_fields(sol))


def same_instance(a, b) -> bool:
    fa, fb = instance_fields(a), instance_fields(b)
    derived = ("pred_indptr", "pred_idx", "succ_indptr", "succ_idx")
    return all(np.array_equal(np.asarray(fa[k]), np.asarray(fb[k])) for k in fa) \
        and all(np.array_equal(getattr(a, k), getattr(b, k)) for k in derived)


def same_solution(a, b) -> bool:
    return (np.array_equal(a.assign, b.assign) and np.array_equal(a.mem, b.mem)
            and [list(map(int, s)) for s in a.proc_seq]
            == [list(map(int, s)) for s in b.proc_seq])


def candidate_batch(seed, n_tasks, n_data=90, max_k=24):
    """A mixed feasible/cyclic candidate batch from a real neighborhood,
    built with the reference package (as ``tests/test_schedule_dp.py``)."""
    inst = ref_random_instance(seed, n_tasks=n_tasks, n_data=n_data)
    sol = ref_construct_greedy(inst, "slack_first", rng=seed)
    sched = ref_exact_schedule(inst, sol)
    r, q, _, crit = ref_heads_tails(inst, sol, sched)
    moves = _n7_moves(sol, crit) + _cc_moves(inst, sol, crit, r, sched.start, 5)
    cands = [sol]
    for m in moves[: max_k - 1]:
        c = sol.copy()
        apply_move(c, m)
        cands.append(c)
    return inst, cands


def padded(a, fill, dtype, n_b):
    k, n = a.shape
    out = np.full((k, n_b), fill, dtype=dtype)
    out[:, :n] = a
    return out


_BIAS = re.compile(r"^(b[qkvio]|.+_b)$")


def draw_biases(tree: dict, rng, std: float) -> dict:
    """A copy of the reference's parameter tree with every bias (``bq``,
    ``bk``, ``bv``, ``bo``, ``bi`` and the LayerNorms' ``*_b``), which the
    reference starts at zero, drawn from ``std * N(0, 1)``: a bias the two
    sides dropped or misplaced then shows in the logits."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = draw_biases(leaf, rng, std)
        elif _BIAS.match(name):
            assert not np.asarray(leaf).any(), name          # the reference's zeros
            out[name] = jnp.asarray(std * rng.standard_normal(leaf.shape), leaf.dtype)
        else:
            out[name] = leaf
    return out


def rel_close(got, want, tol: float, what: str) -> None:
    """max |got - want| / max |want| < tol."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < tol, f"{what}: max |diff| / max |want| = {err:.3g}"


def init_per_layer(defs, key):
    """The reference's initialiser (``repro.models.common.init_tree``) over a
    parameter tree whose layers are stacked on a leading ``layers`` axis, with
    each stacked leaf scaled by the fan-in of one layer's shape, as the
    reference draws an unstacked (``layer_XXX``) tree.  Stacked, the
    reference takes its fan-in from the layer axis (1 / sqrt(4) for a 4-layer
    smoke model), which makes the smoke models' attention logits reach the
    hundreds; there a change of one float32 unit in the parameters moves the
    logits by more than 1e-4 of their maximum, so no parity bar near that
    could tell a fault from rounding."""
    import dataclasses as dc
    import math

    from repro.models.common import ParamDef, init_tree

    def one(d):
        if not (d.axes and d.axes[0] == "layers" and d.init == "normal" and d.scale is None):
            return d
        shape = d.shape[1:]
        fan_in = shape[0] if len(shape) > 1 else max(1, shape[-1])
        return dc.replace(d, scale=1.0 / math.sqrt(fan_in))

    import jax
    return init_tree(jax.tree.map(one, defs, is_leaf=lambda d: isinstance(d, ParamDef)), key)


def one_unit_apart(tree, seed: int):
    """``tree`` with every float32 leaf moved one unit in the last place,
    up or down at random (``seed``)."""
    import jax

    rng = np.random.default_rng(seed)

    def move(leaf):
        leaf = np.asarray(leaf)
        if leaf.dtype != np.float32:
            return leaf
        up = rng.random(leaf.shape) < 0.5
        return np.where(up, np.nextafter(leaf, np.float32(np.inf)),
                        np.nextafter(leaf, np.float32(-np.inf))).astype(np.float32)

    return jax.tree.map(move, tree)


def init_readings(ref_cfg, cfg, params, batch: dict, seed: int = 2) -> tuple[float, float]:
    """The port's forward logits on the reference's ``params`` against
    ``repro``'s, and against the port's own on the same parameters moved one
    float32 unit (``one_unit_apart``): each max |diff| / max |logit|.  The
    second is what rounding alone can do to the logits at these
    parameters."""
    import jax

    from repro.models import arch_forward as ref_forward

    from repro_torch.models import Decoder, EncDec, arch_forward

    tree = jax.tree.map(np.asarray, params)
    inputs = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}

    def port(t):
        model = (EncDec if cfg.encoder_layers else Decoder)(cfg, device="cpu")
        model.load_state_dict(convert.model_params_from_arrays(cfg, t))
        with torch.no_grad():
            return arch_forward(cfg, model, inputs).numpy().astype(np.float64)

    got = port(tree)
    want = np.asarray(ref_forward(ref_cfg, params, {k: jnp.asarray(v) for k, v in batch.items()}),
                      np.float64)
    moved = port(one_unit_apart(tree, seed))
    return (float(np.abs(got - want).max() / np.abs(want).max()),
            float(np.abs(moved - got).max() / np.abs(got).max()))


def ref_loss_and_grads(ref_cfg, params, batch: dict):
    """``jax.value_and_grad`` of the reference's ``arch_forward`` +
    ``cross_entropy_loss`` at ``params`` on a NumPy ``batch``."""
    import jax

    from repro.models import arch_forward as ref_forward
    from repro.models import cross_entropy_loss as ref_loss

    def loss_fn(p):
        return ref_loss(ref_cfg, ref_forward(ref_cfg, p, jb), jb["labels"])

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.value_and_grad(loss_fn)(params)


def port_loss_and_grads(cfg, model, batch: dict):
    """The port's loss (a float) and gradients (the reference's tree layout,
    NumPy) of ``model`` on a NumPy ``batch``, through ``runtime.batch_to``."""
    from repro_torch.models import arch_forward, cross_entropy_loss
    from repro_torch.runtime.train import batch_to

    tb = batch_to(batch, "cpu")
    for p in model.parameters():
        p.grad = None
    loss = cross_entropy_loss(cfg, arch_forward(cfg, model, tb), tb["labels"])
    loss.backward()
    grads = convert.model_params_to_arrays(cfg, {k: p.grad for k, p in model.named_parameters()})
    return float(loss.detach()), grads


def grad_leaf_errors(got_tree, want_tree) -> dict:
    """Per leaf of the reference's tree, max |got - want| / max |want|."""
    import jax

    got = dict(jax.tree_util.tree_leaves_with_path(got_tree))
    want = jax.tree_util.tree_leaves_with_path(want_tree)
    assert len(got) == len(want)
    out = {}
    for path, w in want:
        w = np.asarray(w, np.float64)
        out[jax.tree_util.keystr(path)] = float(
            np.max(np.abs(got[path] - w)) / (np.max(np.abs(w)) + 1e-30))
    return out
