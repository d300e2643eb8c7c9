"""Attention layers: GQA/MHA/MQA projections (with the qkv biases where the
config has them) + RoPE (unless the layer has absolute positions) + the
flash kernel for the prompt, self- or cross-attention (keys and values from
``kv_x``), and single-token decode against a KV cache: a ring of ``window``
slots for a sliding-window layer, a linear cache of ``max_len`` slots for a
global one, or a fixed cross-attention cache of encoder states
(:func:`cross_decode_attention`).

Under a mesh (``sharding.set_mesh``) with a "model" axis of more than one
rank, a decode cache is sharded along its *sequence* axis over "model"
(which works for every kv-head count, unlike head sharding): each rank
scores its KV chunk as the single-shard path does, then an all-reduce MAX
and an all-reduce SUM (the reference's pmax / psum) rebuild the exact
softmax.  Decode writes the new key and value into the cache in place (the
reference returns an updated copy): the caller hands the cache on and never
reads the old one, and a copy per layer per token would double the traffic
of the step.

With DTensor activations (``rules`` given and a mesh set) the flash kernel
runs on each rank's local shard (``local_map``): under heads-TP a rank hands
it its q heads and the kv heads they read; under q-sequence TP its q rows,
all keys and values, and ``q_offset`` at its first row.  Either way the
rank's dK and dV are partial sums over "model".  Under q-sequence TP the
projections also run on each rank's rows, with the weights whole
(``sharding.partitioning.product``): no view folds the split sequence.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from ..sharding import get_mesh, shard, shard_map
from ..sharding.partitioning import group_slice, is_dtensor, local_start, product, split_grad
from .common import CacheDef, ParamDef, apply_rope, tag

__all__ = ["attn_defs", "attention", "decode_attention", "cross_decode_attention",
           "kv_cache_defs"]

_NEG = -1e30


def attn_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    defs = {
        "wq": ParamDef((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, kvh, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, kvh, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        # the reference's four biases; ``bo`` is the reference's own (the
        # published Qwen models have no output-projection bias)
        defs["bq"] = ParamDef((h, hd), ("heads", "head_dim"), init="zeros")
        defs["bk"] = ParamDef((kvh, hd), ("kv_heads", "head_dim"), init="zeros")
        defs["bv"] = ParamDef((kvh, hd), ("kv_heads", "head_dim"), init="zeros")
        defs["bo"] = ParamDef((d,), ("embed",), init="zeros")
    return defs


class _Flat(torch.autograd.Function):
    """``w.flatten(start, start + 1)`` whose backward gathers a DTensor
    gradient's shards of the flattened dim before splitting it again (a
    product may hand back that dim sharded where the head count does not
    divide the mesh axis, which DTensor cannot unflatten)."""

    @staticmethod
    def forward(ctx, w, start: int):
        ctx.shape, ctx.start = w.shape, start
        return w.flatten(start, start + 1)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g):
            from torch.distributed.tensor import Replicate, Shard

            pl = [Replicate() if isinstance(p, Shard) and p.dim == ctx.start else p
                  for p in g.placements]
            if pl != list(g.placements):
                g = g.redistribute(g.device_mesh, pl)
        return g.unflatten(ctx.start, ctx.shape[ctx.start:ctx.start + 2]), None


def _flat(w, start: int):
    return _Flat.apply(w, start) if is_dtensor(w) else w.flatten(start, start + 1)


def _proj(x, w, heads: str, rules):
    """x (B, S, E) @ w (E, H, D) -> (B, S, H, D), as one product over the
    flattened (H, D), constrained to its logical axes before the heads are
    split out (heads outer: a heads shard stays a plain shard, and a head
    count that does not divide a mesh axis is never split over it)."""
    y = shard(product(lambda a, b: a @ _flat(b, 1), x, w), ("batch", "seq", heads), rules)
    return y.unflatten(-1, w.shape[1:])


def _project_q(cfg: ModelConfig, p, x, rules=None):
    q = _proj(x, p.wq, "heads", rules)
    return q + p.bq if cfg.qkv_bias else q


def _project_qkv(cfg: ModelConfig, p, x, kv_x=None, rules=None):
    """x: (B, S, E) -> q (B,S,H,HD), k/v (B,Skv,KVH,HD) from ``kv_x`` (default
    ``x``), biased before RoPE."""
    kv_x = x if kv_x is None else kv_x
    k = _proj(kv_x, p.wk, "kv_heads", rules)
    v = _proj(kv_x, p.wv, "kv_heads", rules)
    if cfg.qkv_bias:
        k, v = k + p.bk, v + p.bv
    return _project_q(cfg, p, x, rules), k, v


def _out(cfg: ModelConfig, p, y):
    return y + p.bo if cfg.qkv_bias else y


def _flash(q, k, v, *, causal: bool, window: int | None):
    """K2 over q (B, S, H, D) and k / v (B, Skv, KVH, D); for DTensors, on
    each rank's local shard: q as it is sharded (batch, and "model" on its
    heads or its rows), k and v on q's batch axes only.  A rank's heads read
    the kv heads of their groups (a group must not straddle ranks); its rows
    start at ``q_offset``; its dK and dV are partial sums."""
    if not is_dtensor(q):
        return ops.flash_attention(q, k, v, causal=causal, window=window, name="attn_out")
    from torch.distributed.tensor import Replicate, Shard

    mesh, qp = q.device_mesh, tuple(q.placements)
    if any(not isinstance(pl, (Shard, Replicate)) or (isinstance(pl, Shard) and pl.dim == 3)
           for pl in qp):
        raise ValueError(f"attention: q placements {qp} are not batch / rows / heads shards")
    kvp = tuple(pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate() for pl in qp)
    grad_kvp = split_grad(kvp, qp)
    s, h, kvh = q.shape[1], q.shape[2], k.shape[2]

    def local(ql, kl, vl):
        if ql.shape[2] != h:
            heads = group_slice(ql.shape[2], local_start(mesh, qp, 2, h), h, kvh)
            kl, vl = kl[:, :, heads], vl[:, :, heads]
        return ops.flash_attention(ql, kl, vl, causal=causal, window=window,
                                   q_offset=local_start(mesh, qp, 1, s), name="attn_out")

    return shard_map(local, mesh=mesh, in_specs=(qp, kvp, kvp), out_specs=qp,
                     in_grad_specs=(qp, grad_kvp, grad_kvp))(q, k, v)


def attention(cfg: ModelConfig, p, x: torch.Tensor, *, positions: torch.Tensor,
              causal: bool = True, window: int | None = None, rope: bool = True,
              kv_x: torch.Tensor | None = None, return_kv: bool = False, rules=None):
    """Full-sequence attention (prefill, encoder): x (B, S, E) -> (B, S, E)
    [+ the (roped) k and the v, (B, Skv, KVH, HD) each].  ``window=None`` is
    global attention; ``kv_x (B, Skv, E)`` makes it cross-attention (keys and
    values from ``kv_x``); ``rope=False`` for absolute positions; ``rules``
    constrain q, k, v and the output to their logical axes."""
    q, k, v = _project_qkv(cfg, p, x, kv_x, rules)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = shard(q, ("batch", "seq", "heads", None), rules)
    k = shard(k, ("batch", "seq", "kv_heads", None), rules)
    v = shard(v, ("batch", "seq", "kv_heads", None), rules)
    q, k, v = tag(q, "attn_q"), tag(k, "attn_kv"), tag(v, "attn_kv")
    out = tag(_flash(q, k, v, causal=causal, window=window), "attn_out")
    y = product(lambda a, b: a @ _flat(b, 0), out.flatten(2), p.wo)
    y = shard(_out(cfg, p, y), ("batch", "seq", "embed"), rules)
    return (y, (k, v)) if return_kv else y


def kv_cache_defs(cfg: ModelConfig, batch: int, slots: int):
    """Shapes and whether the entry is fp32 (else the working type), with
    the logical axes (:class:`~.common.CacheDef`)."""
    shape = (batch, slots, cfg.n_kv_heads, cfg.resolved_head_dim)
    axes = ("batch", "kv_seq", "kv_heads", "head_dim")
    return {"k": CacheDef(shape, False, axes), "v": CacheDef(shape, False, axes)}


def _scores(q: torch.Tensor, k_cache, v_cache, valid=None):
    """One query token per row over a cache (or a chunk of one): q (B, 1, H,
    HD), caches (B, S, KVH, HD), ``valid`` (S,) bool or None for all.  fp32
    scores; returns the unnormalised ``o`` (B, KVH, G, HD), the rows' max
    ``m`` (B, KVH, G, 1) and their sum of exponentials ``s`` (B, KVH, G)."""
    b, _, h, hd = q.shape
    kvh = k_cache.shape[2]
    qg = (q[:, 0] * hd ** -0.5).float().reshape(b, kvh, h // kvh, hd)
    logits = torch.einsum("bcgd,bkcd->bcgk", qg, k_cache.float())
    if valid is not None:
        logits = torch.where(valid, logits, _NEG)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    if valid is not None:
        e = torch.where(valid, e, 0.0)
    return torch.einsum("bcgk,bkcd->bcgd", e, v_cache.float()), m, e.sum(dim=-1)


def _normalised(q: torch.Tensor, o: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``o`` normalised by ``s``, as q's heads: (B, H, HD) in q's type."""
    b, _, h, hd = q.shape
    return (o / s.clamp_min(1e-30)[..., None]).reshape(b, h, hd).to(q.dtype)


def _project_out(cfg: ModelConfig, p, q: torch.Tensor, o: torch.Tensor, s: torch.Tensor):
    """Normalise ``o`` by ``s``, then the output projection -> (B, 1, E)."""
    return _out(cfg, p, _normalised(q, o, s).flatten(1) @ _flat(p.wo, 0))[:, None]


def _attend(cfg: ModelConfig, p, q: torch.Tensor, k_cache, v_cache, valid=None):
    """One query token per row over a whole cache: fp32 scores and softmax,
    then the output projection -> (B, 1, E).  For a DTensor ``q`` the
    scores run on each rank's batch rows and heads (``local_map``: a rank's
    heads read the kv heads of their groups, the cache gathered but for its
    batch), so no view folds the heads into the batch."""
    if not is_dtensor(q):
        o, _, s = _scores(q, k_cache, v_cache, valid)
        return _project_out(cfg, p, q, o, s)
    from torch.distributed.tensor import Replicate, Shard

    mesh, h, kvh = q.device_mesh, q.shape[2], k_cache.shape[2]
    qp = tuple(pl if isinstance(pl, Shard) and pl.dim in (0, 2) else Replicate()
               for pl in q.placements)
    kvp = tuple(pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate() for pl in qp)
    outp = tuple(Shard(1) if isinstance(pl, Shard) and pl.dim == 2 else pl for pl in qp)

    def local(ql, kl, vl):
        if ql.shape[2] != h:
            heads = group_slice(ql.shape[2], local_start(mesh, qp, 2, h), h, kvh)
            kl, vl = kl[:, :, heads], vl[:, :, heads]
        o, _, s = _scores(ql, kl, vl, valid)
        return _normalised(ql, o, s)

    out = shard_map(local, mesh=mesh, in_specs=(qp, kvp, kvp), out_specs=outp)(
        q, k_cache, v_cache)
    return _out(cfg, p, out.flatten(1) @ _flat(p.wo, 0))[:, None]


def _seq_sharded(s_max: int) -> bool:
    """Whether a decode cache of ``s_max`` slots is sharded along its
    sequence over the mesh's "model" axis (the reference's condition)."""
    mesh = get_mesh()
    return (mesh is not None and "model" in mesh.mesh_dim_names
            and mesh.size(mesh.mesh_dim_names.index("model")) > 1
            and s_max % mesh.size(mesh.mesh_dim_names.index("model")) == 0)


def _sharded_decode(q, k_cache, v_cache, k_new, v_new, slot: int, pos: int, ring: bool,
                    rules):
    """The reference's ``shard_map`` decode: each rank holds ``S_max / n``
    cache slots, writes the new key and value where its chunk holds the
    slot, scores its chunk, then MAX / SUM all-reduces over "model" merge
    the partial softmaxes exactly.  Returns (o, s) with o (B, KVH, G, HD)
    merged and the caches (DTensors, sharded on their sequence)."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    from ..models.common import placements

    mesh = get_mesh()
    s_max = k_cache.shape[1]
    chunk = s_max // mesh.size(mesh.mesh_dim_names.index("model"))
    ba = rules.acts.get("batch") if rules is not None else None
    b_ax = ba if q.shape[0] > 1 else None
    row, cspec = (b_ax, None, None, None), (b_ax, "model", None, None)

    def on_mesh(t, spec):
        if is_dtensor(t):
            return t
        if spec is cspec:
            return distribute_tensor(t, mesh, placements(spec, mesh))
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)

    def local(q_, kc, vc, kn, vn):
        start = local_start(mesh, placements(cspec, mesh), 1, s_max)
        if 0 <= slot - start < chunk:
            kc[:, slot - start] = kn[:, 0]
            vc[:, slot - start] = vn[:, 0]
        valid = start + torch.arange(chunk, device=kc.device) <= slot
        if ring and pos >= s_max:
            valid = torch.ones_like(valid)
        o, m, s = _scores(q_, kc, vc, valid)
        group = (mesh, mesh.mesh_dim_names.index("model"))
        m_g = funcol.all_reduce(m, "max", group)
        corr = torch.exp(m - m_g)
        o = funcol.all_reduce(o * corr, "sum", group)
        s = funcol.all_reduce(s * corr[..., 0], "sum", group)
        return o, s, kc, vc

    o, s, kc, vc = shard_map(
        local, mesh=mesh, in_specs=(row, cspec, cspec, row, row),
        out_specs=[row, (b_ax, None, None), cspec, cspec],
    )(*(on_mesh(t, sp) for t, sp in ((q, row), (k_cache, cspec), (v_cache, cspec),
                                     (k_new, row), (v_new, row))))
    if not is_dtensor(q):
        o, s = o.full_tensor(), s.full_tensor()
    return o, s, kc, vc


def decode_attention(cfg: ModelConfig, p, x: torch.Tensor, cache: dict, pos: int, *,
                     rope: bool = True, window: int | None = None, rules=None):
    """One token against a cache of ``S_max`` slots: x (B, 1, E), cache
    {"k","v"}: (B, S_max, KVH, HD), ``pos`` the token's absolute position.

    With a ``window`` the cache is a ring: the token goes to slot
    ``pos % S_max``, slots up to it are live, and every slot is once the ring
    has wrapped (``pos >= S_max``).  Without one it is linear: the token goes
    to slot ``pos`` (which must be inside the cache) and slots ``<= pos`` are
    live.  ``rope=False`` for absolute positions.  Returns ((B, 1, E), cache)
    with the cache updated in place.

    Under a mesh whose "model" axis divides ``S_max`` the cache is sharded
    along its sequence (:func:`_sharded_decode`; a plain cache is
    distributed on the first step and the returned cache is sharded)."""
    q, k_new, v_new = _project_qkv(cfg, p, x, rules=rules)
    if rope:
        pos_t = torch.arange(pos, pos + 1, device=x.device)   # made on the card: no host wait
        q = apply_rope(q, pos_t, cfg.rope_theta)
        k_new = apply_rope(k_new, pos_t, cfg.rope_theta)
    k_cache, v_cache = cache["k"], cache["v"]
    s_max = k_cache.shape[1]
    ring = window is not None
    if not ring and pos >= s_max:
        raise ValueError(f"position {pos} is past the linear cache's {s_max} slots")
    slot = pos % s_max if ring else pos
    if _seq_sharded(s_max):
        o, s, k_cache, v_cache = _sharded_decode(q, k_cache, v_cache, k_new, v_new, slot, pos,
                                                 ring, rules)
        return _project_out(cfg, p, q, o, s), {"k": k_cache, "v": v_cache}
    k_cache[:, slot] = k_new[:, 0]
    v_cache[:, slot] = v_new[:, 0]
    valid = torch.arange(s_max, device=x.device) <= slot
    if ring and pos >= s_max:
        valid = torch.ones_like(valid)
    return _attend(cfg, p, q, k_cache, v_cache, valid), cache


def cross_decode_attention(cfg: ModelConfig, p, x: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """One token's cross-attention over a fixed cache of encoder keys and
    values, k/v (B, F, KVH, HD), every row live: x (B, 1, E) -> (B, 1, E).
    The reference's oracle math (fp32 scores, no mask), as a plain einsum."""
    return _attend(cfg, p, _project_q(cfg, p, x), k, v)
