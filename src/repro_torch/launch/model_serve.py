"""Batched LLM token serving on the port: prefill a prompt batch, then decode
with the caches.  Parameters, prompts and the stub frontends' inputs (audio
frames, vision embeddings) are random, drawn from ``--seed``.

    PYTHONPATH=src python -m repro_torch.launch.model_serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.model_serve \\
        --batch 4 --prompt-len 4096 --gen 32          # qwen2.5-14b, full width, on the GPU
    PYTHONPATH=src python -m repro_torch.launch.model_serve --arch whisper-medium \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.model_serve --arch internvl2-26b \\
        --batch 4 --prompt-len 4096 --gen 32          # full width, on the GPU

The default ``--arch`` is the reference's, qwen2.5-14b.  The archs it serves
are ``configs.PORTED_ARCH_IDS``: recurrentgemma-2b, mamba2-780m, qwen2.5-14b,
codeqwen1.5-7b, granite-moe-1b-a400m, whisper-medium, internvl2-26b, and
qwen1.5-32b and mixtral-8x7b, which need more memory than one 80 GB card
holds at full width (they run at ``--smoke``, as llama3-405b does).
whisper-medium's prompt is the decoder's (its 1500 encoder frames come with
the batch); internvl2-26b's first 256 prompt positions are vision
embeddings.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import tracing
from .._device import resolve_device
from ..configs.base import ModelConfig
from ..configs.registry import ARCH_IDS, get_config, get_smoke_config
from ..models import arch_init_params
from ..runtime import make_prefill_step, make_serve_step, next_token

__all__ = ["ServeResult", "make_batch", "serve", "serve_main", "stub_frontends"]


@dataclasses.dataclass
class ServeResult:
    ids: np.ndarray          # (B, gen) generated ids, the first from the prefill
    prefill_s: float         # prompt forward + first token, synchronised
    decode_s: float          # the gen - 1 decode steps, synchronised
    steps: int               # decode steps (gen - 1)

    @property
    def decode_ms_per_step(self) -> float:
        return self.decode_s * 1e3 / max(self.steps, 1)

    @property
    def tokens_per_s(self) -> float:
        return self.ids.shape[0] * self.steps / max(self.decode_s, 1e-9)


def make_batch(cfg: ModelConfig, batch: int, prompt_len: int, generator: torch.Generator,
               device: str | torch.device = "cuda") -> dict:
    """A random serving batch from ``generator`` (on ``device``), as the
    reference's launcher draws it: ``tokens (B, P)`` in [1, vocab), and the
    stub frontends' outputs as unit normals, ``frames (B, n_frames, E)`` for
    an encoder-decoder, ``vis_embeds (B, n_vis_tokens, E)`` for a
    vision-language model."""
    dev = resolve_device(device)
    out = {"tokens": torch.randint(1, cfg.vocab_size, (batch, prompt_len), generator=generator,
                                   device=dev)}
    return {**out, **stub_frontends(cfg, batch, generator, dev)}


def stub_frontends(cfg: ModelConfig, batch: int, generator: torch.Generator,
                   device: str | torch.device = "cuda") -> dict:
    """The stub frontends' outputs, unit normals from ``generator`` (on
    ``device``): ``frames (B, n_frames, E)`` for an encoder-decoder,
    ``vis_embeds (B, n_vis_tokens, E)`` for a vision-language model, else
    nothing."""
    dev = resolve_device(device)
    out = {}
    if cfg.encoder_layers:
        out["frames"] = torch.randn((batch, cfg.n_frames, cfg.d_model), generator=generator,
                                    device=dev)
    if cfg.n_vis_tokens:
        out["vis_embeds"] = torch.randn((batch, cfg.n_vis_tokens, cfg.d_model),
                                        generator=generator, device=dev)
    return out


def serve(cfg: ModelConfig, model, batch: dict, gen: int, *,
          temperature: float = 0.0, generator: torch.Generator | None = None,
          device: str | torch.device = "cuda") -> ServeResult:
    """Prefill ``batch`` (``tokens (B, P)``, and ``frames`` or ``vis_embeds``
    where the arch takes them), then ``gen - 1`` decode steps; the first
    generated token is the prefill's greedy pick, as in the reference.
    Under a profiler the call is the unit ``repro.serve.request``
    (:mod:`..tracing`), which counts the allocator's ``cudaMalloc`` calls."""
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    dev = resolve_device(device)
    plen = batch["tokens"].shape[1]
    prefill = make_prefill_step(cfg, max_len=plen + gen, device=dev)
    step = make_serve_step(cfg, temperature=temperature, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with tracing.unit("serve.request", dev):
        sync()
        t0 = time.perf_counter()
        logits, cache = prefill(model, batch)
        tok = next_token(cfg, logits)[:, None]
        sync()
        t_prefill = time.perf_counter() - t0
        out = [tok]
        t0 = time.perf_counter()
        for i in range(gen - 1):
            tok, cache = step(model, cache, tok, plen + i, generator)
            out.append(tok)
        sync()
        t_decode = time.perf_counter() - t0
    return ServeResult(ids=torch.cat(out, dim=1).cpu().numpy(), prefill_s=t_prefill,
                       decode_s=t_decode, steps=gen - 1)


def serve_main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2.5-14b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = arch_init_params(cfg, gen, device=dev)
    batch = make_batch(cfg, args.batch, args.prompt_len, gen, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    res = serve(cfg, model, batch, args.gen, temperature=args.temperature,
                generator=gen, device=dev)
    peak = (f"; peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB allocated"
            if dev.type == "cuda" else "")
    print(f"[serve] {args.arch} on {dev}: prefill {args.batch}x{args.prompt_len} in "
          f"{res.prefill_s * 1e3:.1f} ms; decode {res.steps} steps in {res.decode_s * 1e3:.1f} ms "
          f"({res.decode_ms_per_step:.2f} ms/step, {res.tokens_per_s:.1f} tok/s){peak}")
    print("[sample ids]", res.ids[0, :16].tolist())
    return res.ids


if __name__ == "__main__":
    serve_main()
