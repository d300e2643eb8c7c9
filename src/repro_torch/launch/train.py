"""Training launcher of the port: config -> the HDATS planner (residency plan
and scan group, for the device it runs on) -> model of fp32 masters -> the
train step under the plan's residency -> the step loop with async
checkpoints, failure recovery and deterministic data replay.

    PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \\
        --smoke --device cpu --steps 20 --batch 4 --seq 64 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \\
        --steps 4 --batch 1 --seq 4096            # full width, on the GPU

The flags are the reference's (``repro.launch.train``) plus ``--device``
(``cuda`` by default).  The default ``--arch`` is the reference's,
qwen2.5-14b: at full width its fp32 parameters, gradients and AdamW moments
(~235 GB) do not fit one card, and the launcher says so before it allocates
anything.  The plan is made for one device (one data and one model shard)
with the H100's constants (``plan.H100``); the tabu planner's exact
evaluations run on ``--device`` (the schedule-DP kernel on the card), the
greedy planner (the default) on the host.

An encoder-decoder's or a vision-language model's batch also carries its
stub frontend's output (``frames`` or ``vis_embeds``), unit normals drawn on
``--device`` from (seed, step), so a replayed step sees the same inputs.
The reference's launcher gives whisper no ``frames``; its tokens and labels
are the reference's ``SyntheticLM`` batch, array for array.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .._device import resolve_device
from ..configs.base import ModelConfig, ShapeCell
from ..configs.registry import ARCH_IDS, get_config, get_smoke_config
from ..models import arch_init_params, init_params_
from ..plan import H100, ResidencyPlan, plan_residency
from ..runtime import SyntheticLM, TrainState, adafactor, adamw, make_train_step
from ..runtime.elastic import FailureInjector, run_with_recovery
from .model_serve import stub_frontends

__all__ = ["Trainer", "build_trainer", "parse_args", "train_main", "training_bytes"]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2.5-14b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--optimizer", choices=("adamw", "adafactor"), default="adamw")
    ap.add_argument("--planner", choices=("tabu", "greedy", "none"), default="greedy")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--fail-at", type=int, nargs="*", default=(),
                    help="steps at which to inject a failure (recovery drill)")
    return ap.parse_args(argv)


def training_bytes(cfg: ModelConfig, optimizer: str) -> int:
    """Bytes the fp32 parameters, their gradients and the optimizer state
    take (AdamW: two moments; Adafactor: about none), before activations."""
    per = 4 + 4 + (8 if optimizer == "adamw" else 0)
    return cfg.param_count() * per


@dataclasses.dataclass
class Trainer:
    cfg: ModelConfig
    model: torch.nn.Module
    state: TrainState
    step_fn: object
    data: SyntheticLM
    plan: ResidencyPlan | None
    policy: object                  # models.remat.Residency, or None
    scan_group: int | None
    device: torch.device
    reinit: object                  # () -> TrainState, the initial state again

    def batch_at(self, step: int) -> dict:
        """Step ``step``'s batch: the ``SyntheticLM`` tokens and labels, and
        the stub frontends' inputs drawn from (seed, step) on the device."""
        batch = self.data.batch_at(step)
        if self.cfg.encoder_layers or self.cfg.n_vis_tokens:
            seed = int(np.random.SeedSequence([self.data.state.seed, step, 0xF4])
                       .generate_state(1)[0])
            gen = torch.Generator(device=self.device).manual_seed(seed)
            batch.update(stub_frontends(self.cfg, self.data.batch, gen, self.device))
        return batch


def build_trainer(args: argparse.Namespace) -> Trainer:
    """Plan, model, optimizer, train step and data of a run (nothing is run)."""
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if dev.type == "cuda":
        need = training_bytes(cfg, args.optimizer)
        have = torch.cuda.get_device_properties(dev).total_memory
        if need > have:
            raise MemoryError(
                f"{args.arch}{' (smoke)' if args.smoke else ''}: fp32 parameters, gradients "
                f"and {args.optimizer} state need {need / 1e9:.1f} GB before activations; "
                f"{torch.cuda.get_device_name(dev)} holds {have / 1e9:.1f} GB")

    # ---- the paper's planner chooses the residency plan -------------------
    plan, policy, scan_group = None, None, None
    if args.planner != "none":
        cell = ShapeCell("train_cfg", args.seq, args.batch, "train")
        plan = plan_residency(get_config(args.arch), cell, n_devices=1, n_data_shards=1,
                              n_model_shards=1, optimizer=args.optimizer,
                              use_tabu=args.planner == "tabu", hw=H100,
                              torch_device=str(dev))
        policy = plan.policy()
        if cfg.n_layers % plan.scan_group == 0:
            scan_group = plan.scan_group

    gen = torch.Generator(device=dev)
    model = arch_init_params(cfg, gen.manual_seed(args.seed), device=dev, master=True)
    opt = adafactor(lr=args.lr) if args.optimizer == "adafactor" else adamw(lr=args.lr)
    params = dict(model.named_parameters())

    def reinit() -> TrainState:
        init_params_(model, gen.manual_seed(args.seed))
        return TrainState(params=params, opt_state=opt.init(params), step=0)

    state = TrainState(params=params, opt_state=opt.init(params), step=0)
    step_fn = make_train_step(cfg, opt, model, scan_group=scan_group, remat_policy=policy)
    data = SyntheticLM(cfg, batch=args.batch, seq_len=args.seq, seed=args.seed)
    return Trainer(cfg, model, state, step_fn, data, plan, policy, scan_group, dev, reinit)


def train_main(argv=None, *, on_step=None, trainer: Trainer | None = None) -> TrainState:
    """Run the trainer; ``on_step(step, metrics, seconds)`` (if given) sees
    every step with its wall time, synchronised.  ``trainer``: one that
    ``build_trainer`` made from the same arguments (else it is built here)."""
    args = parse_args(argv)
    tr = trainer if trainer is not None else build_trainer(args)
    if tr.plan is not None:
        p = tr.plan
        print(f"[plan] planner={p.planner} g={p.scan_group} save={p.save_names} "
              f"offload={p.offload_names} est={p.est_step_time * 1e3:.1f}ms "
              f"hbm_budget={p.hbm_budget / 1e9:.1f}GB ({H100.name})")
    n_params = sum(p.numel() for p in tr.model.parameters())
    print(f"[model] {args.arch}{' (smoke)' if args.smoke else ''}: {n_params / 1e6:.1f}M "
          f"params on {tr.device}")

    losses = []
    t0 = time.monotonic()
    last = [t0]

    def on_metrics(step, m):
        losses.append(float(m["loss"]))        # a host read: the step is done
        now = time.monotonic()
        if on_step is not None:
            on_step(step, m, now - last[0])
        last[0] = now
        if step % args.log_every == 0:
            toks = args.batch * args.seq * step
            print(f"step {step:5d} loss {losses[-1]:.4f} gnorm {float(m['grad_norm']):.3f} "
                  f"({toks / max(1e-9, now - t0):.0f} tok/s)", flush=True)

    injector = FailureInjector(fail_at=tuple(args.fail_at)) if args.fail_at else None
    state, restarts = run_with_recovery(
        init_state=tr.state, train_step=tr.step_fn, batch_at=tr.batch_at,
        n_steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        injector=injector, on_metrics=on_metrics, reinit=tr.reinit,
    )
    print(f"[done] steps={int(state.step)} loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"restarts={restarts} elapsed={time.monotonic() - t0:.1f}s")
    return state


if __name__ == "__main__":
    train_main()
