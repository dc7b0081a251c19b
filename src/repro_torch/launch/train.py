"""Training driver of the port: the recsys branch of the JAX package's
``launch/train.py`` (wide-deep, DIEN, BST, MIND).

  PYTHONPATH=src python -m repro_torch.launch.train --arch bst \
      --steps 6 --preempt-at 3 --ckpt-dir build/ck --device cpu

Runs on the CUDA card unless ``--device cpu`` asks for the CPU; with no
card and no ``--device`` it raises ``RuntimeError``.  Each step draws the
arch's synthetic batch (``data.recsys_data``, a pure function of seed
and step), takes the loss's gradients by ``torch.autograd`` and applies
``optim.adamw`` (weight decay 1e-5, no schedule, as the reference),
under ``ckpt.failover.run_resilient``: asynchronous checkpoints every
``--ckpt-every`` steps, a final one at the end, and a restart from the
newest checkpoint after each simulated preemption (``--preempt-at``).
A checkpoint left in ``--ckpt-dir`` by an earlier run is restored
first, as in the reference.  Float32 products run in full float32
(``layers.full_fp32_matmul``): TF32 would part the card from the CPU.

It prints the JAX CLI's two lines, then a ``ckpt:`` line for every
checkpoint written (bytes, seconds) and one ``report:`` JSON line: the
losses and milliseconds of every step, the step's model FLOPs
(``_model_flops``), the peak device memory on a card, and the
flash_attention kernel launches (BST's one a step).  The LM archs
(served by ``models.transformer``; LM training waits for ROADMAP item
7c) and the GNN (item 7e) exit with a message, as the JAX CLI exits for
GNN; ``--seq-len``, ``--warmup`` and ``--multi-pod`` are the
LM branch's flags, taken and unused here as in the reference's recsys
branch.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.ckpt import failover
from repro_torch.configs import base as cfgbase
from repro_torch.data import recsys_data
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.models import layers as L
from repro_torch.models.recsys import bst as BS
from repro_torch.models.recsys import dien as DN
from repro_torch.models.recsys import mind as MD
from repro_torch.models.recsys import wide_deep as WD
from repro_torch.optim import adamw
from repro_torch.tree import leaves, unflatten

__all__ = ["FAMILIES", "LM_ARCHS", "make_step", "recsys_setup", "main"]

#: arch -> why the CLI does not train it
LM_ARCHS = {**{a: "LM training waits for ROADMAP item 7c"
               for a in ("tinyllama-1.1b", "qwen3-4b", "qwen2-0.5b",
                         "deepseek-v3-671b", "mixtral-8x22b")},
            "graphsage-reddit": "the GNN waits for ROADMAP item 7e"}

#: arch -> (init, loss, batch generator)
FAMILIES = {
    "wide-deep": (WD.init_wide_deep, WD.wide_deep_loss,
                  recsys_data.wide_deep_batch),
    "dien": (DN.init_dien, DN.dien_loss, recsys_data.dien_batch),
    "bst": (BS.init_bst, BS.bst_loss, recsys_data.bst_batch),
    "mind": (MD.init_mind, MD.mind_loss, recsys_data.mind_batch),
}


def make_step(loss_fn, cfg, adam: adamw.AdamWConfig):
    """The reference's ``step_fn``: ``(params, opt, batch) -> (params,
    opt, metrics)``, the loss's value and gradients by autograd, then
    ``adamw_update`` (which updates ``params`` and ``opt`` in place)."""
    def step(params, opt, batch):
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        try:
            loss = loss_fn(params, cfg, batch)
            grads = torch.autograd.grad(loss, flat)
        finally:
            for p in flat:
                p.requires_grad_(False)
        grads = unflatten(params, list(grads))
        params, opt, m = adamw.adamw_update(adam, params, grads, opt)
        return params, opt, {"loss": loss.detach(), **m}

    return step


def _to_device(batch: dict, dev: torch.device) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def recsys_setup(arch: str, args, dev: torch.device):
    """(cfg, init_state, train_step) of a recsys arch, as the JAX CLI's
    ``_recsys_setup`` builds them."""
    mod = cfgbase.get(arch)
    cfg = mod.model_config() if args.full else mod.smoke_config()
    init_fn, loss_fn, batch_fn = FAMILIES[arch]
    step_fn = make_step(loss_fn, cfg,
                        adamw.AdamWConfig(lr=args.lr, weight_decay=1e-5))

    def init_state():
        params = init_fn(cfg, seed=args.seed, device=dev)
        return {"params": params, "opt": adamw.init_opt_state(params)}

    def train_step(state, step):
        batch = _to_device(batch_fn(cfg, args.batch, step, seed=args.seed),
                           dev)
        p, o, m = step_fn(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, {"loss": float(m["loss"])}

    return cfg, init_state, train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="build/repro_torch/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--preempt-at", type=int, nargs="*", default=[])
    ap.add_argument("--full", action="store_true",
                    help="full-size config")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises without a card")
    args = ap.parse_args(argv)

    if args.arch in LM_ARCHS:
        raise SystemExit(f"{args.arch}: {LM_ARCHS[args.arch]}")
    if args.arch not in FAMILIES:
        raise SystemExit(f"unknown arch {args.arch!r}; the port trains "
                         f"{sorted(FAMILIES)}")
    dev = resolve_device(args.device)
    L.full_fp32_matmul()
    mod = cfgbase.get(args.arch)
    cfg, init_state, train_step = recsys_setup(args.arch, args, dev)
    fa_kernel.n_launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    res = failover.run_resilient(
        init_state=init_state, train_step=train_step,
        total_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        fault_plan=failover.FaultPlan(
            preempt_at_steps=tuple(args.preempt_at)))

    losses = [m["loss"] for m in res.metrics]
    print(f"arch={args.arch} steps={res.step} restarts={res.restarts} "
          f"stragglers={len(res.straggler_steps)}")
    print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f} "
          f"min={min(losses):.4f}")
    for w in res.ckpt_writes:
        print(f"ckpt: step={w['step']} bytes={w['bytes']} "
              f"seconds={w['seconds']:.3f} ({w['kind']})")
    print("report: " + json.dumps({
        "arch": args.arch, "device": str(dev), "batch": args.batch,
        "losses": losses,
        "step_ms": [1e3 * m["step_time_s"] for m in res.metrics],
        "model_flops": mod._model_flops(cfg, args.batch, "train"),
        "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else None),
        "flash_launches": fa_kernel.n_launches,
        "ckpt": res.ckpt_writes}))


if __name__ == "__main__":
    main()
