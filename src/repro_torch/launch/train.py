"""Training driver of the port: the JAX package's ``launch/train.py``
for the recsys archs (wide-deep, DIEN, BST, MIND) and the LM archs
(tinyllama-1.1b, qwen2-0.5b, qwen3-4b, mixtral-8x22b, deepseek-v3-671b).

  PYTHONPATH=src python -m repro_torch.launch.train --arch bst \
      --steps 6 --preempt-at 3 --ckpt-dir build/ck --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --steps 200 --batch 8 --seq-len 128 --ckpt-every 40 \
      --preempt-at 90 --ckpt-dir build/ck_lm --device cpu

Runs on the CUDA card unless ``--device cpu`` asks for the CPU; with no
card and no ``--device`` it raises ``RuntimeError``.  A recsys step
draws the arch's synthetic batch (``data.recsys_data``), an LM step
``data.lm_pipeline.LMPipeline``'s (``--batch`` x ``--seq-len``
tokens); both are pure functions of seed and step.  The loss's
gradients come from ``torch.autograd`` (the LM's ``train_loss``
checkpoints each layer, as the reference's ``remat="full"`` does), then
``optim.adamw``: weight decay 1e-5 and no schedule for recsys, the
default AdamW with ``schedules.warmup_cosine(step, --warmup, --steps)``
as ``lr_scale`` for the LM, as the reference.  All of it runs under
``ckpt.failover.run_resilient``: asynchronous checkpoints every
``--ckpt-every`` steps, a final one at the end, and a restart from the
newest checkpoint after each simulated preemption (``--preempt-at``).
A checkpoint left in ``--ckpt-dir`` by an earlier run is restored
first, as in the reference.  Float32 products run in full float32
(``layers.full_fp32_matmul``): TF32 would part the card from the CPU.
One device holds the parameters: the CLI trains on one card, and the
mesh placement of the reference's ``lm_param_specs`` is what the dry
run (``launch/dryrun.py``) sizes for many cards, which this process
does not drive; ``--full`` is the arch's ``model_config()``
(deepseek-v3-671b's does not fit one card).  The reference's docstring
promises int8 gradient compression, which its CLI has no flag for; the
port keeps ``optim/compression.py`` as a library and adds none.

It prints the JAX CLI's two lines, then a ``ckpt:`` line for every
checkpoint written (bytes, seconds) and one ``report:`` JSON line: the
losses and milliseconds of every step, the step's model FLOPs (the
recsys ``_model_flops``, or ``lm_common.model_flops(cfg, "train", B,
S)``), the peak device memory on a card, and the flash_attention kernel
launches (BST's one a step; an LM's two a layer a step, the forward and
its recompute) with their routes.  An LM run also reports tokens a
step, and tokens/s and model TFLOP/s at the median step time of steps 2
on; on a card, the device ms of each step's flash backwards
(``ops.FlashAttention.backward`` between two CUDA events a call) and
their median over steps 2 on.  The GNN (graphsage-reddit) is not
trained here, as the JAX CLI does not train it: the CLI exits naming its
driver, ``python -m repro_torch.examples.gnn_sage``.  ``--multi-pod`` is
taken and unused.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from repro_torch.ckpt import failover
from repro_torch.configs import base as cfgbase
from repro_torch.configs import lm_common
from repro_torch.data import lm_pipeline, recsys_data
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import layers as L
from repro_torch.models.recsys import bst as BS
from repro_torch.models.recsys import dien as DN
from repro_torch.models.recsys import mind as MD
from repro_torch.models.recsys import wide_deep as WD
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, schedules
from repro_torch.tree import leaves, unflatten

__all__ = ["FAMILIES", "GNN_DRIVER", "value_and_grad", "make_step",
           "recsys_setup",
           "lm_setup", "main"]

#: the GNN's training driver, which the CLI names for it
GNN_DRIVER = "python -m repro_torch.examples.gnn_sage"

#: arch -> (init, loss, batch generator)
FAMILIES = {
    "wide-deep": (WD.init_wide_deep, WD.wide_deep_loss,
                  recsys_data.wide_deep_batch),
    "dien": (DN.init_dien, DN.dien_loss, recsys_data.dien_batch),
    "bst": (BS.init_bst, BS.bst_loss, recsys_data.bst_batch),
    "mind": (MD.init_mind, MD.mind_loss, recsys_data.mind_batch),
}


def value_and_grad(loss_fn, params):
    """``jax.value_and_grad(loss_fn)(params)`` by autograd: the detached
    loss and a tree of gradients shaped as ``params``.  A leaf the loss
    does not use (the GNN's ``graph_head`` in a node loss) gets zeros,
    as JAX's gradient gives it."""
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    try:
        loss = loss_fn(params)
        grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                    materialize_grads=True)
    finally:
        for p in flat:
            p.requires_grad_(False)
    return loss.detach(), unflatten(params, list(grads))


def make_step(loss_fn, cfg, adam: adamw.AdamWConfig):
    """The reference's ``step_fn``: ``(params, opt, batch, lr_scale=1)
    -> (params, opt, metrics)``, the loss's value and gradients by
    autograd, then ``adamw_update`` (which updates ``params`` and
    ``opt`` in place)."""
    def step(params, opt, batch, lr_scale=1.0):
        loss, grads = value_and_grad(lambda p: loss_fn(p, cfg, batch),
                                     params)
        params, opt, m = adamw.adamw_update(adam, params, grads, opt,
                                            lr_scale)
        return params, opt, {"loss": loss, **m}

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


def _lm_loss(params, cfg, batch):
    return T.train_loss(params, cfg, batch["tokens"], batch["targets"],
                        batch["mask"])


def lm_setup(arch: str, args, dev: torch.device):
    """(cfg, init_state, train_step) of an LM arch, as the JAX CLI's
    ``_lm_setup`` builds them (its mesh placement left out)."""
    mod = cfgbase.get(arch)
    cfg = mod.model_config() if args.full else mod.smoke_config()
    pipe = lm_pipeline.LMPipeline(lm_pipeline.LMDataConfig(
        vocab=cfg.vocab, batch=args.batch, seq_len=args.seq_len,
        seed=args.seed))
    step_fn = make_step(_lm_loss, cfg, adamw.AdamWConfig(lr=args.lr))
    events = None
    if dev.type == "cuda":
        fa_ops.backward_events = events = []

    def init_state():
        params = T.init_params(cfg, seed=args.seed, device=dev)
        return {"params": params, "opt": adamw.init_opt_state(params)}

    def train_step(state, step):
        batch = _to_device(pipe.batch(step), dev)
        lr_scale = schedules.warmup_cosine(
            torch.tensor(step, dtype=torch.int32), warmup=args.warmup,
            total=args.steps)
        if events is not None:
            events.clear()
        p, o, m = step_fn(state["params"], state["opt"], batch, lr_scale)
        out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
        if events:                   # the step's flash backwards, device ms
            events[-1][1].synchronize()
            out["flash_backward_ms"] = sum(a.elapsed_time(b)
                                           for a, b in events)
        return {"params": p, "opt": o}, out

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

    if args.arch in cfgbase.GNN_ARCHS:
        raise SystemExit(f"use {GNN_DRIVER} for {args.arch}")
    lm = args.arch in cfgbase.LM_ARCHS
    if not lm and args.arch not in FAMILIES:
        raise SystemExit(f"unknown arch {args.arch!r}; the port trains "
                         f"{sorted(FAMILIES) + sorted(cfgbase.LM_ARCHS)}")
    dev = resolve_device(args.device)
    L.full_fp32_matmul()
    mod = cfgbase.get(args.arch)
    setup = lm_setup if lm else recsys_setup
    cfg, init_state, train_step = setup(args.arch, args, dev)
    fa_kernel.n_launches = 0
    fa_kernel.route_launches.clear()
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
    step_ms = [1e3 * m["step_time_s"] for m in res.metrics]
    report = {
        "arch": args.arch, "device": str(dev), "batch": args.batch,
        "losses": losses, "step_ms": step_ms,
        "model_flops": (
            lm_common.model_flops(cfg, "train", args.batch, args.seq_len)
            if lm else mod._model_flops(cfg, args.batch, "train")),
        "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else None),
        "flash_launches": fa_kernel.n_launches,
        "flash_routes": dict(fa_kernel.route_launches),
        "ckpt": res.ckpt_writes}
    if lm:
        steady = statistics.median(step_ms[1:] or step_ms)
        report.update(
            seq_len=args.seq_len, tokens_per_step=args.batch * args.seq_len,
            median_step_ms=steady,
            tokens_per_s=args.batch * args.seq_len / (steady / 1e3),
            model_tflop_s=report["model_flops"] / (steady / 1e3) / 1e12,
            grad_norms=[m["grad_norm"] for m in res.metrics])
        if dev.type == "cuda":
            bwd = [m.get("flash_backward_ms", 0.0) for m in res.metrics]
            report.update(flash_backward_ms=bwd,
                          median_flash_backward_ms=statistics.median(
                              bwd[1:] or bwd))
    print("report: " + json.dumps(report))


if __name__ == "__main__":
    main()
