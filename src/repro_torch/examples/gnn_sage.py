"""GraphSAGE minibatch training with the real fanout sampler, on the port
(the driver of the JAX package's ``examples/gnn_sage.py``: same graph,
config, optimiser and output lines).

Builds a synthetic power-law graph, trains GraphSAGE with sampled blocks
(fanout 15-10 scaled down to 8-5), evaluates full-batch accuracy.

Run:  PYTHONPATH=src python -m repro_torch.examples.gnn_sage [--device cpu]

It runs on the CUDA card unless ``--device cpu`` asks for the CPU; with
no card and no ``--device`` it raises ``RuntimeError``.  The sampler
draws from a ``torch.Generator`` seeded 0 on the device, so the sampled
losses are not the JAX run's (whose bits come from ``jax.random``); the
seed batches are numpy's, as in the reference.
"""

from __future__ import annotations

import argparse

import numpy as np


def blocks_loss(params, cfg, batch):
    """``sage_loss_blocks`` over a batch {"feats", "blocks", "labels"}:
    the loss function of ``launch.train.make_step``."""
    from repro_torch.models import gnn
    return gnn.sage_loss_blocks(params, cfg, batch["feats"], batch["blocks"],
                                batch["labels"])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.data import graph_data
    from repro_torch.device import resolve_device
    from repro_torch.launch.train import make_step
    from repro_torch.models import gnn, sampler
    from repro_torch.models import layers as L
    from repro_torch.optim import adamw

    dev = resolve_device(args.device)
    L.full_fp32_matmul()
    cfg = gnn.SageConfig(n_layers=2, d_in=32, d_hidden=32, n_classes=8)
    g = graph_data.make_graph(graph_data.GraphConfig(
        n_nodes=2000, n_edges=12000, d_feat=cfg.d_in,
        n_classes=cfg.n_classes, seed=0))
    indptr, indices = sampler.csr_from_edges(g["edges"], 2000, device=dev)
    feats_all = torch.from_numpy(g["feats"]).to(dev)
    labels_all = torch.from_numpy(g["labels"]).to(dev)
    edges = torch.from_numpy(g["edges"]).to(dev)

    params = gnn.init_sage(cfg, seed=0, device=dev)
    opt = adamw.init_opt_state(params)
    train_step = make_step(blocks_loss, cfg,
                           adamw.AdamWConfig(lr=5e-3, weight_decay=0.0))

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    batch = 128
    rng = np.random.default_rng(0)
    for step in range(60):
        seeds = torch.from_numpy(rng.choice(2000, batch, replace=False)
                                 .astype(np.int32)).to(dev)
        fr, bl = sampler.sample_blocks(gen, indptr, indices, seeds, (8, 5))
        feats = [feats_all[f.long()] for f in fr]
        params, opt, m = train_step(params, opt, {
            "feats": feats, "blocks": bl,
            "labels": labels_all[seeds.long()]})
        if step % 10 == 0:
            with torch.no_grad():
                logits = gnn.sage_forward_full(params, cfg, feats_all, edges)
            acc = float((torch.argmax(logits, 1) == labels_all)
                        .to(torch.float32).mean())
            print(f"step {step:3d}  sampled-loss {float(m['loss']):.3f}  "
                  f"full-graph acc {acc:.3f}")
    print("done — sampled training transfers to full-graph inference")


if __name__ == "__main__":
    main()
