"""The paper's technique on the recsys funnel, on the port (the driver
of the JAX package's ``examples/recsys_funnel.py``: same sizes and
output lines): per-request retrieval depth k predicted by the LR
cascade, two-tower stage 1 + BST stage 2.

Run:  PYTHONPATH=src python -m repro_torch.examples.recsys_funnel \
          [--device cpu]

It runs on the CUDA card unless ``--device cpu`` asks for the CPU; with
no card and no ``--device`` it raises ``RuntimeError``.  Float32
products run in full float32 (``layers.full_fp32_matmul``), as the
funnel requires on a card.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core import cascade as cascade_lib
    from repro_torch.device import resolve_device
    from repro_torch.models import layers as L
    from repro_torch.models.recsys import bst as BS
    from repro_torch.models.recsys import retrieval_tower as RT
    from repro_torch.serving import funnel as F

    dev = resolve_device(args.device)
    L.full_fp32_matmul()
    tower_cfg = RT.TowerConfig(d_user_in=16, embed_dim=16, hidden=(32,),
                               n_candidates=5000)
    bst_cfg = BS.BSTConfig(embed_dim=16, seq_len=8, n_heads=4,
                           item_vocab=5000, n_profile=4, mlp=(64, 32))
    cfg = F.FunnelConfig(tower=tower_cfg, bst=bst_cfg, pool_depth=1000,
                         eval_depth=30, tau=0.05)

    tower_params = RT.init_tower(tower_cfg, seed=0, device=dev)
    bst_params = BS.init_bst(bst_cfg, seed=1, device=dev)

    rng = np.random.default_rng(0)
    n = 384
    user_feats = rng.normal(size=(n, 16)).astype(np.float32)
    hist = rng.integers(0, 5000, (n, 8)).astype(np.int32)
    hist[np.cumsum(np.ones((n, 8)), 1) > rng.integers(1, 9, (n, 1))] = -1

    print("== gold + per-k candidate runs (no judgments) ==")
    uf_t = torch.from_numpy(user_feats).to(dev)
    hist_t = torch.from_numpy(hist).to(dev)
    gold, runs = F.funnel_gold_runs(cfg, tower_params, bst_params, uf_t,
                                    hist_t)
    labels, table = F.label_requests(cfg, gold, runs)
    print("   class histogram:", np.bincount(labels,
                                             minlength=len(cfg.cutoffs) + 1))
    print("   mean MED_RBP per k:", np.round(table.mean(0), 3))

    print("== train cascade on request features ==")
    feats = F.request_features(uf_t, hist_t).cpu().numpy()
    casc = cascade_lib.train_cascade(
        feats[:256], labels[:256], n_cutoffs=len(cfg.cutoffs),
        forest_kwargs=dict(n_trees=8, max_depth=5), device=dev)

    funnel = F.Funnel(cfg, tower_params, bst_params, casc, device=dev)
    out = funnel.serve(user_feats[256:], hist[256:])
    # realized MED on held-out requests
    realized = []
    pred = cascade_lib.predict_batched(
        casc, torch.from_numpy(feats[256:]).to(dev), 0.75).cpu().numpy()
    for i, cls in enumerate(np.minimum(pred, len(cfg.cutoffs) - 1)):
        realized.append(table[256 + i, cls])
    fixed_k = cfg.cutoffs[-1]
    print(f"\n   dynamic mean k = {out['mean_k']:.0f}  "
          f"(fixed baseline k = {fixed_k})")
    print(f"   held-out realized MED_RBP = {np.mean(realized):.4f} "
          f"(envelope tau = {cfg.tau})")
    print(f"   retrieval work saved vs fixed: "
          f"{100 * (1 - out['mean_k'] / fixed_k):.0f}%")


if __name__ == "__main__":
    main()
