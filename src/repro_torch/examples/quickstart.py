"""Quickstart: the paper's method end to end on the port (the driver of
the JAX package's ``examples/quickstart.py``, same sizes and output).

Builds a synthetic collection, computes MED_RBP labels at the 9
k-cutoffs against a second-stage gold run, trains the LR binary cascade
on the 70 static features, and prints the Table-4-style tradeoff against
the fixed-cutoff horizon.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

It runs on the CUDA card unless ``--device cpu`` asks for the CPU; with
no card and no ``--device`` it raises ``RuntimeError``.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import experiment as E


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    print("== building corpus / impact-ordered index / query log ==")
    sys_ = E.build_system(E.ExperimentConfig(
        n_docs=4000, vocab=8000, n_queries=400, stream_cap=1024,
        pool_depth=2000, gold_depth=200, query_batch=128),
        device=args.device)
    print(f"   docs={sys_.cfg.n_docs} postings={sys_.index.nnz} "
          f"queries={sys_.queries.n_queries} features={sys_.features.shape}")

    print("== MED_RBP labeling at the 9 k cutoffs (no judgments!) ==")
    m = E.med_tables(sys_, "k", metrics=("rbp",))["rbp"]
    print("   mean MED_RBP per cutoff:", np.round(m.mean(0), 3))

    print("== cascade vs baselines at MED_RBP <= 0.05 ==")
    res = E.run_methods(sys_, m, sys_.k_cutoffs, tau=0.05,
                        thresholds=(0.75, 0.85), n_folds=2,
                        forest_kwargs=dict(n_trees=8, max_depth=6))
    hdr = f"{'method':<16}{'mean-k':>8}{'MED':>8}{'fixed-k':>9}{'gain':>8}"
    print("   " + hdr)
    for r in res.table:
        print(f"   {r['method']:<16}{r['pred_k']:>8.0f}"
              f"{r['pred_med']:>8.3f}{r['fixed_k']:>9.0f}"
              f"{r['k_gain_pct']:>+7.0f}%")
    print("\nInterpretation: 'gain' is how much larger a fixed global k "
          "would need to be\nto reach the same effectiveness the per-query "
          "prediction achieves.")


if __name__ == "__main__":
    main()
