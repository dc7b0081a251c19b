"""Both packages' servers on one carried system, for the port's service
and observability tests: the JAX-built index and the JAX-trained forest
cascades cross to the port through ``repro_torch.convert``."""

import numpy as np

from repro.core import cascade as j_cascade
from repro.core import experiment as j_exp
from repro.core import labeling as j_labeling
from repro.serving import pipeline as j_pipeline
from repro_torch import convert
from repro_torch.serving import pipeline as t_pipeline


def carry_index(sys_):
    """The JAX-built index of ``sys_`` as the port's index on the CPU."""
    ix = sys_.index
    ts = ix.term_stats
    return convert.index_from_numpy(
        offsets=ix.offsets, postings_doc=ix.postings_doc,
        postings_impact=ix.postings_impact,
        postings_score=ix.postings_score, doc_len=ix.corpus.doc_len,
        stats=ts.stats, ctf=ts.ctf, df=ts.df, device="cpu")


def bare_servers(sys_, tindex, knob, **cfg_kw):
    """(JAX server, port server on the CPU) with no cascade, over the
    same carried index; ``cfg_kw`` goes to both ``ServingConfig``s."""
    cuts = sys_.k_cutoffs if knob == "k" else sys_.rho_cutoffs
    kw = dict(knob=knob, cutoffs=cuts, rerank_depth=30,
              stream_cap=sys_.cfg.stream_cap, kernel_block_p=64,
              kernel_block_d=512, **cfg_kw)
    return (j_pipeline.RetrievalServer(
                sys_.index, None,
                j_pipeline.ServingConfig(use_kernel=False, **kw)),
            t_pipeline.RetrievalServer(
                tindex, None, t_pipeline.ServingConfig(**kw), device="cpu"))


def carry_servers(sys_, knobs=("rho", "k")) -> dict:
    """{knob: (JAX server, port server on the CPU)}; the JAX engine runs
    its plain path (the port's CPU route runs the kernels' plain
    versions)."""
    tindex = carry_index(sys_)
    out = {}
    for knob in knobs:
        cuts = sys_.k_cutoffs if knob == "k" else sys_.rho_cutoffs
        med = j_exp.med_tables(sys_, knob, metrics=("rbp",))["rbp"]
        labels = np.asarray(j_labeling.envelope_labels(med, 0.05))
        casc = j_cascade.train_cascade(
            sys_.features, labels, n_cutoffs=len(cuts),
            forest_kwargs=dict(n_trees=5, max_depth=4))
        tcasc = convert.cascade_from_numpy(
            "forest", [{k: np.asarray(v) for k, v in p.items()}
                       for p in casc.node_params],
            casc.max_depth, casc.n_cutoffs, device="cpu")
        kw = dict(knob=knob, cutoffs=cuts, rerank_depth=30,
                  stream_cap=sys_.cfg.stream_cap, kernel_block_p=64,
                  kernel_block_d=512)
        out[knob] = (
            j_pipeline.RetrievalServer(
                sys_.index, casc,
                j_pipeline.ServingConfig(use_kernel=False, **kw)),
            t_pipeline.RetrievalServer(
                tindex, tcasc, t_pipeline.ServingConfig(**kw),
                device="cpu"))
    return out
