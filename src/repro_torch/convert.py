"""Carry state built elsewhere (e.g. by the JAX package) across as numpy
arrays, so both packages can serve the same index and cascade."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cascade import Cascade
from repro_torch.device import resolve_device
from repro_torch.models import layers
from repro_torch.retrieval.index import InvertedIndex, TermStats
from repro_torch.tree import leaves, map_tree

__all__ = ["index_from_numpy", "cascade_from_numpy", "mlp_from_numpy",
           "tower_from_numpy", "bst_from_numpy", "wide_deep_from_numpy",
           "dien_from_numpy", "mind_from_numpy", "adamw_state_from_numpy",
           "lm_from_numpy", "sage_from_numpy"]

_FOREST_TABLES = {"feature": np.int32, "thresh": np.float32,
                  "left": np.int32, "right": np.int32, "leaf": np.float32}


def _put(a, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)


def index_from_numpy(*, offsets, postings_doc, postings_impact,
                     postings_score, doc_len, stats, ctf, df,
                     device=None) -> InvertedIndex:
    """An ``InvertedIndex`` from the arrays of an impact-ordered index:
    CSR ``offsets`` (vocab+1,), postings doc ids / uint8 impacts /
    (nnz, 3) scores, ``doc_len`` (n_docs,), and the term statistics
    ``stats`` (vocab, 3, 9), ``ctf`` and ``df`` (vocab,)."""
    dev = resolve_device(device)
    return InvertedIndex(
        offsets=_put(offsets, np.int64, dev),
        postings_doc=_put(postings_doc, np.int32, dev),
        postings_score=_put(postings_score, np.float32, dev),
        postings_impact=_put(postings_impact, np.uint8, dev),
        term_stats=TermStats(stats=_put(stats, np.float32, dev),
                             ctf=_put(ctf, np.float32, dev),
                             df=_put(df, np.float32, dev)),
        doc_len=_put(doc_len, np.int32, dev))


def cascade_from_numpy(kind: str, node_params, max_depth: int,
                       n_cutoffs: int, *, device=None) -> Cascade:
    """A ``Cascade`` from per-node parameters: forest tables (dicts of
    arrays keyed feature/thresh/left/right/leaf) or MLP states (see
    ``mlp_from_numpy``)."""
    if kind not in ("forest", "mlp"):
        raise ValueError(f"unknown node kind {kind!r}")
    if len(node_params) != n_cutoffs:
        raise ValueError(f"{len(node_params)} node tables for "
                         f"{n_cutoffs} cutoffs")
    dev = resolve_device(device)
    if kind == "forest":
        params = [{k: _put(p[k], dt, dev)
                   for k, dt in _FOREST_TABLES.items()}
                  for p in node_params]
    else:
        params = [mlp_from_numpy(p, device=dev) for p in node_params]
    return Cascade(kind=kind, nodes=[], node_params=params,
                   max_depth=max_depth, n_cutoffs=n_cutoffs)


def mlp_from_numpy(state: dict, *, device=None) -> dict:
    """The state ``core.mlp.mlp_predict_proba`` takes, from the JAX
    package's ``MLPClassifier.as_jax()`` tree (``{"params": {"layers":
    [{"w", "b"}, ...]}, "mean", "std"}`` of float32 arrays)."""
    _check_keys(state, ("params", "mean", "std"), "MLP state")
    _check_keys(state["params"], ("layers",), "MLP params")
    for lyr in state["params"]["layers"]:
        _check_keys(lyr, _LINEAR, "MLP layer")
    return layers.to_device(_as_f32(state), resolve_device(device))


_LINEAR = ("w", "b")
_BST_BLOCK = ("wq", "wk", "wv", "wo", "ln1_w", "ln1_b", "ln2_w", "ln2_b",
              "ff1", "ff2")


def _check_keys(tree: dict, keys, what: str) -> None:
    if set(tree) != set(keys):
        raise ValueError(f"{what} has keys {sorted(tree)}, expected "
                         f"{sorted(keys)}")


def tower_from_numpy(params: dict, *, device=None) -> dict:
    """The port's two-tower parameters from the JAX package's tree
    (``{"mlp": [{"w", "b"}, ...], "items"}`` of float32 arrays)."""
    _check_keys(params, ("mlp", "items"), "tower params")
    for lyr in params["mlp"]:
        _check_keys(lyr, _LINEAR, "tower MLP layer")
    return layers.to_device(_as_f32(params), resolve_device(device))


def bst_from_numpy(params: dict, *, device=None) -> dict:
    """The port's BST parameters from the JAX package's tree (item and
    positional tables, blocks, MLP and head of float32 arrays)."""
    _check_keys(params, ("item_table", "pos_table", "blocks", "mlp", "head"),
                "BST params")
    for blk in params["blocks"]:
        _check_keys(blk, _BST_BLOCK, "BST block")
    for lyr in params["mlp"]:
        _check_keys(lyr, _LINEAR, "BST MLP layer")
    return layers.to_device(_as_f32(params), resolve_device(device))


def wide_deep_from_numpy(params: dict, *, device=None) -> dict:
    """The port's Wide & Deep parameters from the JAX package's tree
    (deep, wide and cross tables, MLP, head, wide dense weights, bias)."""
    _check_keys(params, ("deep_table", "wide_table", "cross_table", "mlp",
                         "head", "wide_dense", "bias"), "wide-deep params")
    for lyr in params["mlp"]:
        _check_keys(lyr, _LINEAR, "wide-deep MLP layer")
    return layers.to_device(_as_f32(params), resolve_device(device))


_GRU = ("wz", "wr", "wh", "bz", "br", "bh")


def dien_from_numpy(params: dict, *, device=None) -> dict:
    """The port's DIEN parameters from the JAX package's tree (item and
    category tables, the GRU and AUGRU, attention and auxiliary maps,
    MLP and head)."""
    _check_keys(params, ("item_table", "cat_table", "gru1", "augru",
                         "attn_w", "aux_w", "mlp", "head"), "DIEN params")
    for gru in ("gru1", "augru"):
        _check_keys(params[gru], _GRU, f"DIEN {gru}")
    for lyr in params["mlp"]:
        _check_keys(lyr, _LINEAR, "DIEN MLP layer")
    return layers.to_device(_as_f32(params), resolve_device(device))


def mind_from_numpy(params: dict, *, device=None) -> dict:
    """The port's MIND parameters from the JAX package's float32 tree
    (item table, bilinear map, routing init)."""
    _check_keys(params, ("item_table", "bilinear", "routing_init"),
                "MIND params")
    return layers.to_device(_as_f32(params), resolve_device(device))


def adamw_state_from_numpy(state: dict, params: dict) -> dict:
    """The port's AdamW state from the JAX package's (``{"m", "v",
    "step"}``): float32 moments shaped and placed as ``params``, and the
    step as a 0-d int32 tensor."""
    _check_keys(state, ("m", "v", "step"), "AdamW state")
    dev = leaves(params)[0].device

    def moments(m):
        out = map_tree(
            lambda a: torch.from_numpy(np.array(a, np.float32)).to(dev), m)
        for a, p in zip(leaves(out), leaves(params), strict=True):
            if a.shape != p.shape:
                raise ValueError(f"a moment of shape {tuple(a.shape)} for "
                                 f"a parameter of {tuple(p.shape)}")
        return out

    return {"m": moments(state["m"]), "v": moments(state["v"]),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev)}


def lm_from_numpy(params: dict, *, device=None) -> dict:
    """The port's LM parameters (``models.transformer``, MLA and MTP
    trees included) from the JAX package's tree, bit for bit.  float32
    leaves pass as they are; bfloat16 leaves (``ml_dtypes.bfloat16``
    arrays, which ``torch.from_numpy`` does not take) are viewed as
    uint16 and the tensor as ``torch.bfloat16``, so the bits pass
    unchanged."""
    top = {"embed", "final_norm", "lm_head", "dense", "moe", "mtp"}
    if not {"embed", "final_norm", "lm_head"} <= set(params) <= top:
        raise ValueError(f"LM params have keys {sorted(params)}, expected "
                         f"embed, final_norm, lm_head, dense or moe, and "
                         "mtp (deepseek)")
    dev = resolve_device(device)

    def leaf(a):
        a = np.ascontiguousarray(np.asarray(a))
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16)).view(
                torch.bfloat16).to(dev)
        if a.dtype != np.float32:
            raise ValueError(f"an LM leaf of dtype {a.dtype}; the port "
                             "takes float32 and bfloat16")
        return torch.from_numpy(a).to(dev)

    return map_tree(leaf, params)


def sage_from_numpy(params: dict, *, device=None) -> dict:
    """The port's GraphSAGE parameters (``models.gnn``) from the JAX
    package's ``init_sage`` tree: float32 leaves, bit for bit, each a
    copy (AdamW updates the port's parameters in place, and on the CPU
    a tensor from ``torch.from_numpy`` shares the caller's array)."""
    _check_keys(params, ("layers", "head", "graph_head"), "GraphSAGE params")
    for lp in params["layers"]:
        _check_keys(lp, ("w_self", "w_neigh", "b"), "a GraphSAGE layer")
    dev = resolve_device(device)
    return map_tree(lambda a: torch.from_numpy(np.array(a, np.float32))
                    .to(dev), params)


def _as_f32(tree):
    if isinstance(tree, dict):
        return {k: _as_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_f32(v) for v in tree]
    return np.asarray(tree, np.float32)
