"""BST (Chen et al., 2019), the Behavior Sequence Transformer: stage 2
of the funnel.

The candidate item is appended to the behaviour sequence, learned
positional embeddings added, one post-LN transformer block applied, and
the flattened sequence output and the profile features feed the final
MLP.  The block's attention core is ``models.attention.chunked_attention``
(the flash-attention kernel on a CUDA tensor).  History padding (-1)
embeds item 0 and attends like any other position, as in the reference:
there is no key mask, and padding rows are zeroed only after the block.
The q/k/v/o, feed-forward and MLP products are plain ``torch.matmul`` in
full float32 when the program has called ``layers.full_fp32_matmul``
(TF32 off, as the reference; ``Funnel`` checks it).  ``bst_loss`` is
the training loss (bce of the logits); under autograd the attention runs
the same kernel forward through ``ops.FlashAttention``, and the item
table is read through ``embedding.gather_rows`` (a deterministic
backward).  ``use_kernel=False`` runs the plain attention instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.recsys.embedding import gather_rows
from repro_torch.models.recsys.wide_deep import bce

__all__ = ["BSTConfig", "init_bst", "bst_logits", "bst_loss"]


@dataclasses.dataclass(frozen=True)
class BSTConfig:
    embed_dim: int = 32
    seq_len: int = 20
    n_blocks: int = 1
    n_heads: int = 8
    item_vocab: int = 2_000_000
    n_profile: int = 8
    mlp: tuple[int, ...] = (1024, 512, 256)
    ff_mult: int = 4
    dtype: str = "float32"

    @property
    def tdtype(self) -> torch.dtype:
        return L.torch_dtype(self.dtype)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.n_heads


def _draw_bst(cfg: BSTConfig, rng) -> dict:
    """The parameter tree as float32 numpy arrays, drawn in the JAX
    package's order: each block's six products, the MLP, then the item
    table, the positional table and the head."""
    d = cfg.embed_dim
    blocks = []
    for _ in range(cfg.n_blocks):
        blocks.append({
            "wq": L.init_linear(rng, (d, d)),
            "wk": L.init_linear(rng, (d, d)),
            "wv": L.init_linear(rng, (d, d)),
            "wo": L.init_linear(rng, (d, d)),
            "ln1_w": L.init_norm((d,)), "ln1_b": np.zeros((d,), np.float32),
            "ln2_w": L.init_norm((d,)), "ln2_b": np.zeros((d,), np.float32),
            "ff1": L.init_linear(rng, (d, cfg.ff_mult * d)),
            "ff2": L.init_linear(rng, (cfg.ff_mult * d, d)),
        })
    d_in = (cfg.seq_len + 1) * d + cfg.n_profile
    mlp = []
    for h in cfg.mlp:
        mlp.append({"w": L.init_linear(rng, (d_in, h)),
                    "b": np.zeros((h,), np.float32)})
        d_in = h
    return {
        "item_table": rng.normal(0, d ** -0.5,
                                 (cfg.item_vocab, d)).astype(np.float32),
        "pos_table": rng.normal(0, d ** -0.5,
                                (cfg.seq_len + 1, d)).astype(np.float32),
        "blocks": blocks,
        "mlp": mlp,
        "head": L.init_linear(rng, (d_in, 1)),
    }


def init_bst(cfg: BSTConfig, seed: int = 0, *, device=None,
             abstract: bool = False) -> dict:
    """Seeded parameters on ``device`` (default ``"cuda"``), equal to the
    JAX package's ``init_bst`` for the same seed; with ``abstract``,
    FakeArrays (nothing drawn or placed)."""
    tree = _draw_bst(cfg, L.rng_or_abstract(seed, abstract))
    if abstract:
        return L.abstract_leaves(tree, cfg.tdtype)
    return L.to_device(tree, resolve_device(device), cfg.tdtype)


def bst_logits(params: dict, cfg: BSTConfig, batch: dict, *,
               use_kernel: bool = True) -> torch.Tensor:
    """batch: hist_items (B, T), target_item (B,), profile (B, P) ->
    (B,) float32 logits."""
    b, t = batch["hist_items"].shape
    seq = torch.cat([batch["hist_items"], batch["target_item"][:, None]],
                    dim=1)
    mask = seq >= 0
    x = gather_rows(params["item_table"], seq.clamp(min=0))
    x = x + params["pos_table"][None, :, :]
    for blk in params["blocks"]:
        q = (x @ blk["wq"]).reshape(b, t + 1, cfg.n_heads, cfg.head_dim)
        k = (x @ blk["wk"]).reshape(b, t + 1, cfg.n_heads, cfg.head_dim)
        v = (x @ blk["wv"]).reshape(b, t + 1, cfg.n_heads, cfg.head_dim)
        o = A.chunked_attention(q, k, v, causal=False,
                                use_kernel=use_kernel)
        h = o.reshape(b, t + 1, -1) @ blk["wo"]
        x = L.layer_norm(blk["ln1_w"], blk["ln1_b"], x + h)  # post-LN
        f = torch.relu(x @ blk["ff1"]) @ blk["ff2"]
        x = L.layer_norm(blk["ln2_w"], blk["ln2_b"], x + f)
    x = x * mask[:, :, None].to(x.dtype)
    flat = torch.cat([x.reshape(b, -1), batch["profile"].to(x.dtype)],
                     dim=-1)
    for lyr in params["mlp"]:
        flat = F.leaky_relu(flat @ lyr["w"] + lyr["b"], 0.01)
    return (flat @ params["head"])[:, 0].to(torch.float32)


def bst_loss(params: dict, cfg: BSTConfig, batch: dict, *,
             use_kernel: bool = True) -> torch.Tensor:
    return bce(bst_logits(params, cfg, batch, use_kernel=use_kernel),
               batch["label"])
