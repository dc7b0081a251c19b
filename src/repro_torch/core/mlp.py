"""MLP classifier node: the differentiable alternative cascade node.

A copy of the JAX package's ``core/mlp.py``: logits over C classes with
the same ``predict_proba`` interface as the forest, so the cascade is
agnostic to the node family.  GELU is the tanh approximation, which is
``jax.nn.gelu``'s default.  Training keeps the reference's numpy-seeded
He init, its numpy permutation order and its hand-written AdamW (bias
correction by 0.9**t and 0.999**t, decoupled weight decay); gradients
come from ``torch.autograd``.  Two frameworks' float32 steps round
differently, so a trained node is close to the reference's, not equal.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.layers import to_device

__all__ = ["MLPClassifier", "train_mlp", "mlp_predict_proba"]


@dataclass
class MLPClassifier:
    params: dict          # {"layers": [{"w": (a, b), "b": (b,)}, ...]}
    mean: np.ndarray
    std: np.ndarray
    n_classes: int

    def as_torch(self, device) -> dict:
        """The state ``mlp_predict_proba`` takes, on ``device``."""
        return to_device({"params": self.params, "mean": self.mean,
                          "std": self.std}, device)


def _init(rng: np.random.Generator, sizes) -> dict:
    params = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        k = rng.normal(0, (2.0 / a) ** 0.5, (a, b)).astype(np.float32)
        params.append({"w": k, "b": np.zeros(b, np.float32)})
    return {"layers": params}


def _forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = x
    layers = params["layers"]
    for i, lyr in enumerate(layers):
        h = h @ lyr["w"] + lyr["b"]
        if i + 1 < len(layers):
            h = F.gelu(h, approximate="tanh")
    return h


def mlp_predict_proba(state: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, F) features -> (B, C) class probabilities."""
    xn = (x - state["mean"]) / state["std"]
    return torch.softmax(_forward(state["params"], xn), dim=-1)


def train_mlp(x: np.ndarray, y: np.ndarray, *, n_classes: int,
              hidden: tuple[int, ...] = (64, 32), epochs: int = 30,
              batch: int = 512, lr: float = 3e-3, weight_decay: float = 1e-4,
              class_weight: np.ndarray | None = None, seed: int = 0,
              device=None) -> MLPClassifier:
    """Train on ``device`` (default ``"cuda"``); the returned params are
    host numpy arrays."""
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.int64)
    mean = x.mean(0)
    std = x.std(0) + 1e-6
    xn = torch.from_numpy((x - mean) / std).to(dev)
    yt = torch.from_numpy(y).to(dev)
    rng = np.random.default_rng(seed)
    params = to_device(_init(rng, (x.shape[1], *hidden, n_classes)), dev)
    leaves = [lyr[k] for lyr in params["layers"] for k in ("w", "b")]
    for p in leaves:
        p.requires_grad_(True)
    cw = torch.as_tensor(class_weight if class_weight is not None
                         else np.ones(n_classes), dtype=torch.float32,
                         device=dev)
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    t = 0
    n = x.shape[0]
    for _ in range(epochs):
        order = rng.permutation(n)
        for s in range(0, n - batch + 1, batch):
            sel = torch.from_numpy(order[s:s + batch]).to(dev)
            xb, yb = xn[sel], yt[sel]
            ll = torch.log_softmax(_forward(params, xb), dim=-1)
            nll = -ll.gather(1, yb[:, None])[:, 0]
            grads = torch.autograd.grad((nll * cw[yb]).mean(), leaves)
            t += 1
            # the reference's bias corrections, in float32 as it takes them
            c1 = 1 - torch.tensor(0.9, device=dev) ** t
            c2 = 1 - torch.tensor(0.999, device=dev) ** t
            with torch.no_grad():
                for p, g, mi, vi in zip(leaves, grads, m, v):
                    mi.mul_(0.9).add_(0.1 * g)
                    vi.mul_(0.999).add_(0.001 * g * g)
                    p.sub_(lr * ((mi / c1) / (torch.sqrt(vi / c2) + 1e-8)
                                 + weight_decay * p))
    host = {"layers": [{k: lyr[k].detach().cpu().numpy() for k in ("w", "b")}
                       for lyr in params["layers"]]}
    return MLPClassifier(params=host, mean=mean, std=std, n_classes=n_classes)
