"""mixtral-8x22b — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088]."""

from repro_torch.configs import lm_common
from repro_torch.configs.base import Bundle
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

__all__ = ["ARCH", "SHAPES", "SKIPS", "model_config", "smoke_config",
           "dryrun_bundle"]

ARCH = "mixtral-8x22b"
SHAPES = dict(lm_common.LM_SHAPES)
SKIPS = {}  # SWA decode is O(window): long_500k runs (ring cache)


def model_config() -> T.LMConfig:
    return T.LMConfig(
        name=ARCH, n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
        head_dim=128, d_ff=16384, vocab=32768, window=4096,
        moe=M.MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384,
                        capacity_factor=1.25),
        rope_theta=1e6)


def smoke_config() -> T.LMConfig:
    return T.LMConfig(
        name=ARCH + "-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, head_dim=8, d_ff=128, vocab=512, window=16,
        moe=M.MoEConfig(n_experts=4, top_k=2, d_ff_expert=64),
        dtype="float32", block_q=32, loss_block=32)


def dryrun_bundle(shape: str, mesh, mode: str = "cost") -> Bundle:
    return lm_common.bundle(model_config(), shape, mesh, mode=mode)
