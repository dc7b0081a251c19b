"""qwen3-4b — qk_norm + GQA, head_dim decoupled from d_model [hf:Qwen/Qwen3]."""

from repro_torch.configs import lm_common
from repro_torch.configs.base import Bundle
from repro_torch.models import transformer as T

__all__ = ["ARCH", "SHAPES", "SKIPS", "model_config", "smoke_config",
           "dryrun_bundle"]

ARCH = "qwen3-4b"
SHAPES = dict(lm_common.LM_SHAPES)
SKIPS = {"long_500k": "pure full attention; 512k decode needs sub-quadratic "
                      "attention (DESIGN.md §5)"}


def model_config() -> T.LMConfig:
    return T.LMConfig(
        name=ARCH, n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
        head_dim=128, d_ff=9728, vocab=151936, qk_norm=True,
        rope_theta=1e6)


def smoke_config() -> T.LMConfig:
    return T.LMConfig(
        name=ARCH + "-smoke", n_layers=2, d_model=48, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, qk_norm=True,
        dtype="float32", block_q=32, loss_block=32)


def dryrun_bundle(shape: str, mesh, mode: str = "cost") -> Bundle:
    return lm_common.bundle(model_config(), shape, mesh, mode=mode)
