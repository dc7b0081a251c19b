"""qwen2-0.5b — GQA kv=2 with QKV bias [arXiv:2407.10671]."""

from repro_torch.configs import lm_common
from repro_torch.configs.base import Bundle
from repro_torch.models import transformer as T

__all__ = ["ARCH", "SHAPES", "SKIPS", "model_config", "smoke_config",
           "dryrun_bundle"]

ARCH = "qwen2-0.5b"
SHAPES = dict(lm_common.LM_SHAPES)
SKIPS = {"long_500k": "pure full attention; 512k decode needs sub-quadratic "
                      "attention (DESIGN.md §5)"}


def model_config() -> T.LMConfig:
    return T.LMConfig(
        name=ARCH, n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
        head_dim=64, d_ff=4864, vocab=151936, qkv_bias=True,
        rope_theta=1e6)


def smoke_config() -> T.LMConfig:
    return T.LMConfig(
        name=ARCH + "-smoke", n_layers=2, d_model=56, n_heads=7,
        n_kv_heads=1, head_dim=8, d_ff=128, vocab=512, qkv_bias=True,
        dtype="float32", block_q=32, loss_block=32)


def dryrun_bundle(shape: str, mesh, mode: str = "cost") -> Bundle:
    return lm_common.bundle(model_config(), shape, mesh, mode=mode)
