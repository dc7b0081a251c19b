"""tinyllama-1.1b — llama2-arch small [arXiv:2401.02385]."""

from repro_torch.configs import lm_common
from repro_torch.configs.base import Bundle
from repro_torch.models import transformer as T

__all__ = ["ARCH", "SHAPES", "SKIPS", "model_config", "smoke_config",
           "dryrun_bundle"]

ARCH = "tinyllama-1.1b"
SHAPES = dict(lm_common.LM_SHAPES)
SKIPS = {"long_500k": "pure full attention; 512k decode needs sub-quadratic "
                      "attention (DESIGN.md §5)"}


def model_config() -> T.LMConfig:
    return T.LMConfig(
        name=ARCH, n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
        head_dim=64, d_ff=5632, vocab=32000, rope_theta=10_000.0)


def smoke_config() -> T.LMConfig:
    return T.LMConfig(
        name=ARCH + "-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, head_dim=8, d_ff=160, vocab=512, dtype="float32",
        block_q=32, loss_block=32)


def dryrun_bundle(shape: str, mesh, mode: str = "cost") -> Bundle:
    return lm_common.bundle(model_config(), shape, mesh, mode=mode)
