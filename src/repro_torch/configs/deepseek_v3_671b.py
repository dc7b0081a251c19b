"""deepseek-v3-671b — MLA + 256-expert MoE (1 shared, top-8) + MTP
[arXiv:2412.19437].  A copy of the JAX package's config.  The full
config does not fit one card (671 B parameters): the port runs its
smoke config, and ``dryrun_bundle`` sizes the full one on the
production meshes (``launch.dryrun``)."""

from repro_torch.configs import lm_common
from repro_torch.configs.base import Bundle
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

__all__ = ["ARCH", "SHAPES", "SKIPS", "model_config", "smoke_config",
           "dryrun_bundle"]

ARCH = "deepseek-v3-671b"
SHAPES = dict(lm_common.LM_SHAPES)
SKIPS = {"long_500k": "MLA compresses the cache but attention over 512k "
                      "cached positions is still full attention; skipped "
                      "per the sub-quadratic rule (DESIGN.md §5)"}


def model_config() -> T.LMConfig:
    return T.LMConfig(
        name=ARCH, n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        head_dim=128, d_ff=18432, vocab=129280, attn_type="mla",
        mla=T.MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                        qk_nope_dim=128, qk_rope_dim=64, v_dim=128),
        moe=M.MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                        n_shared=1, first_dense_layers=3,
                        capacity_factor=1.25),
        mtp=True, rope_theta=10_000.0)


def smoke_config() -> T.LMConfig:
    return T.LMConfig(
        name=ARCH + "-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=192, vocab=512, attn_type="mla",
        mla=T.MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                        qk_rope_dim=8, v_dim=16),
        moe=M.MoEConfig(n_experts=8, top_k=2, d_ff_expert=48, n_shared=1,
                        first_dense_layers=1),
        mtp=True, dtype="float32", block_q=32, loss_block=32)


def dryrun_bundle(shape: str, mesh, mode: str = "cost") -> Bundle:
    return lm_common.bundle(model_config(), shape, mesh, mode=mode)
