"""dbrx-132b — fine-grained MoE, 16 experts top-4
[hf:databricks/dbrx-base]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=10752, vocab_size=100352, head_dim=128,
        num_experts=16, top_k=4,
        norm="rmsnorm", act="silu", tie_embeddings=False,
        optimizer="adafactor", remat="full",
        remat_block=8, microbatches=2, accum_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="dbrx-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=512,
        num_experts=4, top_k=2,
        param_dtype="float32", compute_dtype="float32", remat="none",
    )
