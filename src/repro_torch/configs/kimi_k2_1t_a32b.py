"""kimi-k2-1t-a32b — trillion-parameter MoE, 384 experts top-8 (paper-table
config) [arXiv:2501.kimi2].

Per the assigned table this uses GQA kv=8 (real Kimi K2 uses MLA — recorded
as an assignment-table simplification in DESIGN.md). d_ff=2048 is the
per-expert width. Adafactor + bf16 params so optimizer state fits
512 × 16 GB HBM (DESIGN.md §5).
"""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
        d_ff=2048, vocab_size=163840, head_dim=112,
        num_experts=384, top_k=8,
        norm="rmsnorm", act="silu", tie_embeddings=False,
        optimizer="adafactor", remat="full",
        remat_block=8, microbatches=2, accum_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="kimi-k2-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=32, vocab_size=512,
        num_experts=4, top_k=2,
        param_dtype="float32", compute_dtype="float32", remat="none",
    )
