"""olmo-1b — dense MHA, non-parametric LayerNorm [arXiv:2402.00838; hf]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b", family="dense",
        num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=8192, vocab_size=50304, head_dim=128,
        norm="layernorm_np", act="silu", tie_embeddings=True,
        remat="full",
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="olmo-1b-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
        param_dtype="float32", compute_dtype="float32", remat="none",
    )
