"""granite-3-2b — dense GQA kv=8 [hf:ibm-granite/granite-3.0-2b-base]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b", family="dense",
        num_layers=40, d_model=2048, num_heads=32, num_kv_heads=8,
        d_ff=8192, vocab_size=49155, head_dim=64,
        norm="rmsnorm", act="silu", tie_embeddings=True,
        remat="full",
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="granite-3-2b-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        param_dtype="float32", compute_dtype="float32", remat="none",
    )
