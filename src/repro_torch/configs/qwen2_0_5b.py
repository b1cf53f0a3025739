"""qwen2-0.5b — dense GQA (kv=2), QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b", family="dense",
        num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
        d_ff=4864, vocab_size=151936, head_dim=64,
        qkv_bias=True, rope_theta=1e6,
        norm="rmsnorm", act="silu", tie_embeddings=True,
        remat="full",
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="qwen2-0.5b-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        param_dtype="float32", compute_dtype="float32", remat="none",
    )
