"""mamba2-370m — attention-free SSD (state-space duality)
[arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family="ssm",
        num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
        rope_type="none",
        norm="rmsnorm", tie_embeddings=True,
        remat="full",
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="mamba2-smoke", num_layers=2, d_model=64, vocab_size=512,
        ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
        param_dtype="float32", compute_dtype="float32", remat="none",
    )
