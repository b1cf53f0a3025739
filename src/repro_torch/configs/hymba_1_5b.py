"""hymba-1.5b — hybrid: parallel attention + Mamba heads per layer, sliding
window with periodic global layers [arXiv:2411.13676; hf].

Deviation note (DESIGN.md): real Hymba has 3 global layers (first/middle/
last) + meta tokens; we use global_every=8 (layers 0,8,16,24) and no meta
tokens — same compute/memory class.
"""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
        d_ff=5504, vocab_size=32001, head_dim=64,
        window=1024, global_every=8,
        ssm_state=16, ssm_head_dim=64, ssm_expand=2,
        norm="rmsnorm", act="silu", tie_embeddings=True,
        remat="full",
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="hymba-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        window=8, global_every=2, ssm_state=8, ssm_head_dim=16,
        ssm_chunk=8,
        param_dtype="float32", compute_dtype="float32", remat="none",
    )
