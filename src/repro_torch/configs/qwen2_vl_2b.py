"""qwen2-vl-2b — VLM text backbone with M-RoPE; patch-embed frontend is a
STUB (input_specs provides precomputed patch embeddings)
[arXiv:2409.12191; hf]. mrope_sections are half-dim sizes (sum = hd/2)."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b", family="vlm",
        num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
        d_ff=8960, vocab_size=151936, head_dim=128,
        qkv_bias=True, rope_type="mrope", mrope_sections=(16, 24, 24),
        rope_theta=1e6,
        norm="rmsnorm", act="silu", tie_embeddings=True,
        frontend="vision_stub", num_patches=256,
        remat="full",
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="qwen2-vl-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        mrope_sections=(2, 3, 3), num_patches=4,
        param_dtype="float32", compute_dtype="float32", remat="none",
    )
