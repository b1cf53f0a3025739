"""whisper-large-v3 — enc-dec audio backbone; conv frontend is a STUB
(input_specs provides precomputed frame embeddings) [arXiv:2212.04356]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="encdec",
        num_layers=32, enc_layers=32, d_model=1280, num_heads=20,
        num_kv_heads=20, d_ff=5120, vocab_size=51866, head_dim=64,
        qkv_bias=True, rope_type="sinusoidal",
        norm="layernorm", act="gelu", tie_embeddings=True,
        enc_seq=1500, frontend="audio_stub",
        remat="full",
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="whisper-smoke", num_layers=2, enc_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
        enc_seq=16, param_dtype="float32", compute_dtype="float32",
        remat="none",
    )
