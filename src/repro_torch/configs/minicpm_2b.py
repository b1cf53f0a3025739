"""minicpm-2b — llama-like dense with WSD schedule + μP-style scalings
[arXiv:2404.06395; hf]. residual_scale = 1.4/sqrt(L); logit_scale =
256/d_model (hidden-dim base 256)."""
import math

from repro_torch.models.config import ModelConfig

SCHEDULE = "wsd"    # warmup-stable-decay, the paper's schedule

_L = 40
_D = 2304


def full() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b", family="dense",
        num_layers=_L, d_model=_D, num_heads=36, num_kv_heads=36,
        d_ff=5760, vocab_size=122753, head_dim=64,
        norm="rmsnorm", act="silu", tie_embeddings=True,
        residual_scale=1.4 / math.sqrt(_L), logit_scale=256.0 / _D,
        remat="full",
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="minicpm-2b-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
        residual_scale=1.4 / math.sqrt(2), logit_scale=1.0,
        param_dtype="float32", compute_dtype="float32", remat="none",
    )
