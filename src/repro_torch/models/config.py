"""Model configuration schema covering all assigned architecture families
(a copy of ``repro.models.config``, so that the port imports nothing of
the JAX package).

One frozen dataclass describes dense / MoE / SSM / hybrid / enc-dec / VLM
backbones; family-specific fields are zero/empty when unused. Configs are
pure data — layer code dispatches on them, so every architecture is a
config file, not a code fork.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int                   # 0 => attention-free (pure SSM)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 => d_model // num_heads

    # attention details
    qkv_bias: bool = False
    rope_type: str = "rope"          # rope | mrope | sinusoidal | none
    rope_theta: float = 1e4
    mrope_sections: tuple[int, ...] = ()   # qwen2-vl (t, h, w) head_dim split
    window: int = 0                  # sliding-window size; 0 = global
    global_every: int = 0            # hybrid: every Nth layer is global attn

    # norms / activations
    norm: str = "rmsnorm"            # rmsnorm | layernorm | layernorm_np
    act: str = "silu"                # silu (SwiGLU) | gelu (plain MLP)
    norm_eps: float = 1e-5

    # MoE
    num_experts: int = 0
    top_k: int = 0

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # enc-dec (whisper)
    enc_layers: int = 0
    enc_seq: int = 1500              # post-conv frame count (frontend stub)

    # modality frontend stubs
    frontend: str = "none"           # none | audio_stub | vision_stub
    num_patches: int = 0             # vlm: patch positions at seq start

    # embeddings / output
    tie_embeddings: bool = True
    logit_softcap: float = 0.0
    residual_scale: float = 1.0      # minicpm depth scaling: 1.4/sqrt(L)
    logit_scale: float = 1.0         # minicpm: 1/(d_model/256)

    # numerics / memory policy
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "none"              # none | full | dots
    remat_block: int = 0             # >1: two-level checkpointing — only
    #   every remat_block-th layer boundary is saved; the block re-runs in
    #   backward. Cuts the layer-scan carry stack L/k× (1T-param configs).
    microbatches: int = 1            # gradient-accumulation splits of the
    #   global batch in train_step
    accum_dtype: str = "float32"     # grad-accumulator dtype (bf16 on the
    #   largest configs: a f32 accumulator is a full param-sized buffer)
    tp_reduce_bf16: bool = True      # round row-parallel matmul partials
    #   to bf16 before the TP psum — halves the dominant collective bytes
    #   (the MXU still accumulates f32 within each shard; only the cross-
    #   shard sum of <=16 partials is bf16). §Perf iteration 8.
    optimizer: str = "adamw"         # adamw | adafactor (giants)

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (roofline MODEL_FLOPS = 6·N·D) ---------------
    def param_counts(self) -> dict:
        """Returns dict with total and active parameter counts."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd = self.resolved_head_dim
        H, KV = self.num_heads, self.num_kv_heads
        embed = V * D * (1 if self.tie_embeddings else 2)
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D  # q,k,v,o
        if self.qkv_bias:
            attn += (H + 2 * KV) * hd
        mlp_dense = 3 * D * F if self.act == "silu" else 2 * D * F
        per_layer = 0
        total = embed
        active = embed
        if self.family == "ssm":
            din, N, nh = self.d_inner, self.ssm_state, self.ssm_heads
            # in_proj: z,x,B,C,dt ; out_proj
            inp = D * (2 * din + 2 * N + nh)
            per_layer = inp + din * D + self.ssm_conv * (din + 2 * N) + 2 * nh
            total += L * per_layer
            active += L * per_layer
        elif self.family in ("moe",):
            router = D * self.num_experts
            expert = 3 * D * F
            per_layer = attn + router + self.num_experts * expert
            act_layer = attn + router + self.top_k * expert
            total += L * per_layer
            active += L * act_layer
        elif self.family == "hybrid":
            din, N, nh = self.d_inner, self.ssm_state, self.ssm_heads
            ssm = D * (2 * din + 2 * N + nh) + din * D \
                + self.ssm_conv * (din + 2 * N) + 2 * nh
            per_layer = attn + ssm + mlp_dense
            total += L * per_layer
            active += L * per_layer
        elif self.family == "encdec":
            # enc self-attn + mlp; dec self + cross + mlp
            enc = self.enc_layers * (attn + mlp_dense)
            dec = L * (2 * attn + mlp_dense)
            total += enc + dec
            active += enc + dec
        else:  # dense / vlm
            per_layer = attn + mlp_dense
            total += L * per_layer
            active += L * per_layer
        # norms are negligible; count anyway for dense-family
        return {"total": int(total), "active": int(active)}
