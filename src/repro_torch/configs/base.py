"""Architecture configuration dataclass shared by all 10 assigned archs.

The port's own copy of ``repro/configs/base.py``, field for field (the
configs import nothing, but the port imports nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    n_experts_per_token: int = 0
    moe_d_ff: int = 0                # per-expert FFN width
    n_shared_experts: int = 0        # qwen2-moe: shared experts alongside routed
    dense_residual: bool = False     # arctic: dense FFN residual + MoE
    dense_d_ff: int = 0
    capacity_factor: float = 1.25

    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    d_conv: int = 4

    # --- hybrid (recurrentgemma) ---
    block_pattern: Tuple[str, ...] = ()   # repeating unit, e.g. ("rglru","rglru","attn")
    lru_width: int = 0
    local_window: int = 0

    # --- encoder-decoder (seamless) ---
    encoder_layers: int = 0

    # --- modality frontend (stub: precomputed embeddings) ---
    modality: str = "text"           # text | audio | vision
    frontend_len: int = 0            # encoder frames / vision patches for stubs

    # --- positional / norm / act ---
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl M-RoPE
    norm_eps: float = 1e-5
    act: str = "silu"
    tie_embeddings: bool = False

    # --- dtypes & memory policy (per-arch) ---
    dtype: str = "bfloat16"          # activations / compute
    param_dtype: str = "float32"     # master params
    opt_dtype: str = "float32"       # Adam moments
    remat: str = "full"              # none | full | dots
    grad_accum: int = 4              # microbatch steps per train step

    # --- sharding policy ---
    fsdp_params: bool = False        # ZeRO-3: shard params over data axis too
    shard_cache_seq: bool = False    # SP on KV-cache length when kv_heads < model axis

    # --- attention class (decides long_500k applicability) ---
    attention: str = "full"          # full | local | none(ssm)

    # --- serving-path LSH semantic cache (the paper's technique) ---
    lsh_cache: bool = True
    lsh_embed_dim: int = 64          # N in the paper's experiments

    # --- TP padding (heads / experts / vocab rounded up to the model axis;
    #     padded slots are zero-masked so the function is exactly preserved.
    #     jit in_shardings require divisibility; padding waste is reported in
    #     the roofline's useful_flops_ratio) ---
    n_heads_pad: Optional[int] = None
    n_experts_pad: Optional[int] = None
    vocab_pad: Optional[int] = None

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    @property
    def h_eff(self) -> int:
        return self.n_heads_pad or self.n_heads

    @property
    def e_eff(self) -> int:
        return self.n_experts_pad or self.n_experts

    @property
    def v_eff(self) -> int:
        return self.vocab_pad or self.vocab_size

    @property
    def sub_quadratic(self) -> bool:
        """True iff long_500k decode is runnable (ssm / hybrid-local-attn)."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:        # mamba2
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:      # mamba2
        return self.d_inner // self.ssm_headdim

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), for roofline
        MODEL_FLOPS = 6 N D and sanity checks."""
        d, v = self.d_model, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        hd = self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        per_layer = 0
        if self.family == "ssm":
            din, heads, ns = self.d_inner, self.ssm_heads, self.ssm_state
            in_proj = d * (2 * din + 2 * ns + heads)
            per_layer = in_proj + self.d_conv * (din + 2 * ns) + heads * 2 + din * d + din
            return emb + self.n_layers * per_layer
        ffn = 3 * d * self.d_ff if self.d_ff else 0
        if self.family == "moe":
            moe = self.n_experts * 3 * d * self.moe_d_ff
            shared = self.n_shared_experts * 3 * d * self.moe_d_ff
            router = d * self.n_experts
            dense = 3 * d * self.dense_d_ff if self.dense_residual else 0
            per_layer = attn + moe + shared + router + dense + (d * self.n_shared_experts and d)
            return emb + self.n_layers * per_layer
        if self.family == "hybrid":
            lw = self.lru_width or d
            rglru = d * lw * 2 + lw * d + 2 * lw * 2 + lw * 3 + self.d_conv * lw
            n_attn = sum(1 for b in self._layer_types() if b == "attn")
            n_rg = self.n_layers - n_attn
            return emb + n_attn * (attn + ffn) + n_rg * (rglru + ffn)
        if self.family == "encdec":
            enc = self.encoder_layers * (attn + ffn)
            dec = self.n_layers * (attn * 2 + ffn)   # self + cross attention
            return emb + enc + dec
        return emb + self.n_layers * (attn + ffn)

    def _layer_types(self):
        if not self.block_pattern:
            return ["attn"] * self.n_layers
        out = []
        while len(out) < self.n_layers:
            out.extend(self.block_pattern)
        return out[: self.n_layers]

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k only), for MoE MODEL_FLOPS."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        routed_all = self.n_experts * 3 * d * self.moe_d_ff
        routed_active = self.n_experts_per_token * 3 * d * self.moe_d_ff
        return self.param_count() - self.n_layers * (routed_all - routed_active)


# ---------------------------------------------------------------------------
# Input shapes assigned to the LM family (seq_len x global_batch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
