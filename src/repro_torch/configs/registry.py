"""Exact configs for the 10 assigned architectures + reduced smoke variants.

The port's own copy of ``repro/configs/registry.py``: the same ten configs,
``ARCH_IDS``, ``get_config`` and ``smoke_config``.  Sources per the
assignment sheet ([source; verified-tier] inline).  dtype / sharding
policies are the JAX package's: archs >= 20B params enable FSDP (ZeRO-3);
>= 100B additionally keep params + moments in bf16.
"""

from __future__ import annotations

import dataclasses

from .base import ArchConfig

_REGISTRY: dict[str, ArchConfig] = {}


def _register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


# --- [audio] enc-dec, multimodal [arXiv:2308.11596; hf] ---------------------
SEAMLESS_M4T_MEDIUM = _register(ArchConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, encoder_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256206, head_dim=64,
    modality="audio", frontend_len=1024, act="relu",
    attention="full", vocab_pad=256208,
))

# --- [moe] 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B; hf] -------
QWEN2_MOE_A27B = _register(ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=151936, head_dim=128,
    n_experts=60, n_experts_per_token=4, moe_d_ff=1408, n_shared_experts=4,
    rope_theta=1_000_000.0, n_experts_pad=64,
    attention="full", grad_accum=8,
))

# --- [moe] 128 experts top-2 + dense residual [hf:Snowflake/snowflake-arctic-base; hf]
ARCTIC_480B = _register(ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab_size=32000, head_dim=128,
    n_experts=128, n_experts_per_token=2, moe_d_ff=4864,
    dense_residual=True, dense_d_ff=4864, n_heads_pad=64,
    param_dtype="bfloat16", opt_dtype="bfloat16", fsdp_params=True,
    grad_accum=32,
    attention="full",
))

# --- [hybrid] RG-LRU + local attn 1:2 [arXiv:2402.19427; hf] -----------------
RECURRENTGEMMA_2B = _register(ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab_size=256000, head_dim=256,
    block_pattern=("rglru", "rglru", "attn"), lru_width=2560, local_window=2048,
    act="gelu", attention="local", tie_embeddings=True, n_heads_pad=16,
))

# --- [dense] small llama3 [hf:meta-llama/Llama-3.2-1B; unverified] -----------
LLAMA32_3B = _register(ArchConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=8192,
    vocab_size=128256, head_dim=128, rope_theta=500_000.0,
    tie_embeddings=True, attention="full", n_heads_pad=32,
))

# --- [dense] [hf:mistralai/Mistral-Large-Instruct-2407; unverified] ----------
MISTRAL_LARGE_123B = _register(ArchConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, d_ff=28672,
    vocab_size=32768, head_dim=128, rope_theta=1_000_000.0,
    param_dtype="bfloat16", opt_dtype="bfloat16", fsdp_params=True,
    grad_accum=16,
    attention="full",
))

# --- [dense] RoPE, GQA [hf:THUDM/glm-4-9b; hf] -------------------------------
GLM4_9B = _register(ArchConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab_size=151552, head_dim=128, shard_cache_seq=True,
    attention="full", grad_accum=8,
))

# --- [dense] GQA [arXiv:2403.17297; hf] --------------------------------------
INTERNLM2_20B = _register(ArchConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=92544, head_dim=128, rope_theta=1_000_000.0,
    fsdp_params=True, attention="full", grad_accum=8,
))

# --- [vlm] M-RoPE, dynamic resolution [arXiv:2409.12191; hf] -----------------
QWEN2_VL_2B = _register(ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab_size=151936, head_dim=128, mrope_sections=(16, 24, 24),
    modality="vision", frontend_len=1024, rope_theta=1_000_000.0, n_heads_pad=16,
    shard_cache_seq=True, attention="full",
))

# --- [ssm] SSD (state-space duality) [arXiv:2405.21060; unverified] ----------
MAMBA2_27B = _register(ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50280, head_dim=0,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=256, d_conv=4,
    tie_embeddings=True, attention="none", vocab_pad=50288, grad_accum=8,
))

ARCH_IDS = tuple(sorted(_REGISTRY))


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return _REGISTRY[arch_id]


def smoke_config(arch_id: str) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests: small layers/width,
    few experts, tiny vocab; numerics and code paths identical."""
    cfg = get_config(arch_id)
    shrink = dict(
        n_layers=min(cfg.n_layers, 4) if not cfg.block_pattern
        else max(len(cfg.block_pattern) + 1, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(max(cfg.n_kv_heads, 1), 2) if cfg.n_kv_heads else 0,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=32 if cfg.n_heads else 0,
        frontend_len=32 if cfg.frontend_len else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        lru_width=128 if cfg.lru_width else 0,
        local_window=64 if cfg.local_window else 0,
        n_experts=8 if cfg.n_experts else 0,
        n_experts_per_token=min(cfg.n_experts_per_token, 2),
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        n_shared_experts=min(cfg.n_shared_experts, 2),
        dense_d_ff=64 if cfg.dense_d_ff else 0,
        ssm_state=32 if cfg.ssm_state else 0,
        ssm_headdim=32 if cfg.ssm_state else 64,
        ssm_chunk=16 if cfg.ssm_state else 256,
        n_heads_pad=None, n_experts_pad=None, vocab_pad=None, grad_accum=1,
        param_dtype="float32", opt_dtype="float32",
        dtype="float32", remat="none", fsdp_params=False,
        name=cfg.name + "-smoke",
    )
    if cfg.family == "ssm":
        shrink["n_heads"] = 0
        shrink["head_dim"] = 0
    return dataclasses.replace(cfg, **shrink)
