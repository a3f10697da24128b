"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attention image layers every 5th layer; vision frontend
is a stub providing precomputed patch embeddings (1600 tokens).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.configs.base import AttnCfg, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    num_layers=40, d_model=4096, d_ff=14336, vocab_size=128256,
    attn=AttnCfg(num_heads=32, num_kv_heads=8, head_dim=128),
    cross_attn_every=5, frontend_tokens=1600,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
