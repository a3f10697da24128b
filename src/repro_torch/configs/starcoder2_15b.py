"""starcoder2-15b [dense]: 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152 — GQA, RoPE. [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import AttnCfg, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    num_layers=40, d_model=6144, d_ff=24576, vocab_size=49152,
    attn=AttnCfg(num_heads=48, num_kv_heads=4, head_dim=128),
    glu=False, act="gelu",
    source="arXiv:2402.19173",
)
