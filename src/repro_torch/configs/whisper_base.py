"""whisper-base [audio]: 6L enc + 6L dec, d_model=512 8H d_ff=2048
vocab=51865 — enc-dec; conv frontend is a stub providing precomputed frame
embeddings (1500 frames). [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import AttnCfg, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    num_layers=6, encoder_layers=6, d_model=512, d_ff=2048, vocab_size=51865,
    attn=AttnCfg(num_heads=8, num_kv_heads=8, head_dim=64, pos="learned"),
    frontend_tokens=1500, norm="layernorm", glu=False, act="gelu",
    source="arXiv:2212.04356",
)
