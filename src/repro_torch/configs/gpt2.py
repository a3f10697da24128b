"""gpt2 (paper Table 3): 12L 12H head_dim=64, d_model=768, learned positions,
LayerNorm + GELU."""
from repro_torch.configs.base import AttnCfg, ModelConfig

CONFIG = ModelConfig(
    name="gpt2", family="dense",
    num_layers=12, d_model=768, d_ff=3072, vocab_size=50257,
    attn=AttnCfg(num_heads=12, num_kv_heads=12, head_dim=64, pos="learned"),
    norm="layernorm", glu=False, act="gelu", max_seq=1024,
    source="paper Table 3",
)
