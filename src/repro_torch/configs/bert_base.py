"""bert-base (paper Table 3): 12L 12H head_dim=64 encoder-only."""
from repro_torch.configs.base import AttnCfg, ModelConfig

CONFIG = ModelConfig(
    name="bert-base", family="encoder",
    num_layers=12, d_model=768, d_ff=3072, vocab_size=30522,
    attn=AttnCfg(num_heads=12, num_kv_heads=12, head_dim=64, pos="learned",
                 causal=False),
    norm="layernorm", glu=False, act="gelu", max_seq=512,
    source="paper Table 3",
)
