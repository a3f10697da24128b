"""bert-large (paper Table 3): 24L 16H head_dim=64 encoder-only."""
from repro_torch.configs.base import AttnCfg, ModelConfig

CONFIG = ModelConfig(
    name="bert-large", family="encoder",
    num_layers=24, d_model=1024, d_ff=4096, vocab_size=30522,
    attn=AttnCfg(num_heads=16, num_kv_heads=16, head_dim=64, pos="learned",
                 causal=False),
    norm="layernorm", glu=False, act="gelu", max_seq=512,
    source="paper Table 3",
)
