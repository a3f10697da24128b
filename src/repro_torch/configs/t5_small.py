"""t5-small (paper Table 3): 18 attention layers = 6 enc self + 6 dec self +
6 dec cross; 8H head_dim=64. Uses RoPE in this repo (relative-bias deviation
noted in DESIGN.md)."""
from repro_torch.configs.base import AttnCfg, ModelConfig

CONFIG = ModelConfig(
    name="t5-small", family="encdec",
    num_layers=6, encoder_layers=6, d_model=512, d_ff=2048, vocab_size=32128,
    attn=AttnCfg(num_heads=8, num_kv_heads=8, head_dim=64),
    glu=False, act="relu", max_seq=512,
    source="paper Table 3",
)
