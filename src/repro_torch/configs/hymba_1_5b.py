"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + mamba heads; sliding-window
attention except 3 full-attention layers (first/middle/last).
[arXiv:2411.13676; hf]"""
from repro_torch.configs.base import AttnCfg, FTCfg, ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, d_ff=5504, vocab_size=32001,
    attn=AttnCfg(num_heads=25, num_kv_heads=5, head_dim=64,
                 sliding_window=1024),
    ssm=SSMCfg(kind="mamba", state_dim=16, expand=2),
    source="arXiv:2411.13676",
)
