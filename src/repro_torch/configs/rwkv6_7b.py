"""rwkv6-7b [ssm]: 32L d_model=4096 (attention-free) d_ff=14336 vocab=65536 —
Finch: data-dependent decay. EFTA inapplicable (no attention GEMMs); time-mix
projections protected by ABFT-GEMM (DESIGN.md §Arch-applicability).
[arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    num_layers=32, d_model=4096, d_ff=14336, vocab_size=65536,
    attn=None,
    ssm=SSMCfg(kind="rwkv6", head_dim=64),
    source="arXiv:2404.05892",
)
