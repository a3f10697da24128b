"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) vocab=163840,
MoE 384e top-8 + 1 shared expert, expert d_ff=2048 (assignment spec).
head_dim = 7168/64 = 112 (not 128-aligned; padding waste quantified in
roofline). [arXiv:2501.kimi2; unverified]"""
from repro_torch.configs.base import AttnCfg, FTCfg, ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, d_ff=2048, vocab_size=163840,
    attn=AttnCfg(num_heads=64, num_kv_heads=8, head_dim=112),
    moe=MoECfg(num_experts=384, top_k=8, expert_d_ff=2048,
               num_shared_experts=1, shared_d_ff=2048),
    source="arXiv:2501.kimi2",
)
