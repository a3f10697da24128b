"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128e top-2 + parallel dense residual MLP.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs.base import AttnCfg, FTCfg, ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, d_ff=4864, vocab_size=32000,
    attn=AttnCfg(num_heads=56, num_kv_heads=8, head_dim=128),
    moe=MoECfg(num_experts=128, top_k=2, expert_d_ff=4864, dense_d_ff=4864),
    source="hf:Snowflake/snowflake-arctic-base",
)
