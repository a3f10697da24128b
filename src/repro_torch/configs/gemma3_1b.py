"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144 —
5:1 local(sliding-window 512):global, 128k-class context, head_dim 256.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.configs.base import AttnCfg, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    num_layers=26, d_model=1152, d_ff=6912, vocab_size=262144,
    attn=AttnCfg(num_heads=4, num_kv_heads=1, head_dim=256,
                 sliding_window=512, global_every=6),
    source="hf:google/gemma-3-1b-pt",
)
