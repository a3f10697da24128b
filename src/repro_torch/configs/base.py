"""Config system: dataclasses describing every supported architecture.

One ``ModelConfig`` fully determines a model; ``reduced()`` derives the
CPU-smoke-test variant of the same family (tiny widths, few layers, same
structural features), per the assignment: full configs are exercised only via
the dry-run (ShapeDtypeStruct, no allocation).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    # Sliding-window attention: window size, and "every Nth layer is global"
    # (gemma3 5:1 local:global -> global_every=6; hymba: 3 full-attn layers).
    sliding_window: Optional[int] = None
    global_every: Optional[int] = None
    causal: bool = True
    pos: str = "rope"            # "rope" | "learned" | "none"
    softmax_scale: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared_experts: int = 0   # kimi-style always-on shared expert(s)
    shared_d_ff: int = 0
    dense_d_ff: int = 0           # arctic-style parallel dense residual MLP
    first_k_dense: int = 0        # first k layers use a dense FFN
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # Decode-serving EP layout (hillclimb): experts sharded over all devices,
    # decode tokens replicated — removes per-step expert-weight gathers.
    inference_ep: bool = False


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    kind: str                     # "mamba" | "rwkv6"
    state_dim: int = 16
    conv_dim: int = 4
    expand: int = 2
    head_dim: int = 64            # rwkv6 head size
    dt_rank: int = 0              # 0 -> ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class FTCfg:
    """How the paper's technique is wired into this model."""

    mode: str = "correct"         # "off" | "detect" | "correct"
    stride: int = 128             # max checksum stride (8 = paper fidelity)
    block_kv: int = 512
    attn_impl: str = "efta"       # "efta" | "efta_pallas" | "flash" | "reference"
    ff_abft: bool = False         # tensor-checksum ABFT on FF/projection GEMMs
    unified: bool = True
    shadow_rowsum: bool = True
    shadow_rowmax: bool = True
    scan_unroll: bool = False     # unroll EFTA's KV scan (dry-run cost probes)
    kv_stride_override: Optional[int] = None    # pin fold widths (ablations)
    out_stride_override: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense|moe|hybrid|ssm|vlm|audio|encoder|encdec
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attn: Optional[AttnCfg] = None
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    # encoder-decoder (whisper/t5): decoder depth = num_layers
    encoder_layers: int = 0
    # modality frontend stub: number of precomputed embedding tokens fed to
    # cross-attention (vlm) or the encoder (audio)
    frontend_tokens: int = 0
    cross_attn_every: int = 0     # vlm: every Nth decoder layer cross-attends
    norm: str = "rmsnorm"         # "rmsnorm" | "layernorm"
    act: str = "silu"
    glu: bool = True
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    ft: FTCfg = dataclasses.field(default_factory=FTCfg)
    # "full" per-layer remat is the production default with fused attention:
    # a "dots" policy would pin the O(S*Bc) score tiles that EFTA/flash
    # deliberately keeps out of HBM (measured: whisper train 15.6 GB -> small)
    remat: str = "full"           # "none" | "dots" | "full"
    scan_layers: bool = True      # False = unroll layer stack (dry-run probes)
    # Megatron-style sequence parallelism (hillclimb): activations between
    # blocks are sharded over 'model' along the sequence axis — layer-scan
    # residuals shrink by the TP degree.
    seq_parallel: bool = False
    max_seq: int = 4096
    source: str = ""              # provenance note ([hf:...] / [arXiv:...])

    @property
    def head_dim(self) -> int:
        return self.attn.head_dim if self.attn else 0

    def param_count_estimate(self) -> int:
        """Analytic parameter count (embeddings + blocks), for roofline N."""
        d = self.d_model
        n = 0
        n += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        layers = self.num_layers + self.encoder_layers
        for i in range(self.num_layers):
            n += self._block_params(i)
        for i in range(self.encoder_layers):
            n += self._enc_block_params()
        n += d  # final norm
        return n

    def _attn_params(self) -> int:
        a = self.attn
        d = self.d_model
        return (d * a.num_heads * a.head_dim            # wq
                + 2 * d * a.num_kv_heads * a.head_dim   # wk, wv
                + a.num_heads * a.head_dim * d)         # wo

    def _mlp_params(self, ff) -> int:
        mult = 3 if self.glu else 2
        return mult * self.d_model * ff

    def _ssm_params(self) -> int:
        s = self.ssm
        d = self.d_model
        if s is None:
            return 0
        if s.kind == "mamba":
            di = s.expand * d
            dtr = s.dt_rank or -(-d // 16)
            return (d * 2 * di + di * s.conv_dim + di * (dtr + 2 * s.state_dim)
                    + dtr * di + di * s.state_dim + 2 * di + di * d)
        # rwkv6 time-mix + channel-mix
        return 4 * d * d + d * d + 2 * d + (2 * d * d + d * int(3.5 * d))

    def _block_params(self, i: int) -> int:
        d = self.d_model
        n = 2 * d  # norms
        if self.family == "ssm":
            return n + self._ssm_params()
        n += self._attn_params()
        if self.family == "hybrid":
            n += self._ssm_params()
        if self.cross_attn_every and (i % self.cross_attn_every
                                      == self.cross_attn_every - 1):
            n += self._attn_params() + d
        if self.moe is not None and i >= self.moe.first_k_dense:
            m = self.moe
            n += d * m.num_experts                      # router
            n += m.num_experts * self._mlp_params(m.expert_d_ff) // 1
            if m.num_shared_experts:
                n += m.num_shared_experts * self._mlp_params(m.shared_d_ff)
            if m.dense_d_ff:
                n += self._mlp_params(m.dense_d_ff)
        else:
            n += self._mlp_params(self.d_ff)
        return n

    def _enc_block_params(self) -> int:
        return 2 * self.d_model + self._attn_params() + self._mlp_params(self.d_ff)

    def active_param_count_estimate(self) -> int:
        """Active (per-token) params — MoE counts top_k + shared experts."""
        if self.moe is None:
            return self.param_count_estimate()
        m = self.moe
        full = self.param_count_estimate()
        per_expert = self._mlp_params(m.expert_d_ff)
        moe_layers = self.num_layers - m.first_k_dense
        inactive = moe_layers * (m.num_experts - m.top_k) * per_expert
        return full - inactive


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 64,
            vocab: int = 128) -> ModelConfig:
    """Shrink a config to a CPU-runnable smoke variant of the same family."""
    def _shrink_attn(a: Optional[AttnCfg]) -> Optional[AttnCfg]:
        if a is None:
            return None
        kv = max(1, min(a.num_kv_heads, 2))
        heads = max(kv, min(a.num_heads, 4))
        heads = (heads // kv) * kv
        return dataclasses.replace(
            a, num_heads=heads, num_kv_heads=kv, head_dim=16,
            sliding_window=min(a.sliding_window, 16) if a.sliding_window else None,
            global_every=min(a.global_every, 2) if a.global_every else None)

    moe = cfg.moe
    if moe is not None:
        # capacity_factor 4.0: smoke tests check prefill/decode == full
        # forward, which requires dropless routing (capacity drops are
        # co-batch dependent and break token-level determinism).
        moe = dataclasses.replace(
            moe, num_experts=4, top_k=min(moe.top_k, 2), expert_d_ff=32,
            shared_d_ff=32 if moe.num_shared_experts else 0,
            dense_d_ff=32 if moe.dense_d_ff else 0,
            first_k_dense=min(moe.first_k_dense, 1), capacity_factor=4.0)
    ssm = cfg.ssm
    if ssm is not None:
        ssm = dataclasses.replace(ssm, state_dim=8, head_dim=16, expand=2)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=layers if not cfg.cross_attn_every else 2 * max(
            1, min(cfg.cross_attn_every, 2)),
        cross_attn_every=min(cfg.cross_attn_every, 2) if cfg.cross_attn_every else 0,
        encoder_layers=min(cfg.encoder_layers, 2) if cfg.encoder_layers else 0,
        d_model=d_model, d_ff=4 * d_model, vocab_size=vocab,
        attn=_shrink_attn(cfg.attn), moe=moe, ssm=ssm,
        frontend_tokens=min(cfg.frontend_tokens, 8) if cfg.frontend_tokens else 0,
        dtype="float32",
        ft=dataclasses.replace(cfg.ft, stride=8, block_kv=16),
        max_seq=64,
    )
