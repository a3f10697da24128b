"""EFTA configuration and report types (paper Algorithm 1).

``EFTAConfig`` keeps the JAX package's ``kv_stride``/``out_stride``/
``thresholds`` rules unchanged: the fold widths and detection thresholds
decide which values a verification compares, so detections only agree
between the two packages if these agree. The pure-PyTorch
``efta_attention`` over contiguous KV is not ported yet; the paged path
(``repro_torch.kernels.efta_paged``) carries the same scheme.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core.checksum import TPU_STRIDE

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


@dataclasses.dataclass(frozen=True)
class EFTAConfig:
    """Fault-tolerance + tiling configuration for EFTA."""

    mode: str = "correct"          # "off" | "detect" | "correct"
    stride: int = TPU_STRIDE       # max checksum fold stride (8 = paper)
    block_kv: int = 512            # KV block size (Bc)
    unified: bool = True           # unified verification (EFTA-o) vs per-block
    kv_stride_override: Optional[int] = None
    out_stride_override: Optional[int] = None
    # exact rowsum correction via a shadow accumulator (beyond the paper)
    shadow_rowsum: bool = True
    # recompute-compare on the running rowmax (beyond the paper)
    shadow_rowmax: bool = True
    eps_gemm1: Optional[float] = None
    eps_exp: Optional[float] = None
    eps_out: Optional[float] = None

    def thresholds(self, dtype) -> tuple[float, float, float]:
        # relative to checksum magnitude; bf16/fp16 keep coarse thresholds
        if dtype == torch.float32:
            d = (1e-3, 1e-3, 1e-3)
        else:
            d = (5e-2, 1.0, 5e-2)
        return (
            self.eps_gemm1 if self.eps_gemm1 is not None else d[0],
            self.eps_exp if self.eps_exp is not None else d[1],
            self.eps_out if self.eps_out is not None else d[2],
        )

    def out_stride(self, head_dim: int) -> int:
        # keep >= 2 fold segments so the output checksum is a real fold
        if self.out_stride_override:
            s = min(self.out_stride_override, head_dim // 2)
        else:
            s = max(min(self.stride, head_dim // 16, 64), 4)
        while s > 1 and head_dim % s:
            s -= 1
        return max(s, 1)

    def kv_stride(self, block_kv: int) -> int:
        if self.kv_stride_override:
            return min(self.kv_stride_override, max(block_kv // 2, 1))
        p = max(block_kv // 32, 1)
        pow2 = 1 << (p.bit_length() - 1)
        return max(min(self.stride, pow2), 4)


class FTReport(NamedTuple):
    """Fault-tolerance telemetry for one attention call. On the paged path
    ``detected``/``corrected`` are per request, (B, 5) int32
    ``[gemm1, exp, rowmax, rowsum, gemm2]``; ``max_delta`` is (3,) f32."""

    detected: torch.Tensor
    corrected: torch.Tensor
    max_delta: torch.Tensor

    @staticmethod
    def zero(batch: Optional[int] = None, device=None) -> "FTReport":
        shape = (5,) if batch is None else (batch, 5)
        return FTReport(torch.zeros(shape, dtype=torch.int32, device=device),
                        torch.zeros(shape, dtype=torch.int32, device=device),
                        torch.zeros((3,), dtype=torch.float32, device=device))

    def merge(self, other: "FTReport") -> "FTReport":
        return FTReport(self.detected + other.detected,
                        self.corrected + other.corrected,
                        torch.maximum(self.max_delta, other.max_delta))
