"""Dispatch between the attention implementations over contiguous K/V.

``attention(...)`` routes between:
  * ``efta_pallas`` — the fused EFTA kernel (``kernels.efta_attention``:
    the CUDA kernel for a CUDA ``q``, its plain version for a CPU ``q``)
  * ``efta``        — plain-PyTorch EFTA (``core.efta.efta_attention``)
  * ``flash``       — the same loop with fault tolerance off
  * ``reference``   — naive O(n²) softmax attention

The names are the JAX package's (``efta_pallas`` was its Pallas kernel).
Every implementation returns ``(out, FTReport)`` with per-row (B, 5)
counts.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.efta import (EFTAConfig, FTReport, efta_attention,
                                   reference_attention)
from repro_torch.core.fault import FaultSpec
from repro_torch.kernels.efta_attention import (efta_attention_rows,
                                                fault_descriptor)

IMPLS = ("efta_pallas", "efta", "flash", "reference")


def attention(q, k, v, *, impl: str = "efta",
              cfg: Optional[EFTAConfig] = None, causal: bool = False,
              window: Optional[int] = None, kv_len=None, q_offset=0,
              sm_scale: Optional[float] = None, fault=None,
              kv_positions=None):
    """Unified attention entry point. Returns (out, FTReport).

    ``fault`` is a :class:`FaultSpec` for every implementation; the fused
    kernel takes it as its int32[8] descriptor (:func:`fault_descriptor`),
    and an int32[8] descriptor is passed to the kernel as it is.
    """
    cfg = cfg or EFTAConfig()
    b = q.shape[0]
    if impl == "reference":
        out = reference_attention(q, k, v, causal=causal, window=window,
                                  kv_len=kv_len, q_offset=q_offset,
                                  sm_scale=sm_scale,
                                  kv_positions=kv_positions)
        return out, FTReport.zero(b, device=q.device)
    if impl == "flash":
        off = EFTAConfig(mode="off", stride=cfg.stride,
                         block_kv=cfg.block_kv)
        return efta_attention(q, k, v, cfg=off, causal=causal, window=window,
                              kv_len=kv_len, q_offset=q_offset,
                              sm_scale=sm_scale, kv_positions=kv_positions)
    if impl == "efta":
        return efta_attention(q, k, v, cfg=cfg, causal=causal, window=window,
                              kv_len=kv_len, q_offset=q_offset,
                              sm_scale=sm_scale, fault=fault,
                              kv_positions=kv_positions)
    if impl == "efta_pallas":
        if kv_positions is not None or _nonzero(q_offset) or (
                kv_len is not None
                and not isinstance(kv_len, (int, np.integer))):
            raise NotImplementedError(
                "ring caches / decode offsets / tensor kv_len route through "
                "impl='efta'; the fused kernel takes a static ragged kv_len")
        if isinstance(fault, FaultSpec):
            fault = fault_descriptor(fault, q.shape[1])
        out, det = efta_attention_rows(
            q, k, v, cfg=cfg, causal=causal, window=window,
            kv_len=None if kv_len is None else int(kv_len),
            sm_scale=sm_scale, fault=fault)
        return out, FTReport(
            det, det if cfg.mode == "correct" else torch.zeros_like(det),
            torch.zeros((3,), dtype=torch.float32, device=q.device))
    raise ValueError(f"unknown attention impl {impl!r}; one of {IMPLS}")


def _nonzero(q_offset) -> bool:
    if isinstance(q_offset, torch.Tensor):
        return bool((q_offset != 0).any())
    return bool(np.any(np.asarray(q_offset) != 0))
