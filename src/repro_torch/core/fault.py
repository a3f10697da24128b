"""Soft-error (single-event-upset) injection via bit flips.

The paper's error model is a single bit flip per protected region (SEU
assumption, §4.2). Faults are *injected* at named sites inside the attention
pipeline and the framework must detect and correct them. ``Site`` keeps the
JAX package's integer values: they index the 6-site telemetry vectors
``[gemm1, exp, rowmax, rowsum, gemm2, kv]`` (``KV`` reports in slot 5).

  GEMM1    — after the Q·Kᵀ accumulate (Case: ABFT on GEMM I)
  ROWMAX   — in the running row max (Case 1: cancels analytically)
  EXP      — after exp(S - m)        (Case 2: checksum-reuse + recompute)
  ROWSUM   — in the running row sum  (Case 3: SNVR range restriction)
  GEMM2    — after the P·V accumulate (ABFT on GEMM II, unified verification)
  WEIGHTS  — in model weights (memory fault)
  KV       — in resident paged KV-cache blocks (a memory fault between
             steps, caught at read time by the block checksums inside the
             fused paged-attention kernel and repaired by block re-prefill).
"""
from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import numpy as np
import torch


class Site(enum.IntEnum):
    NONE = -1
    GEMM1 = 0
    ROWMAX = 1
    EXP = 2
    ROWSUM = 3
    GEMM2 = 4
    WEIGHTS = 5
    KV = 6


class FaultSpec(NamedTuple):
    """A (batch of) injected single-bit faults. Every field is an int32
    numpy array of shape (n_faults,) — or (n_slots, n_faults) once batched
    per slot by :func:`repro_torch.serve.engine.batch_faults`. ``site ==
    Site.NONE`` disables an entry; ``block`` is the KV-block iteration index
    at which the flip occurs. Fault descriptors are host data: the engine
    translates them into the kernel's int32[8] descriptor."""

    site: np.ndarray
    block: np.ndarray
    batch: np.ndarray
    head: np.ndarray
    row: np.ndarray
    col: np.ndarray
    bit: np.ndarray

    @staticmethod
    def none(n: int = 1) -> "FaultSpec":
        z = np.zeros((n,), np.int32)
        return FaultSpec(np.full((n,), -1, np.int32), z, z, z, z, z, z)

    @staticmethod
    def single(site: Site, *, block: int = 0, batch: int = 0, head: int = 0,
               row: int = 0, col: int = 0, bit: int = 20) -> "FaultSpec":
        def a(v):
            return np.asarray([v], dtype=np.int32)
        return FaultSpec(a(int(site)), a(block), a(batch), a(head), a(row),
                         a(col), a(bit))


_INT_VIEW = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def flip_bit_at(x: torch.Tensor, flat_index: int, bit: int) -> torch.Tensor:
    """Flip one bit of the element at ``flat_index`` of ``x`` (any float
    dtype), in place, as an XOR on an integer view of the same storage.
    ``bit`` is clamped to the dtype's width. Returns ``x``."""
    nbits = x.element_size() * 8
    bit = min(max(int(bit), 0), nbits - 1)
    iv = x.view(-1).view(_INT_VIEW[x.element_size()])
    # the top bit of a signed view is its sign: XOR with the two's-
    # complement value that has only that bit set
    mask = -(1 << (nbits - 1)) if bit == nbits - 1 else (1 << bit)
    iv[int(flat_index)] ^= mask
    return x


def _matching(fault: FaultSpec, site: Site, block_index: int):
    """(coordinates, bit) of every entry of ``fault`` that strikes ``site``
    at KV block ``block_index``. A (n_faults,) spec addresses the batch by
    its ``batch`` field; a per-slot (n_slots, n_faults) spec holds
    row-relative coordinates, so row ``b``'s entries strike batch row ``b``
    (the JAX package vmaps its decode per slot, where the batch coordinate
    clamps to the slot's own row)."""
    f = [np.asarray(a) for a in fault]
    hit = (f[0] == int(site)) & (f[1] == block_index)
    for idx in zip(*np.nonzero(hit)):
        batch = int(f[2][idx]) if f[0].ndim == 1 else int(idx[0])
        yield ([batch, int(f[3][idx]), int(f[4][idx]), int(f[5][idx])],
               int(f[6][idx]))


def inject(x: torch.Tensor, fault: Optional[FaultSpec], site: Site,
           block_index: int = 0) -> torch.Tensor:
    """Apply every matching fault in ``fault`` to ``x`` (indexed as (batch,
    head, row[, col]); the vector sites ROWMAX/ROWSUM ignore ``col``).
    Out-of-range coordinates and bits are clamped (still a valid SEU), as
    in the JAX package. Returns a new tensor when anything flips, else
    ``x`` itself."""
    if fault is None:
        return x
    for coords, bit in _matching(fault, site, int(block_index)):
        x = _flip_one(x.clone(), coords, bit)
    return x


def _flip_one(x: torch.Tensor, coords, bit: int) -> torch.Tensor:
    """Flip ``bit`` of the element of ``x`` at the leading ``coords``
    (clamped into range), in place."""
    flat = 0
    for dim, c in zip(x.shape, coords):
        flat = flat * dim + min(max(int(c), 0), dim - 1)
    for dim in x.shape[len(coords):]:
        flat *= dim
    return flip_bit_at(x, flat, bit)


def random_fault(rng: np.random.Generator, *, sites, shape_bhsc,
                 n_blocks: int, max_bit: int = 31) -> FaultSpec:
    """Sample a uniform random single fault (host-side, for campaigns)."""
    b, h, s, c = shape_bhsc
    site = int(rng.choice([int(x) for x in sites]))
    return FaultSpec.single(
        Site(site),
        block=int(rng.integers(0, max(n_blocks, 1))),
        batch=int(rng.integers(0, b)),
        head=int(rng.integers(0, h)),
        row=int(rng.integers(0, s)),
        col=int(rng.integers(0, c)),
        bit=int(rng.integers(0, max_bit + 1)),
    )
