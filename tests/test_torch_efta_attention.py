"""Contiguous EFTA parity: the port against the JAX package on the same
numpy inputs.

* The fused kernel's plain version (``repro_torch.kernels.efta_attention.
  efta_attention_torch``, which is what the wrapper runs for CPU tensors)
  against ``repro.kernels.efta_attention.efta_attention_pallas`` in
  interpret mode, with int32[8] fault descriptors: causal, window, ragged
  ``kv_len`` and GQA masks, the five compute sites in correct and detect
  mode, per-step output verification, mode off, bf16. f32 outputs agree
  within 1e-5; detection vectors exactly.
* The plain-PyTorch ``efta_attention`` against ``repro.core.efta.
  efta_attention``, including ring ``kv_positions`` and ``q_offset``; the
  port's batched rows against the reference called once per row (its ring
  engine's vmap), with per-slot fault batches.
* The ``efta_pallas`` route taking the model's ``FaultSpec``: the JAX
  package raises there (ROADMAP.md, Queue C), the port converts the spec
  into the kernel's descriptor.
"""
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from _torch_util import to_np, to_torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.core.efta import EFTAConfig as JConfig  # noqa: E402
from repro.core.efta import efta_attention as j_efta  # noqa: E402
from repro.core.fault import FaultSpec as JFaultSpec  # noqa: E402
from repro.core.fault import Site as JSite  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.efta_attention import efta_attention_pallas  # noqa: E402
from repro.kernels.ops import attention as j_attention  # noqa: E402
from repro_torch.core.efta import EFTAConfig  # noqa: E402
from repro_torch.core.efta import efta_attention as t_efta  # noqa: E402
from repro_torch.core.fault import FaultSpec, Site  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.efta_attention import (  # noqa: E402
    efta_attention, efta_attention_torch, fault_descriptor)
from repro_torch.kernels.ops import attention as t_attention  # noqa: E402
from repro_torch.serve.engine import batch_faults  # noqa: E402


def _qkv(b, h, hkv, sq, skv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32))


def _both(q, k, v, *, cfg, fault=None, dtype=np.float32, **kw):
    """(reference out, reference counts), (port out, port counts)."""
    jd = jnp.float32 if dtype == np.float32 else jnp.bfloat16
    td = torch.float32 if dtype == np.float32 else torch.bfloat16
    jo, jdet = efta_attention_pallas(
        *(jnp.asarray(x, jd) for x in (q, k, v)), cfg=JConfig(**cfg),
        fault=None if fault is None else jnp.asarray(fault, jnp.int32),
        interpret=True, **kw)
    to, tdet = efta_attention_torch(
        *(to_torch(x, td) for x in (q, k, v)), cfg=EFTAConfig(**cfg),
        fault=fault, **kw)
    return ((np.asarray(jo, np.float32), np.asarray(jdet)),
            (to_np(to.float()), to_np(tdet)))


def _assert_same(ref, got, *, atol=1e-5):
    np.testing.assert_allclose(got[0], ref[0], atol=atol, rtol=0)
    np.testing.assert_array_equal(got[1], ref[1])


def seu_bit(mode: str) -> int:
    """The bit an SEU flips in an f32 compute tile. Correct mode: the top
    exponent bit (30). Detect mode corrects nothing, and a top-bit flip of
    a rowsum or accumulator in [2, 4) leaves a subnormal that keeps only
    the low mantissa bits: the uncorrected row, and whether its output
    check fires, then hang on the last bits of a sum that any two
    implementations order differently. Bit 27 (a factor 2^16 either way)
    keeps the struck value normal, so both implementations must agree."""
    return 30 if mode == "correct" else 27


MASKS = {
    "causal": (dict(b=1, h=2, hkv=2, sq=64, skv=64, d=32), dict(causal=True)),
    "window": (dict(b=1, h=2, hkv=2, sq=64, skv=64, d=32),
               dict(causal=True, window=24)),
    "ragged": (dict(b=1, h=2, hkv=2, sq=32, skv=128, d=32),
               dict(causal=False, kv_len=100)),
    "gqa": (dict(b=2, h=4, hkv=2, sq=64, skv=64, d=32), dict(causal=True)),
}


@pytest.mark.parametrize("name", sorted(MASKS))
def test_plain_kernel_matches_pallas_masks(name):
    shape, kw = MASKS[name]
    q, k, v = _qkv(**shape)
    cfg = dict(mode="correct", stride=8, block_kv=32)
    ref, got = _both(q, k, v, cfg=cfg, block_q=32, **kw)
    _assert_same(ref, got)
    assert got[1].sum() == 0


@pytest.mark.parametrize("mode", ["correct", "detect"])
@pytest.mark.parametrize("site", [Site.GEMM1, Site.ROWMAX, Site.EXP,
                                  Site.ROWSUM, Site.GEMM2])
def test_plain_kernel_matches_pallas_under_seu(site, mode):
    q, k, v = _qkv(2, 4, 2, 64, 96, 32, seed=1)
    cfg = dict(mode=mode, stride=8, block_kv=32)
    # block 1 of head 5 (batch 1, head 1), query row 40
    fault = np.asarray([int(site), 1, 5, 40, 9, seu_bit(mode), 1, 0],
                       np.int32)
    ref, got = _both(q, k, v, cfg=cfg, fault=fault, causal=True, block_q=32)
    _assert_same(ref, got)
    assert got[1].sum() >= 1


@pytest.mark.parametrize("variant", ["per_step", "off", "no_shadows",
                                     "bf16"])
def test_plain_kernel_matches_pallas_variants(variant):
    q, k, v = _qkv(1, 4, 2, 64, 64, 32, seed=2)
    cfg = dict(mode="correct", stride=8, block_kv=16)
    fault = np.asarray([int(Site.GEMM2), 2, 1, 50, 3, 27, 1, 0], np.int32)
    dtype, atol = np.float32, 1e-5
    if variant == "per_step":
        cfg["unified"] = False
    elif variant == "off":
        cfg["mode"] = "off"
    elif variant == "no_shadows":
        cfg.update(shadow_rowsum=False, shadow_rowmax=False)
        fault = np.asarray([int(Site.ROWSUM), 2, 1, 50, 0, 27, 1, 0],
                           np.int32)
    else:
        dtype = "bf16"
        fault = np.asarray([int(Site.EXP), 1, 2, 40, 5, 30, 1, 0], np.int32)
    if dtype == "bf16":
        ref, got = _both(q, k, v, cfg=cfg, fault=fault, dtype="bf16",
                         causal=True, block_q=32)
        # both round the f32 result to bf16 once: one bf16 ulp apart at most
        atol = 2e-2 * float(np.abs(ref[0]).max())
    else:
        ref, got = _both(q, k, v, cfg=cfg, fault=fault, causal=True,
                         block_q=32)
    _assert_same(ref, got, atol=atol)


def test_wrapper_on_cpu_runs_the_plain_version_and_raises_elsewhere():
    q, k, v = (to_torch(x) for x in _qkv(1, 2, 2, 32, 32, 16))
    cfg = EFTAConfig(mode="correct", stride=8, block_kv=16)
    before = efta_attention.launches
    a = efta_attention(q, k, v, cfg=cfg, causal=True)
    b = efta_attention_torch(q, k, v, cfg=cfg, causal=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert efta_attention.launches == before      # no kernel launched
    with pytest.raises(ValueError, match="cpu or cuda"):
        efta_attention(*(x.to("meta") for x in (q, k, v)), cfg=cfg)


@pytest.mark.parametrize("kw,shape", [
    (dict(kv_len=0), (32, 32)),
    (dict(kv_len=33), (32, 32)),
    (dict(block_q=128), (200, 256)),          # 200 % 128
    (dict(), (32, 48)),                        # 48 % min(32, 48)
])
def test_wrapper_raises_what_the_reference_raises(kw, shape):
    sq, skv = shape
    q, k, v = _qkv(1, 2, 2, sq, skv, 16)
    with pytest.raises(ValueError):
        efta_attention_pallas(*(jnp.asarray(x) for x in (q, k, v)),
                              cfg=JConfig(stride=8, block_kv=32), **kw)
    with pytest.raises(ValueError):
        efta_attention(*(to_torch(x) for x in (q, k, v)),
                       cfg=EFTAConfig(stride=8, block_kv=32), **kw)


def test_fold_oracles_match_reference():
    x = np.random.default_rng(3).standard_normal((3, 5, 32)).astype(
        np.float32)
    for name in ("fold1_ref", "fold2_ref", "foldprod_ref"):
        np.testing.assert_allclose(
            to_np(getattr(tref, name)(to_torch(x), 8)),
            np.asarray(getattr(jref, name)(jnp.asarray(x), 8)),
            rtol=1e-6, atol=1e-30)
    q, k, v = _qkv(1, 4, 2, 16, 16, 8)
    np.testing.assert_allclose(
        to_np(tref.attention_ref(*(to_torch(t) for t in (q, k, v)),
                                 causal=True, window=5)),
        np.asarray(jref.attention_ref(*(jnp.asarray(t) for t in (q, k, v)),
                                      causal=True, window=5)),
        atol=1e-6)


# --- the efta_pallas route with the model's FaultSpec ----------------------

def test_efta_pallas_route_takes_a_faultspec():
    q, k, v = _qkv(1, 4, 2, 32, 32, 16, seed=4)
    cfg = dict(mode="correct", stride=8, block_kv=16)
    spec = dict(block=1, batch=0, head=3, row=20, col=5, bit=30)
    # the JAX package hands the NamedTuple to the kernel's scalar prefetch
    with pytest.raises(AttributeError):
        j_attention(*(jnp.asarray(x) for x in (q, k, v)), impl="efta_pallas",
                    cfg=JConfig(**cfg), causal=True,
                    fault=JFaultSpec.single(JSite.EXP, **spec))
    out, rep = t_attention(*(to_torch(x) for x in (q, k, v)),
                           impl="efta_pallas", cfg=EFTAConfig(**cfg),
                           causal=True, fault=FaultSpec.single(Site.EXP,
                                                               **spec))
    desc = np.asarray([int(Site.EXP), 1, 3, 20, 5, 30, 1, 0], np.int32)
    np.testing.assert_array_equal(
        fault_descriptor(FaultSpec.single(Site.EXP, **spec), 4), desc)
    jo, jdet = efta_attention_pallas(
        *(jnp.asarray(x) for x in (q, k, v)), cfg=JConfig(**cfg),
        causal=True, fault=jnp.asarray(desc))
    np.testing.assert_allclose(to_np(out), np.asarray(jo), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(to_np(rep.detected).sum(0),
                                  np.asarray(jdet))
    assert int(rep.detected.sum()) >= 1
    np.testing.assert_array_equal(to_np(rep.corrected), to_np(rep.detected))


def test_fault_descriptor_takes_one_fault():
    two = FaultSpec(*(np.concatenate([a, b]) for a, b in zip(
        FaultSpec.single(Site.EXP), FaultSpec.single(Site.GEMM1))))
    with pytest.raises(ValueError, match="one fault"):
        fault_descriptor(two, 4)
    np.testing.assert_array_equal(fault_descriptor(FaultSpec.none(3), 4),
                                  np.zeros(8, np.int32))


# --- plain-PyTorch efta_attention against the JAX package's ----------------

def _ring_positions(skv, new_pos):
    """kv_positions of a ring of ``skv`` slots after ``new_pos`` tokens."""
    idx = np.arange(skv)
    last = new_pos - 1 - ((new_pos - 1 - idx) % skv)
    return np.where(last >= 0, last, -1).astype(np.int32)


@pytest.mark.parametrize("mode", ["correct", "detect"])
@pytest.mark.parametrize("site", [None, Site.GEMM1, Site.ROWMAX, Site.EXP,
                                  Site.ROWSUM, Site.GEMM2])
def test_efta_ring_rows_match_reference(site, mode):
    b, h, hkv, sq, skv, d = 3, 4, 2, 2, 40, 16
    q, k, v = _qkv(b, h, hkv, sq, skv, d, seed=5)
    new_pos = np.array([23, 40, 57])           # the last wraps the ring
    cfg = dict(mode=mode, stride=8, block_kv=16)
    one = None if site is None else dict(block=1, head=3, row=1, col=2,
                                         bit=seu_bit(mode))
    outs, dets = [], []
    for i in range(b):
        f = None
        if one is not None and i == 1:          # only slot 1 is struck
            f = JFaultSpec.single(JSite(int(site)), batch=0, **one)
        o, rep = j_efta(*(jnp.asarray(x[i:i + 1]) for x in (q, k, v)),
                        cfg=JConfig(**cfg), causal=True, window=30,
                        q_offset=int(new_pos[i] - sq),
                        kv_positions=jnp.asarray(
                            _ring_positions(skv, new_pos[i])), fault=f)
        outs.append(np.asarray(o))
        dets.append(np.asarray(rep.detected))
    faults = None
    if one is not None:
        faults = batch_faults(b, {1: FaultSpec.single(site, batch=0, **one)})
    kvp = np.stack([_ring_positions(skv, n) for n in new_pos])
    o, rep = t_efta(*(to_torch(x) for x in (q, k, v)), cfg=EFTAConfig(**cfg),
                    causal=True, window=30, q_offset=to_torch(new_pos - sq),
                    kv_positions=to_torch(kvp), fault=faults)
    np.testing.assert_allclose(to_np(o), np.concatenate(outs), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(to_np(rep.detected), np.stack(dets))
    if site is not None:
        assert rep.detected[1].sum() >= 1
        assert rep.detected[[0, 2]].sum() == 0


def test_efta_padded_kv_len_matches_reference():
    q, k, v = _qkv(2, 2, 1, 8, 50, 16, seed=6)
    cfg = dict(mode="correct", stride=8, block_kv=16)
    o, rep = t_efta(*(to_torch(x) for x in (q, k, v)), cfg=EFTAConfig(**cfg),
                    causal=True, kv_len=45, q_offset=37)
    for i in range(2):
        jo, jrep = j_efta(*(jnp.asarray(x[i:i + 1]) for x in (q, k, v)),
                          cfg=JConfig(**cfg), causal=True, kv_len=45,
                          q_offset=37)
        np.testing.assert_allclose(to_np(o[i:i + 1]), np.asarray(jo),
                                   atol=1e-5, rtol=0)
        np.testing.assert_array_equal(to_np(rep.detected[i]),
                                      np.asarray(jrep.detected))
