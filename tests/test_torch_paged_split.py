"""The KV-split merge algebra of the fused paged kernel, on the CPU.

``_paged_split_torch`` runs the plain version's block loop once per warp
span (span ``w`` walks blocks ``w, w + warps, ...`` from a fresh row
state), merges the spans' states (m, l, shadow l, SNVR r, acc, the two O
checksums, max|V|) in span order and applies the finalize once: what a
kernel that split each request's KV walk over warps would compute. It is
held here against the sequential plain version, ``efta_paged_attention_
torch``, on the same inputs (made from a seed with numpy):

* clean, with uneven and empty spans, grp 1 and 4, decode and chunked
  rows: f32 values within 1e-5, detection vectors and bad planes exactly
  equal;
* every compute-site SEU that correct mode repairs where it strikes
  (GEMM I, EXP, rowmax, rowsum), in a block owned by a span other than 0:
  exactly equal;
* an SEU on running state (GEMM II; rowsum, rowmax or EXP left
  uncorrected in detect mode) strikes one span's partial value under the
  split, not the sequential one. A fixed-bit flip then does something
  else (its exponent bit and the value's size differ), and the detection
  vectors differ. That is why ``csrc/efta_paged.cu`` works on several KV
  blocks side by side but replays the running state (max, rowsum, SNVR,
  accumulator, O checksums) in block order instead of merging spans.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import checksum as cks
from repro_torch.core.efta import EFTAConfig
from repro_torch.core.fault import Site
from repro_torch.kernels.efta_paged import (_paged_split_torch,
                                            efta_paged_attention_torch)

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seed, *, B, mb, hkv, grp, C, max_len=None, bs=16, hd=16, cs=8):
    """Random pools, fragmented tables and ragged lengths (numpy)."""
    rng = np.random.default_rng(seed)
    max_len = max_len or mb * bs
    lens = rng.integers(max(C, 1), max_len + 1, size=B).astype(np.int32)
    need = [-(-int(t) // bs) for t in lens]
    nb = sum(need) + 3
    ids = rng.permutation(nb) + 1
    bt = np.zeros((B, mb), np.int32)
    used = 0
    for b, n in enumerate(need):
        bt[b, :n] = ids[used:used + n]
        used += n
    k = rng.standard_normal((nb + 1, hkv, bs, hd)).astype(np.float32)
    v = rng.standard_normal((nb + 1, hkv, bs, hd)).astype(np.float32)
    q = rng.standard_normal((B, hkv * grp, C, hd)).astype(np.float32)
    q_lens = np.minimum(C, lens).astype(np.int32)
    if C > 1:
        q_lens[0] = max(1, C // 2)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    return (torch.from_numpy(q), kt, vt, cks.encode_kv(kt, cs),
            cks.encode_kv(vt, cs), torch.from_numpy(bt),
            torch.from_numpy(lens), torch.from_numpy(q_lens))


def _both(args, warps, *, mode="correct", fault=None):
    cfg = EFTAConfig(mode=mode, stride=8, block_kv=16)
    f = None if fault is None else np.asarray(fault, np.int32)
    seq = efta_paged_attention_torch(*args, cfg=cfg, fault=f)
    split = _paged_split_torch(*args, cfg=cfg, warps=warps, fault=f)
    return seq, split


def _equal(seq, split):
    np.testing.assert_allclose(split.out.numpy(), seq.out.numpy(), **TOL)
    np.testing.assert_array_equal(split.detected.numpy(),
                                  seq.detected.numpy())
    np.testing.assert_array_equal(split.bad_blocks.numpy(),
                                  seq.bad_blocks.numpy())


@pytest.mark.parametrize("warps", [2, 4])
@pytest.mark.parametrize("grp", [1, 4])
@pytest.mark.parametrize("shape", ["decode", "chunk", "short"])
def test_split_matches_sequential_clean(warps, grp, shape):
    """Uneven spans (5 blocks over 2 or 4 warps), empty spans (requests
    shorter than warps x bs), decode and chunked rows: equal."""
    kw = {"decode": dict(C=1, mb=5), "chunk": dict(C=6, mb=5),
          "short": dict(C=1, mb=5, max_len=20)}[shape]
    args = _case(11 + grp, B=3, hkv=2, grp=grp, **kw)
    seq, split = _both(args, warps)
    _equal(seq, split)
    assert seq.detected.sum() == 0 and not seq.bad_blocks.any()


@pytest.mark.parametrize("grp", [1, 4])
def test_split_matches_under_a_resident_flip(grp):
    """A pool SEU is flagged at its (request, table slot) alike."""
    q, k, v, kc, vc, bt, lens, ql = _case(5, B=3, mb=5, hkv=2, grp=grp, C=1,
                                          max_len=80)
    j = min(3, (int(lens[1]) - 1) // 16)
    k = k.clone()
    k[int(bt[1, j]), 1, 2, 3] *= 2.0 ** 20
    seq, split = _both((q, k, v, kc, vc, bt, lens, ql), 4)
    _equal(seq, split)
    assert bool(seq.bad_blocks[1, j]) and int(seq.detected[1, 5]) >= 1


@pytest.mark.parametrize("site", [Site.GEMM1, Site.EXP, Site.ROWMAX,
                                  Site.ROWSUM])
@pytest.mark.parametrize("block,warps", [(1, 2), (3, 4), (2, 4)])
@pytest.mark.parametrize("grp", [1, 4])
def test_split_matches_under_repaired_seus(site, block, warps, grp):
    """Correct mode repairs these sites where they strike, before any merge:
    equal detection vectors, bad planes and values, with the SEU in a block
    of span block % warps."""
    args = _case(7, B=3, mb=5, hkv=2, grp=grp, C=1, max_len=80)
    for bit in (27, 30):
        fault = [int(site), block, 1, 1, 0, 3, bit, 1]
        seq, split = _both(args, warps, fault=fault)
        _equal(seq, split)
        if site != Site.ROWMAX:      # a rowmax flip may cancel (Case 1)
            assert seq.detected[1].sum() >= 1, (site.name, bit)


@pytest.mark.parametrize("mode,site,block,bit", [
    ("correct", Site.GEMM2, 3, 20), ("detect", Site.EXP, 3, 30),
    ("detect", Site.ROWMAX, 2, 27), ("detect", Site.ROWSUM, 3, 30)])
def test_split_changes_what_a_state_seu_strikes(mode, site, block, bit):
    """A flip of running state lands on one span's partial value under the
    split: the detection vectors differ from the sequential order's. In
    the first two cases the sequential order detects the flip and the split
    does not: the flipped partial is too small to pass a threshold."""
    args = _case(7, B=3, mb=5, hkv=2, grp=1, C=1, max_len=80)
    fault = [int(site), block, 1, 1, 0, 3, bit, 1]
    seq, split = _both(args, 4, mode=mode, fault=fault)
    assert not torch.equal(seq.detected, split.detected)
    if site in (Site.GEMM2, Site.EXP):
        assert seq.detected[1].sum() >= 1 and split.detected[1].sum() == 0
