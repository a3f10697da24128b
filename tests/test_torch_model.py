"""Model-level parity: logits of ``Model.score`` over a paged cache, the
port against the JAX package, with the weights carried across by
``from_reference_params``.

``gpt2-smoke`` (learned positions, MHA) runs through both packages' paged
step over three mixed steps (prefill chunks of different ``q_len``, an idle
slot, then decodes), clean and with a compute-site SEU; logits must agree
within 1e-4 (f32) and the per-slot ``FTReport.detected`` exactly.

``gemma3-1b-smoke`` (RoPE with per-layer theta, GQA, sliding window, global
every 2nd layer) cannot run the reference's paged step: its ``rope`` does
not broadcast per-request (B, S) positions over heads (recorded in
ROADMAP.md, Queue C). It is held instead against the reference's
full-sequence forward, which computes the same function: each row of the
port's chunked paged steps must match the reference logits at its position
within 1e-4.
"""
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from _torch_util import to_np, to_torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core.fault import Site  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.attention import PagedKVCache as JPaged  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import (PagedKVCache, build_model,  # noqa: E402
                                from_reference_params)

B, MB, BS, CS = 3, 4, 16, 8
# (chunk width, per-slot q_len): mixed prefill, an idle slot, decodes
STEPS = [(16, [16, 9, 13]), (16, [1, 16, 0]), (1, [1, 1, 1])]


def _models(arch):
    jm = jbuild(jget(arch))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(arch)
    tm = build_model(cfg, device="cpu")
    tp = from_reference_params(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    return jm, jp, tm, tp, cfg


def _pools(cfg, lib):
    a = cfg.attn
    nb = B * MB
    kv = (cfg.num_layers, nb + 1, a.num_kv_heads, BS, a.head_dim)
    ck = (cfg.num_layers, nb + 1, a.num_kv_heads, CS, a.head_dim)
    return [lib.zeros(s) for s in (kv, kv, ck, ck, ck, ck)]


def _tables():
    # fragmented: each slot's blocks in reverse pool order
    return np.arange(1, B * MB + 1, dtype=np.int32).reshape(B, MB)[:, ::-1] \
        .copy()


@pytest.fixture(scope="module")
def gpt2():
    return _models("gpt2-smoke")


@pytest.mark.parametrize("fault_site", [None, Site.GEMM1, Site.EXP])
def test_gpt2_paged_score_matches_reference(gpt2, fault_site):
    jm, jp, tm, tp, cfg = gpt2
    L = cfg.num_layers
    bt = _tables()
    jstate = _pools(cfg, jnp)
    tstate = _pools(cfg, torch)
    pos = np.zeros(B, np.int32)
    rng = np.random.default_rng(0)
    for step, (C, q_lens) in enumerate(STEPS):
        q_lens = np.asarray(q_lens, np.int32)
        toks = rng.integers(0, cfg.vocab_size, (B, C)).astype(np.int32)
        desc = None
        if fault_site is not None and step == 1:
            # slot 1's prefill chunk: [site, j, b, h, row, col, bit, on]
            desc = np.asarray([int(fault_site), 0, 1, 1, 2, 3, 27, 1],
                              np.int32)

        def bcast(x):
            return jnp.broadcast_to(jnp.asarray(x)[None], (L,) + x.shape)

        jc = {"attn": JPaged(*jstate, bt=bcast(bt), pos=bcast(pos),
                             q_len=bcast(q_lens),
                             bad=jnp.zeros((L, B, MB), jnp.int32))}
        jl, jr, jn = jm.score(jp, jnp.asarray(toks), jc,
                              fault=None if desc is None
                              else jnp.asarray(desc))
        tc = PagedKVCache(*tstate, bt=to_torch(bt), pos=to_torch(pos),
                          q_len=to_torch(q_lens),
                          bad=torch.zeros((B, MB), dtype=torch.int32))
        tl, tr, tn = tm.score(tp, to_torch(toks), tc, fault=desc)
        jl, tl = np.asarray(jl), to_np(tl)
        for b in range(B):
            n = int(q_lens[b])
            np.testing.assert_allclose(tl[b, :n], jl[b, :n], atol=1e-4,
                                       rtol=0, err_msg=f"step {step} b {b}")
        np.testing.assert_array_equal(to_np(tr.detected),
                                      np.asarray(jr.detected))
        np.testing.assert_array_equal(to_np(tr.corrected),
                                      np.asarray(jr.corrected))
        np.testing.assert_array_equal(to_np(tn.pos), pos + q_lens)
        if desc is not None and fault_site != Site.ROWMAX:
            assert to_np(tr.detected)[1].sum() >= 1
        jstate = [jn["attn"].k, jn["attn"].v, jn["attn"].kc1,
                  jn["attn"].kc2, jn["attn"].vc1, jn["attn"].vc2]
        # the pools (past the null block) hold the same K/V and checksums
        for ja, ta in zip(jstate, tstate):
            np.testing.assert_allclose(to_np(ta)[:, 1:],
                                       np.asarray(ja)[:, 1:], atol=1e-5)
        pos = pos + q_lens


def test_gemma3_paged_chunks_match_reference_full_forward():
    jm, jp, tm, tp, cfg = _models("gemma3-1b-smoke")
    a = cfg.attn
    assert a.pos == "rope" and a.num_kv_heads < a.num_heads
    assert a.sliding_window and a.global_every
    rng = np.random.default_rng(1)
    # three requests long enough to exceed the 16-token window
    lens = [40, 27, 33]
    seqs = [rng.integers(0, cfg.vocab_size, (t,)).astype(np.int32)
            for t in lens]
    ref = [np.asarray(jm.logits(jp, {"tokens": jnp.asarray(s)[None]})[0])[0]
           for s in seqs]
    tstate = _pools(cfg, torch)
    bt = _tables()
    pos = np.zeros(B, np.int32)
    C = 16
    while (pos < np.asarray(lens)).any():
        q_lens = np.minimum(C, np.asarray(lens) - pos).astype(np.int32)
        # a mixed batch: slot 2 sits idle on the first step
        if pos.sum() == 0:
            q_lens[2] = 0
        toks = np.zeros((B, C), np.int32)
        for b in range(B):
            toks[b, :q_lens[b]] = seqs[b][pos[b]:pos[b] + q_lens[b]]
        tc = PagedKVCache(*tstate, bt=to_torch(bt), pos=to_torch(pos),
                          q_len=to_torch(q_lens),
                          bad=torch.zeros((B, MB), dtype=torch.int32))
        tl, tr, _ = tm.score(tp, to_torch(toks), tc)
        tl = to_np(tl)
        for b in range(B):
            n = int(q_lens[b])
            np.testing.assert_allclose(
                tl[b, :n], ref[b][pos[b]:pos[b] + n], atol=1e-4, rtol=0,
                err_msg=f"slot {b} rows {pos[b]}..{pos[b] + n}")
        assert to_np(tr.detected).sum() == 0
        pos = pos + q_lens


def test_extend_returns_each_rows_last_logits(gpt2):
    """``Model.extend`` is ``score`` gathered at each slot's ``lengths - 1``
    (default: the last column)."""
    _, _, tm, tp, cfg = gpt2
    rng = np.random.default_rng(3)
    toks = to_torch(rng.integers(0, cfg.vocab_size, (B, 16)).astype(np.int32))
    q_lens = to_torch(np.asarray([16, 5, 9], np.int32))

    def cache():
        return PagedKVCache(*_pools(cfg, torch), bt=to_torch(_tables()),
                            pos=torch.zeros(B, dtype=torch.int32),
                            q_len=q_lens,
                            bad=torch.zeros((B, MB), dtype=torch.int32))

    full, _, _ = tm.score(tp, toks, cache())
    last, _, new = tm.extend(tp, toks, cache(), lengths=q_lens)
    np.testing.assert_array_equal(
        to_np(last), to_np(full)[np.arange(B), to_np(q_lens) - 1])
    np.testing.assert_array_equal(to_np(new.pos), to_np(q_lens))
    last_col, _, _ = tm.extend(tp, toks, cache())
    np.testing.assert_array_equal(to_np(last_col), to_np(full)[:, -1])
