"""State-space sequence mixers: Mamba (selective SSM, the parallel heads of
the ``hybrid`` family) and RWKV6 "Finch" (data-dependent decay, the ``ssm``
family), with the JAX package's parameter layout and f32 recurrent states.

Both are attention-free: EFTA has no score GEMM to protect here. The
recurrences run as a sequential loop over time, as the JAX package's
``lax.scan`` does.

States are NamedTuples as in the JAX package. A model's cache stacks them
over layers (a leading layer axis on every field); :func:`state_layer`
takes one layer's and :func:`stack_states` stacks per-layer states back.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMCfg
from repro_torch.models.layers import (const_init, dense_init, matmul,
                                       normal_init)


def _f32_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with an f32 result: products of the operands' values summed in
    f32, no rounding to their dtype (``preferred_element_type=f32``)."""
    return torch.matmul(x.float(), w.float())


def state_layer(state, i: int):
    return type(state)(*(t[i] for t in state))


def stack_states(states: Sequence):
    return type(states[0])(*(torch.stack(ts) for ts in zip(*states)))


# ---------------------------------------------------------------------------
# Mamba (selective SSM)
# ---------------------------------------------------------------------------

class MambaState(NamedTuple):
    h: torch.Tensor       # (B, d_inner, N) f32
    conv: torch.Tensor    # (B, K-1, d_inner): the causal conv's last inputs


def mamba_init(gen: torch.Generator, d: int, s: SSMCfg, dtype, device,
               out=None):
    """``A_log`` and ``D`` stay f32 whatever ``dtype``, as in the JAX
    package; into the tensors of ``out`` where given."""
    out = out or {}
    di = s.expand * d
    dtr = s.dt_rank or -(-d // 16)
    a_log = out.get("A_log")
    if a_log is None:
        a_log = torch.empty((di, s.state_dim), dtype=torch.float32,
                            device=device)
    a_log.copy_(torch.log(torch.arange(
        1, s.state_dim + 1, dtype=torch.float32, device=a_log.device)))
    return {
        "in_proj": dense_init(gen, d, 2 * di, dtype, device,
                              out=out.get("in_proj")),
        "conv_w": normal_init(gen, (s.conv_dim, di), dtype, device,
                              1.0 / math.sqrt(s.conv_dim), out.get("conv_w")),
        "conv_b": const_init((di,), dtype, device, 0.0, out.get("conv_b")),
        "x_proj": dense_init(gen, di, dtr + 2 * s.state_dim, dtype, device,
                             out=out.get("x_proj")),
        "dt_proj": dense_init(gen, dtr, di, dtype, device,
                              out=out.get("dt_proj")),
        "dt_bias": const_init((di,), dtype, device, 0.0, out.get("dt_bias")),
        "A_log": a_log,
        "D": const_init((di,), torch.float32, device, 1.0, out.get("D")),
        "out_proj": dense_init(gen, di, d, dtype, device,
                               out=out.get("out_proj")),
    }


def mamba_state_init(batch: int, d: int, s: SSMCfg, dtype, device,
                     num_layers: int = 0) -> MambaState:
    """Zeroed state; ``num_layers`` > 0 stacks it over layers."""
    di = s.expand * d
    lead = (num_layers,) if num_layers else ()
    return MambaState(
        h=torch.zeros(lead + (batch, di, s.state_dim), dtype=torch.float32,
                      device=device),
        conv=torch.zeros(lead + (batch, s.conv_dim - 1, di), dtype=dtype,
                         device=device))


def _mamba_conv(xh, conv_w, conv_b, prefix):
    """Causal depthwise conv via K shifted adds, in f32. xh: (B, S, di)."""
    k = conv_w.shape[0]
    full = torch.cat([prefix.to(xh.dtype), xh], dim=1)
    s = xh.shape[1]
    out = torch.zeros(xh.shape, dtype=torch.float32, device=xh.device)
    for i in range(k):
        out = out + full[:, i:i + s, :].float() * conv_w[i].float()
    return (out + conv_b.float()).to(xh.dtype)


def mamba_apply(params, x: torch.Tensor, s: SSMCfg, *,
                state: MambaState | None = None):
    """x: (B, S, d) -> (y (B, S, d), new state). Selective scan over time."""
    b, seq, d = x.shape
    dtr = params["dt_proj"].shape[0]
    if state is None:
        state = mamba_state_init(b, d, s, x.dtype, x.device)
    xz = matmul(x, params["in_proj"])
    xh_pre, z = xz.chunk(2, dim=-1)
    xh = F.silu(_mamba_conv(xh_pre, params["conv_w"], params["conv_b"],
                            state.conv))
    # the conv state keeps the pre-conv inputs (in_proj outputs)
    new_conv = torch.cat([state.conv.to(x.dtype), xh_pre],
                         dim=1)[:, -(s.conv_dim - 1):, :]

    dbc = _f32_matmul(xh, params["x_proj"])
    dt_r, b_c, c_c = torch.split(dbc, [dtr, s.state_dim, s.state_dim], dim=-1)
    dt = F.softplus(_f32_matmul(dt_r.to(x.dtype), params["dt_proj"])
                    + params["dt_bias"].float())                  # (B,S,di)
    a = -torch.exp(params["A_log"].float())                       # (di, N)
    xf = xh.float()
    h = state.h
    ys = []
    for t in range(seq):
        dt_t = dt[:, t]
        da = torch.exp(dt_t[..., None] * a)                       # (B,di,N)
        h = da * h + dt_t[..., None] * b_c[:, t, None, :] * xf[:, t, :, None]
        ys.append(torch.einsum("bdn,bn->bd", h, c_c[:, t]))
    y = torch.stack(ys, dim=1) + params["D"].float() * xf
    y = y.to(x.dtype) * F.silu(z)
    return matmul(y, params["out_proj"]), MambaState(h=h, conv=new_conv)


# ---------------------------------------------------------------------------
# RWKV6 (Finch): token shift + data-dependent decay
# ---------------------------------------------------------------------------

class RWKVState(NamedTuple):
    wkv: torch.Tensor       # (B, H, hd, hd) f32
    x_prev: torch.Tensor    # (B, d): token shift of the time mix
    x_prev_c: torch.Tensor  # (B, d): token shift of the channel mix


def rwkv6_init(gen: torch.Generator, d: int, s: SSMCfg, dtype, device,
               out=None):
    """Time-mix and channel-mix parameters; ``w_base``, ``u`` and ``ln_x``
    stay f32 whatever ``dtype``, as in the JAX package; into the tensors of
    ``out`` where given."""
    out = out or {}
    h = d // s.head_dim
    lora = 64
    ffd = int(3.5 * d)
    f32 = torch.float32

    def uniform(name, n):
        t = out.get(name)
        if t is None:
            t = torch.empty((n, d), dtype=dtype, device=device)
        if not t.is_meta:
            t.copy_(torch.rand((n, d), generator=gen, dtype=f32,
                               device=t.device))
        return t

    def dense(name, a, b):
        return dense_init(gen, a, b, dtype, device, out=out.get(name))

    return {
        "mu": uniform("mu", 5),
        "w_base": const_init((d,), f32, device, -2.0, out.get("w_base")),
        "w_lora_a": dense("w_lora_a", d, lora),
        "w_lora_b": const_init((lora, d), dtype, device, 0.0,
                               out.get("w_lora_b")),
        "wr": dense("wr", d, d),
        "wk": dense("wk", d, d),
        "wv": dense("wv", d, d),
        "wg": dense("wg", d, d),
        "u": normal_init(gen, (h, s.head_dim), f32, device, 0.1, out.get("u")),
        "wo": dense("wo", d, d),
        "ln_x": const_init((d,), f32, device, 1.0, out.get("ln_x")),
        # channel mix
        "mu_c": uniform("mu_c", 2),
        "wk_c": dense("wk_c", d, ffd),
        "wv_c": dense("wv_c", ffd, d),
        "wr_c": dense("wr_c", d, d),
    }


def rwkv_state_init(batch: int, d: int, s: SSMCfg, dtype, device,
                    num_layers: int = 0) -> RWKVState:
    """Zeroed state; ``num_layers`` > 0 stacks it over layers."""
    h = d // s.head_dim
    lead = (num_layers,) if num_layers else ()
    return RWKVState(
        wkv=torch.zeros(lead + (batch, h, s.head_dim, s.head_dim),
                        dtype=torch.float32, device=device),
        x_prev=torch.zeros(lead + (batch, d), dtype=dtype, device=device),
        x_prev_c=torch.zeros(lead + (batch, d), dtype=dtype, device=device))


def _shifted(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """(B, S, d) -> the previous-token tensor, seeded by the carry (B, d)."""
    return torch.cat([x_prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _mixes(x, xs, mu):
    """``x + mu[i] * (xs - x)`` in f32, rounded to x's dtype, for each row
    of ``mu``."""
    xf, xsf = x.float(), xs.float()
    mu = mu.float()
    return [(xf + mu[i] * (xsf - xf)).to(x.dtype) for i in range(mu.shape[0])]


def rwkv6_time_mix(params, x: torch.Tensor, s: SSMCfg, *, state: RWKVState):
    b, seq, d = x.shape
    nh, hd = d // s.head_dim, s.head_dim
    m = _mixes(x, _shifted(x, state.x_prev), params["mu"])
    r = matmul(m[0], params["wr"]).reshape(b, seq, nh, hd)
    k = matmul(m[1], params["wk"]).reshape(b, seq, nh, hd)
    v = matmul(m[2], params["wv"]).reshape(b, seq, nh, hd)
    g = matmul(m[3], params["wg"])
    # data-dependent decay (the Finch contribution)
    w_dd = params["w_base"].float() + matmul(
        torch.tanh(matmul(m[4], params["w_lora_a"])),
        params["w_lora_b"]).float()
    w = torch.exp(-torch.exp(w_dd)).reshape(b, seq, nh, hd)     # in (0, 1)
    u = params["u"].float()
    rf, kf, vf = r.float(), k.float(), v.float()
    wkv = state.wkv
    ys = []
    for t in range(seq):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]         # (B,nh,hd,hd)
        ys.append(torch.einsum("bhj,bhji->bhi", rf[:, t],
                               wkv + u[None, :, :, None] * kv))
        wkv = w[:, t, :, :, None] * wkv + kv
    y = torch.stack(ys, dim=1)                                    # (B,S,nh,hd)
    # group norm over each head
    mean = y.mean(dim=-1, keepdim=True)
    var = (y - mean).square().mean(dim=-1, keepdim=True)
    y = (y - mean) * torch.rsqrt(var + 1e-5)
    y = (y.reshape(b, seq, d) * params["ln_x"].float()).to(x.dtype)
    y = y * F.silu(g)
    out = matmul(y, params["wo"])
    return out, state._replace(wkv=wkv, x_prev=x[:, -1, :])


def rwkv6_channel_mix(params, x: torch.Tensor, *, state: RWKVState):
    xk, xr = _mixes(x, _shifted(x, state.x_prev_c), params["mu_c"])
    kk = torch.square(F.relu(matmul(xk, params["wk_c"])))
    out = torch.sigmoid(matmul(xr, params["wr_c"])) * matmul(kk,
                                                              params["wv_c"])
    return out, state._replace(x_prev_c=x[:, -1, :])
