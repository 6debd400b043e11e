"""xLSTM mixers of the port, mLSTM and sLSTM (the JAX package's
``models/xlstm.py``; arXiv:2405.04517).

mLSTM keeps per head a (dh x dh) matrix memory ``C_t = f_t C_{t-1} + i_t v_t
k_t^T`` with exponential gates and a max-stabilizer ``m``, read out with q.
Prefill runs the chunkwise-parallel form (within a chunk the quadratic form
over log-gate cumsums, between chunks the carried state); decode is the
O(dh^2) recurrent step, and ``mlstm_seq_ref`` chains it over a sequence as
the tests' oracle. sLSTM keeps a scalar memory per channel with recurrent
block-diagonal gate weights per head, so every phase is a loop over tokens.

The numerics are the reference's: masked log-weights go through
``exp(clamp(., -80, 0))`` and then a 0/1 mask, never through an exp of a
sentinel; the stabilizer's max masks with -1e9; a fresh state's ``m`` is
-30; the read-out divides by ``max(|den|, exp(-m))``. The reference has no
Pallas kernel for either mixer, so both are plain PyTorch.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.models.layers import causal_conv
from repro_torch.params import ParamSpec

M0 = -30.0  # the stabilizer of a fresh state


def _mdims(cfg: ModelConfig):
    d_in = int(cfg.xlstm.proj_factor * cfg.d_model)
    H = cfg.num_heads
    return d_in, H, d_in // H


def _rms_rows(h: torch.Tensor) -> torch.Tensor:
    return h * torch.rsqrt((h * h).mean(-1, keepdim=True) + 1e-6)


# ===================================================================== mLSTM


def mlstm_defs(cfg: ModelConfig):
    d, dt = cfg.d_model, cfg.param_dtype
    d_in, H, _ = _mdims(cfg)
    f32 = torch.float32
    return {"up": ParamSpec((d, 2 * d_in), dt, ("embed", "mlp")),
            "conv_w": ParamSpec((cfg.xlstm.conv_kernel, d_in), dt, (None, "mlp")),
            "conv_b": ParamSpec((d_in,), f32, (None,), "zeros"),
            "wq": ParamSpec((d_in, d_in), dt, ("mlp", None)),
            "wk": ParamSpec((d_in, d_in), dt, ("mlp", None)),
            "wv": ParamSpec((d_in, d_in), dt, ("mlp", None)),
            "w_if": ParamSpec((d_in, 2 * H), f32, ("mlp", None)),
            "b_if": ParamSpec((2 * H,), f32, (None,), "zeros"),
            "norm": ParamSpec((d_in,), f32, (None,), "ones"),
            "down": ParamSpec((d_in, d), dt, ("mlp", "embed"))}


class MLSTMState(NamedTuple):
    C: torch.Tensor     # (B, H, dh, dh) float32
    n: torch.Tensor     # (B, H, dh) float32
    m: torch.Tensor     # (B, H) float32 stabilizer
    conv: torch.Tensor  # (B, K - 1, d_in) the last inputs of the conv


def init_mlstm_state(cfg: ModelConfig, batch: int, device) -> MLSTMState:
    d_in, H, dh = _mdims(cfg)
    f32 = torch.float32
    return MLSTMState(
        C=torch.zeros((batch, H, dh, dh), dtype=f32, device=device),
        n=torch.zeros((batch, H, dh), dtype=f32, device=device),
        m=torch.full((batch, H), M0, dtype=f32, device=device),
        conv=torch.zeros((batch, cfg.xlstm.conv_kernel - 1, d_in), dtype=cfg.param_dtype,
                         device=device))


def _mlstm_qkv_gates(cfg: ModelConfig, p, x: torch.Tensor, conv_state: torch.Tensor):
    """The shared pre-processing of x (B, T, D) after the conv tail
    ``conv_state``: q, k (scaled by dh^-0.5), v (B, T, H, dh); the input
    and log forget gate pre-activations (B, T, H) float32; the output gate
    z; the conv's new tail."""
    B, T, _ = x.shape
    d_in, H, dh = _mdims(cfg)
    K = cfg.xlstm.conv_kernel
    up = x @ p["up"]
    xm, z = up[..., :d_in], up[..., d_in:]
    xin = torch.cat([conv_state.to(xm.dtype), xm], dim=1)
    xc = F.silu(causal_conv(xin, p["conv_w"], p["conv_b"]))
    q = (xc @ p["wq"]).reshape(B, T, H, dh)
    k = ((xc @ p["wk"]) * dh ** -0.5).reshape(B, T, H, dh)
    v = (xm @ p["wv"]).reshape(B, T, H, dh)
    gif = xc.float() @ p["w_if"] + p["b_if"]
    return q, k, v, gif[..., :H], F.logsigmoid(gif[..., H:]), z, xin[:, -(K - 1):]


def _mlstm_chunk(q, k, v, ig, logf, vmask, C, n, m):
    """One chunk of the chunkwise form: q, k, v (B, L, H, dh), ig and logf
    (B, L, H), vmask (L,) the tokens that are not padding, and the carried
    (C, n, m). Returns (h (B, L, H, dh) float32, C, n, m at the chunk's
    end)."""
    L = q.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    b = torch.cumsum(logf, dim=1)                                 # within-chunk log decay
    li = b[:, :, None, :] - b[:, None, :, :] + ig[:, None, :, :]  # (B, i, j, H)
    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    allowed = (causal & vmask[None, :])[None, :, :, None]
    m_intra = torch.where(allowed, li, -1e9).amax(dim=2)          # (B, L, H)
    m_inter = b + m[:, None, :]
    m_t = torch.maximum(m_intra, m_inter)
    # allowed entries have li <= m_t, so the clamp at 0 is exact
    w = torch.exp(torch.clamp(li - m_t[:, :, None, :], -80.0, 0.0)) * allowed
    ws = w * torch.einsum("bihd,bjhd->bijh", qf, kf)
    scale_in = torch.exp(torch.clamp(m_inter - m_t, -80.0, 0.0))
    num = (torch.einsum("bijh,bjhd->bihd", ws, vf)
           + torch.einsum("bihe,bhde->bihd", qf, C) * scale_in[..., None])
    den = ws.sum(dim=2) + torch.einsum("bihd,bhd->bih", qf, n) * scale_in
    floor = torch.exp(torch.clamp(-m_t, -80.0, 80.0))
    h = num / torch.maximum(den.abs(), floor)[..., None]
    # the state at the chunk's end
    keep = vmask[None, :, None]
    sS = b[:, -1:, :] - b + ig                                    # (B, L, H)
    m_new = torch.maximum(b[:, -1] + m, torch.where(keep, sS, -1e9).amax(dim=1))
    wS = torch.exp(torch.clamp(sS - m_new[:, None, :], -80.0, 0.0)) * keep
    decay = torch.exp(torch.clamp(b[:, -1, :] + m - m_new, -80.0, 0.0))
    C = decay[..., None, None] * C + torch.einsum("bjhd,bjhe->bhde", wS[..., None] * vf, kf)
    n = decay[..., None] * n + torch.einsum("bjh,bjhd->bhd", wS, kf)
    return h, C, n, m_new


def _mlstm_out(cfg: ModelConfig, p, h: torch.Tensor, z: torch.Tensor, dtype) -> torch.Tensor:
    """Per-head RMS norm of h (B, T, H, dh) float32, the norm's scale, the
    output gate and the down projection."""
    B, T = h.shape[:2]
    hn = (_rms_rows(h).reshape(B, T, -1) * p["norm"]).to(dtype)
    return (hn * F.silu(z)) @ p["down"]


def mlstm_forward(cfg: ModelConfig, p, x: torch.Tensor,
                  state: Optional[MLSTMState] = None):
    """Chunkwise-parallel forward of x (B, T, D), continuing ``state`` where
    given; a T that is not a multiple of the chunk is zero-padded and the
    padding masked out of every weight. Returns (y (B, T, D), the final
    state)."""
    B, T, _ = x.shape
    st = state if state is not None else init_mlstm_state(cfg, B, x.device)
    q, k, v, ig, logf, z, conv_tail = _mlstm_qkv_gates(cfg, p, x, st.conv)
    L = min(cfg.xlstm.chunk, T)
    pad = (-T) % L
    valid = torch.arange(T + pad, device=x.device) < T
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        ig, logf = (F.pad(t, (0, 0, 0, pad)) for t in (ig, logf))
    C, n, m = st.C, st.n, st.m
    hs = []
    for s in range(0, T + pad, L):
        c = slice(s, s + L)
        h, C, n, m = _mlstm_chunk(q[:, c], k[:, c], v[:, c], ig[:, c], logf[:, c],
                                  valid[c], C, n, m)
        hs.append(h)
    h = torch.cat(hs, dim=1)[:, :T]
    return _mlstm_out(cfg, p, h, z, x.dtype), MLSTMState(C, n, m, conv_tail)


def mlstm_decode(cfg: ModelConfig, p, x_t: torch.Tensor, state: MLSTMState):
    """The O(dh^2) recurrent step of x_t (B, 1, D). Returns (y (B, 1, D),
    the new state)."""
    q, k, v, ig, logf, z, conv_tail = _mlstm_qkv_gates(cfg, p, x_t, state.conv)
    qf, kf, vf = (t[:, 0].float() for t in (q, k, v))
    ig, logf = ig[:, 0], logf[:, 0]                               # (B, H)
    m_new = torch.maximum(logf + state.m, ig)
    i_p = torch.exp(ig - m_new)
    f_p = torch.exp(logf + state.m - m_new)
    C = (f_p[..., None, None] * state.C
         + i_p[..., None, None] * torch.einsum("bhd,bhe->bhde", vf, kf))
    n = f_p[..., None] * state.n + i_p[..., None] * kf
    num = torch.einsum("bhde,bhe->bhd", C, qf)
    den = torch.einsum("bhd,bhd->bh", n, qf)
    floor = torch.exp(torch.clamp(-m_new, -80.0, 80.0))
    h = num / torch.maximum(den.abs(), floor)[..., None]          # (B, H, dh)
    return (_mlstm_out(cfg, p, h[:, None], z, x_t.dtype),
            MLSTMState(C, n, m_new, conv_tail))


def mlstm_seq_ref(cfg: ModelConfig, p, x: torch.Tensor):
    """The sequential oracle of the chunkwise form (tests only): the
    decode step chained over the tokens of x from a fresh state."""
    state = init_mlstm_state(cfg, x.shape[0], x.device)
    outs = []
    for t in range(x.shape[1]):
        y, state = mlstm_decode(cfg, p, x[:, t:t + 1], state)
        outs.append(y)
    return torch.cat(outs, dim=1), state


# ===================================================================== sLSTM


def slstm_defs(cfg: ModelConfig):
    d, dt = cfg.d_model, cfg.param_dtype
    H = cfg.num_heads
    dh = d // H
    up = int(cfg.xlstm.proj_factor * d)
    f32 = torch.float32
    return {"w": ParamSpec((d, 4 * d), dt, ("embed", "mlp")),
            "r": ParamSpec((4, H, dh, dh), dt, (None, "heads", None, None)),
            "b": ParamSpec((4 * d,), f32, (None,), "zeros"),
            "norm": ParamSpec((d,), f32, (None,), "ones"),
            "up_1": ParamSpec((d, up), dt, ("embed", "mlp")),
            "up_2": ParamSpec((d, up), dt, ("embed", "mlp")),
            "down": ParamSpec((up, d), dt, ("mlp", "embed"))}


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, d) float32
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor


def init_slstm_state(cfg: ModelConfig, batch: int, device) -> SLSTMState:
    def z():
        return torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)

    return SLSTMState(z(), z(), z(), torch.full((batch, cfg.d_model), M0,
                                                dtype=torch.float32, device=device))


def _slstm_step(cfg: ModelConfig, p, wx_t: torch.Tensor, st: SLSTMState):
    """One step from the input projection wx_t (B, 4d). Returns (the new
    state, h (B, d) float32)."""
    B = wx_t.shape[0]
    d, H = cfg.d_model, cfg.num_heads
    hh = st.h.reshape(B, H, d // H)
    rec = torch.einsum("bhd,ghde->bghe", hh.to(p["r"].dtype), p["r"])  # (B, 4, H, dh)
    pre = wx_t.reshape(B, 4, d).float() + rec.reshape(B, 4, d).float()
    zt, it, ft, ot = pre.unbind(dim=1)
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + st.m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(logf + st.m - m_new)
    c = f_p * st.c + i_p * torch.tanh(zt)
    n = f_p * st.n + i_p
    h = torch.sigmoid(ot) * c / torch.clamp(n, min=1e-6)
    return SLSTMState(c, n, h, m_new), h


def _slstm_out(p, h: torch.Tensor, dtype) -> torch.Tensor:
    """RMS norm of h (B, T, d) float32, its scale, then the gated GELU
    projection up and down (``jax.nn.gelu``: the tanh approximation)."""
    hn = (_rms_rows(h) * p["norm"]).to(dtype)
    y = F.gelu(hn @ p["up_1"], approximate="tanh") * (hn @ p["up_2"])
    return y @ p["down"]


def slstm_forward(cfg: ModelConfig, p, x: torch.Tensor,
                  state: Optional[SLSTMState] = None):
    """Forward of x (B, T, D), one step a token, continuing ``state`` where
    given. Returns (y (B, T, D), the final state)."""
    st = state if state is not None else init_slstm_state(cfg, x.shape[0], x.device)
    wx = x @ p["w"] + p["b"].to(x.dtype)                          # (B, T, 4d)
    hs = []
    for t in range(x.shape[1]):
        st, h = _slstm_step(cfg, p, wx[:, t], st)
        hs.append(h)
    return _slstm_out(p, torch.stack(hs, dim=1), x.dtype), st


def slstm_decode(cfg: ModelConfig, p, x_t: torch.Tensor, state: SLSTMState):
    """One step of x_t (B, 1, D). Returns (y (B, 1, D), the new state)."""
    wx = (x_t @ p["w"] + p["b"].to(x_t.dtype))[:, 0]
    st, h = _slstm_step(cfg, p, wx, state)
    return _slstm_out(p, h[:, None], x_t.dtype), st
