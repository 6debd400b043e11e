"""Mixture-of-experts MLP of the port (the JAX package's ``models/moe.py``):
DeepSeek-style fine-grained MoE, ``num_shared`` always-on experts fused into
one GLU of width ``num_shared * d_ff_expert`` plus ``num_experts`` routed
experts, ``top_k`` active per token, each with a fixed capacity.

Routing is GShard-style and a function of the token GROUP: the (B * T)
tokens are cut into groups of ``GROUP`` (the last zero-padded), each expert
takes at most ``C = min(max(int(cf * g * K / E), 4), g)`` tokens of a group
in token-major FIFO order, and the rest of its choices are dropped. So a
prefill's routing depends on its whole (bucket-padded) prompt and a decode
step's on every slot row, inactive rows included; chunking a prompt would
change it, which is why MoE stacks take one-shot admission. Dispatch and
combine are one-hot einsums, as in the reference; the reference computes
MoE outside any Pallas kernel, so these plain ops are the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.params import ParamSpec

GROUP = 1024  # tokens per dispatch group


def moe_defs(cfg: ModelConfig):
    m = cfg.moe
    d, dt = cfg.d_model, cfg.param_dtype
    E, Fe = m.num_experts, m.d_ff_expert
    p = {"router": ParamSpec((d, E), torch.float32, ("embed", None)),
         "w_gate": ParamSpec((E, d, Fe), dt, ("experts", "embed", "expert_mlp")),
         "w_up": ParamSpec((E, d, Fe), dt, ("experts", "embed", "expert_mlp")),
         "w_down": ParamSpec((E, Fe, d), dt, ("experts", "expert_mlp", "embed"))}
    if m.num_shared > 0:
        fs = m.num_shared * Fe
        p["shared"] = {"w_gate": ParamSpec((d, fs), dt, ("embed", "mlp")),
                       "w_up": ParamSpec((d, fs), dt, ("embed", "mlp")),
                       "w_down": ParamSpec((fs, d), dt, ("mlp", "embed"))}
    return p


def _glu(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def route(cfg: ModelConfig, router: torch.Tensor, xg: torch.Tensor):
    """The router of one set of groups: xg (G, g, D) -> (probs (G, g, E),
    top_w (G, g, K) renormalised, top_e (G, g, K), combine (G, g, E, C),
    each float32). Top-k is ``lax.top_k``'s order: descending, the lower
    expert index first on a tie (a stable sort; ``torch.topk`` promises no
    order among equals). A choice's slot in its expert is its rank among
    that expert's choices in token-major (g * K) order; choices at or past
    the capacity C are dropped (no weight in ``combine``)."""
    m = cfg.moe
    G, g, _ = xg.shape
    E, K = m.num_experts, m.top_k
    C = min(max(int(m.capacity_factor * g * K / E), 4), g)
    probs = torch.softmax(xg.float() @ router, dim=-1)                  # (G, g, E)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :K], top_e[..., :K]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    oh = F.one_hot(top_e, E).float()                                   # (G, g, K, E)
    ohf = oh.reshape(G, g * K, E)
    pos = (torch.cumsum(ohf, dim=1) - 1.0) * ohf
    pos_choice = pos.sum(-1).reshape(G, g, K)
    combine = torch.zeros((G, g, E, C), dtype=torch.float32, device=xg.device)
    for j in range(K):
        keep = pos_choice[:, :, j] < C
        w = torch.where(keep, top_w[:, :, j], 0.0)
        slot = pos_choice[:, :, j].long()
        oh_c = F.one_hot(torch.where(keep, slot, C), C + 1)[..., :C].float()  # past C: none
        combine = combine + (w[..., None] * oh[:, :, j])[..., None] * oh_c[:, :, None, :]
    return probs, top_w, top_e, combine


def apply_moe(cfg: ModelConfig, p, x: torch.Tensor):
    """x (B, T, D) -> (out (B, T, D), the switch load-balance aux loss, a
    float32 scalar that serving discards as the reference does)."""
    m = cfg.moe
    B, T, D = x.shape
    S = B * T
    E, K = m.num_experts, m.top_k
    g = min(GROUP, S)
    pad = (-S) % g
    xf = x.reshape(S, D)
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
    xg = xf.reshape(-1, g, D)
    probs, _, top_e, combine = route(cfg, p["router"], xg)
    oh_sum = F.one_hot(top_e, E).float().sum(2)                        # (G, g, E)
    aux = E * torch.sum(oh_sum.mean(dim=(0, 1)) * probs.mean(dim=(0, 1))) / K
    dispatch = (combine > 0).to(x.dtype)                               # (G, g, E, C)
    ein = torch.einsum("GgEC,Ggd->GECd", dispatch, xg)
    h = F.silu(torch.einsum("GECd,Edf->GECf", ein, p["w_gate"]))
    h = h * torch.einsum("GECd,Edf->GECf", ein, p["w_up"])
    eout = torch.einsum("GECf,Efd->GECd", h, p["w_down"])
    out = torch.einsum("GgEC,GECd->Ggd", combine.to(x.dtype), eout).reshape(-1, D)[:S]
    if m.num_shared > 0:
        sp = p["shared"]
        out = out + _glu(xf[:S], sp["w_gate"], sp["w_up"], sp["w_down"])
    return out.reshape(B, T, D), aux

