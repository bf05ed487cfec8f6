"""RWKV-6 "Finch" block: an attention-free linear recurrence with a
data-dependent per-channel decay [arXiv:2404.05892].

Per head (size hd) with receptance r, key k, value v, decay w and bonus u:

    o_t = r_t^T (S_{t-1} + diag(u ⊙ k_t) v_t ...)      (bonus on current)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

where w_t = exp(-exp(wlog_t)) comes from a LoRA on the shifted input.
Counterpart of the JAX package's ``models/rwkv.py``, with the same
parameters, casts and order of operations.  Where the JAX model runs its
chunked ``linear_scan_emit``, the port calls
:func:`repro_torch.kernels.ops.rwkv6_scan` (the CUDA kernel for tensors on
the card, the plain loop on the CPU) from the carried state, for any
sequence length including the one-token decode step.  The functions return
the new state, as in JAX; the transformer writes it into its cache in place.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init

LORA_RANK = 32


def _heads(cfg: ArchConfig) -> Tuple[int, int]:
    hd = cfg.rwkv.head_size
    return cfg.d_model // hd, hd


def rwkv_init(generator: torch.Generator, cfg: ArchConfig, dtype,
              lead: Tuple[int, ...] = ()) -> dict:
    """Parameters of the block, stacked on ``lead``.  ``decay_base`` and
    ``bonus_u`` stay fp32 in a bf16 model, as in JAX."""
    d, dev = cfg.d_model, generator.device
    H, hd = _heads(cfg)

    def full(value, dt=dtype):
        return torch.full((*lead, d), value, dtype=dt, device=dev)

    def dense(d_in, d_out):
        return dense_init(generator, d_in, d_out, dtype, lead)

    u = torch.randn((*lead, H, hd), generator=generator, device=dev) * 0.1
    return {
        # token-shift interpolation factors (static part of ddlerp)
        "mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5), "mu_w": full(0.5),
        "mu_g": full(0.5),
        "wr": dense(d, d), "wk": dense(d, d), "wv": dense(d, d), "wg": dense(d, d),
        "wo": dense(d, d),
        # data-dependent decay LoRA: d -> rank -> d
        "wdec_a": dense(d, LORA_RANK), "wdec_b": dense(LORA_RANK, d),
        "decay_base": full(-6.0, torch.float32),
        "bonus_u": u,
        "ln_x": full(1.0),
        # channel-mix (RWKV FFN)
        "cm_mu_k": full(0.5), "cm_mu_r": full(0.5),
        "cm_wk": dense(d, cfg.d_ff), "cm_wv": dense(cfg.d_ff, d), "cm_wr": dense(d, d),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """x: (B,S,d) -> x_{t-1}; prev (B,1,d) is the last token of the previous
    segment (zeros at sequence start)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu


def _wkv_terms(params: dict, x: torch.Tensor, xs: torch.Tensor, cfg: ArchConfig):
    """r, k, v (B,S,H,hd) in x.dtype, g (B,S,d), w (B,S,H,hd) fp32 in (0, 1)."""
    B, S, d = x.shape
    H, hd = _heads(cfg)
    r = _mix(x, xs, params["mu_r"]) @ params["wr"]
    k = _mix(x, xs, params["mu_k"]) @ params["wk"]
    v = _mix(x, xs, params["mu_v"]) @ params["wv"]
    g = F.silu(_mix(x, xs, params["mu_g"]) @ params["wg"])
    wx = _mix(x, xs, params["mu_w"])
    wlog = params["decay_base"] + (torch.tanh(wx @ params["wdec_a"]) @ params["wdec_b"]).float()
    w = torch.exp(-torch.exp(wlog))
    shp = (B, S, H, hd)
    return r.reshape(shp), k.reshape(shp), v.reshape(shp), g, w.reshape(shp)


def rwkv_time_mix(params: dict, x: torch.Tensor, cfg: ArchConfig,
                  state: Optional[dict] = None) -> Tuple[torch.Tensor, dict]:
    """x: (B,S,d); ``state`` {"wkv", "shift_tm"} or None (zeros) ->
    (y (B,S,d), the new state)."""
    B, S, d = x.shape
    H, hd = _heads(cfg)
    xs = _token_shift(x, None if state is None else state["shift_tm"])
    r, k, v, g, w = _wkv_terms(params, x, xs, cfg)
    rf, kf, vf, wf = (t.float().contiguous() for t in (r, k, v, w))
    o, S_last = ops.rwkv6_scan(rf, kf, vf, wf, params["bonus_u"],
                               None if state is None else state["wkv"])
    # group-norm-ish: rms over the head dim, then a learned scale
    o = o / torch.sqrt(o.square().mean(dim=-1, keepdim=True) + 1e-5)
    o = o.reshape(B, S, d)
    y = ((o * params["ln_x"].float()).to(x.dtype) * g) @ params["wo"]
    return y, {"wkv": S_last, "shift_tm": x[:, -1:]}


def rwkv_channel_mix(params: dict, x: torch.Tensor,
                     state: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d); ``state`` the previous segment's last token (B,1,d) or
    None -> (y, x's last token)."""
    xs = _token_shift(x, state)
    k = _mix(x, xs, params["cm_mu_k"]) @ params["cm_wk"]
    r = torch.sigmoid(_mix(x, xs, params["cm_mu_r"]) @ params["cm_wr"])
    v = F.relu(k).square() @ params["cm_wv"]
    return r * v, x[:, -1:]


def rwkv_init_state(cfg: ArchConfig, batch: int, dtype, device=None,
                    lead: Tuple[int, ...] = ()) -> dict:
    H, hd = _heads(cfg)
    d = cfg.d_model
    return {
        "wkv": torch.zeros((*lead, batch, H, hd, hd), dtype=torch.float32, device=device),
        "shift_tm": torch.zeros((*lead, batch, 1, d), dtype=dtype, device=device),
        "shift_cm": torch.zeros((*lead, batch, 1, d), dtype=dtype, device=device),
    }
