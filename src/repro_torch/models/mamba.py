"""Mamba (S6) block: selective state-space model [Jamba, arXiv:2403.19887].

    h_t = exp(dt_t ⊙ A) h_{t-1} + dt_t ⊙ (B_t x_t)
    y_t = C_t · h_t + D ⊙ x_t

with input-dependent dt, B and C.  Counterpart of the JAX package's
``models/mamba.py``, with the same parameters, casts and order of
operations.  Where the JAX model runs its chunked ``linear_scan_emit``, the
port calls :func:`repro_torch.kernels.ops.mamba_scan` (the CUDA kernel for
tensors on the card, the plain loop on the CPU) from the carried state: for
the sequence path, of any length, and for the one-token decode step.  The
functions return the new state, as in JAX; the transformer writes it into
its cache in place.

``F.softplus`` takes its linear branch above 20, where JAX's ``logaddexp``
is exact; the two differ there by less than 2e-9.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init


def _dt_rank(cfg: ArchConfig) -> int:
    return math.ceil(cfg.d_model / 16)


def mamba_init(generator: torch.Generator, cfg: ArchConfig, dtype,
               lead: Tuple[int, ...] = ()) -> dict:
    """Parameters of the block, stacked on ``lead``.  ``A_log`` and ``D``
    stay fp32 in a bf16 model, as in JAX."""
    mc = cfg.mamba
    d, di, ds = cfg.d_model, mc.d_inner(cfg.d_model), mc.d_state
    dtr, dev = _dt_rank(cfg), generator.device
    conv_w = torch.randn((*lead, mc.d_conv, di), generator=generator, device=dev)
    A = torch.arange(1, ds + 1, dtype=torch.float32, device=dev).expand(*lead, di, ds)
    return {
        "in_proj": dense_init(generator, d, 2 * di, dtype, lead),
        "conv_w": (conv_w * 0.1).to(dtype),
        "conv_b": torch.zeros((*lead, di), dtype=dtype, device=dev),
        "x_proj": dense_init(generator, di, dtr + 2 * ds, dtype, lead),
        "dt_proj_w": dense_init(generator, dtr, di, dtype, lead),
        "dt_proj_b": torch.full((*lead, di), -4.6, dtype=dtype, device=dev),  # softplus^-1(0.01)
        "A_log": torch.log(A).contiguous(),                                    # (di, ds) fp32
        "D": torch.ones((*lead, di), dtype=torch.float32, device=dev),
        "out_proj": dense_init(generator, di, d, dtype, lead),
    }


def _ssm_terms(params: dict, xs: torch.Tensor, cfg: ArchConfig
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """xs: (B,S,di) post-conv activations -> the scan's factored terms, fp32:
    dt (B,S,di), dtx (B,S,di), Bm/Cm (B,S,ds).  Bm and Cm are made
    contiguous here (they are slices of one projection), as the kernel takes
    only contiguous operands."""
    ds = cfg.mamba.d_state
    dtr = _dt_rank(cfg)
    proj = (xs @ params["x_proj"]).float()                        # (B,S,dtr+2ds)
    dt_in, Bm, Cm = torch.split(proj, [dtr, ds, ds], dim=-1)
    dt = F.softplus(dt_in @ params["dt_proj_w"].float() + params["dt_proj_b"].float())
    dtx = dt * xs.float()
    return dt, dtx, Bm.contiguous(), Cm.contiguous()


def _conv1d(params: dict, x: torch.Tensor, state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x: (B,S,di); state: (B, d_conv-1, di) history
    or None (zeros).  Returns (out, the last d_conv-1 inputs)."""
    dc = params["conv_w"].shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], dc - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                               # (B, S+dc-1, di)
    out = xp[:, 0:x.shape[1]] * params["conv_w"][0]
    for i in range(1, dc):                                        # JAX's order of the sum
        out = out + xp[:, i:i + x.shape[1]] * params["conv_w"][i]
    return out + params["conv_b"], xp[:, -(dc - 1):]


def mamba_forward(params: dict, x: torch.Tensor, cfg: ArchConfig,
                  state: Optional[dict] = None) -> Tuple[torch.Tensor, dict]:
    """Sequence path.  x: (B,S,d); ``state`` {"h", "conv"} or None (zeros).
    Returns (y (B,S,d), the new state {"h" fp32, "conv" in x.dtype})."""
    xz = x @ params["in_proj"]
    xs, z = xz.chunk(2, dim=-1)
    xs, new_conv = _conv1d(params, xs, None if state is None else state["conv"])
    xs = F.silu(xs)
    dt, dtx, Bm, Cm = _ssm_terms(params, xs, cfg)
    A = -torch.exp(params["A_log"])                               # (di,ds)
    y, h_last = ops.mamba_scan(dt, dtx, Bm, Cm, A, None if state is None else state["h"])
    y = y + xs.float() * params["D"]                              # the D skip, in fp32
    y = (y.to(x.dtype) * F.silu(z)) @ params["out_proj"]
    return y, {"h": h_last, "conv": new_conv.to(x.dtype)}


def mamba_init_state(cfg: ArchConfig, batch: int, dtype, device=None,
                     lead: Tuple[int, ...] = ()) -> dict:
    di = cfg.mamba.d_inner(cfg.d_model)
    return {
        "h": torch.zeros((*lead, batch, di, cfg.mamba.d_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((*lead, batch, cfg.mamba.d_conv - 1, di), dtype=dtype,
                            device=device),
    }
