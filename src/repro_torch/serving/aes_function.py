"""The paper's benchmark function, AES-128-CTR of a request's payload, as a
deployed function body.

Deploying it (the constructor) expands its key once and places the (11, 16)
round keys on the device.  A call moves the payload to the device, runs
``ops.aes_ctr_expanded`` there, brings the reply back and synchronises;
nothing but the round keys is kept from one call to the next.  It runs on
the card unless the caller passes ``device="cpu"``, where the op takes its
plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref
from repro_torch.serving.engine import resolve_device


class AesFunction:
    def __init__(self, key_bytes: torch.Tensor, *, device="cuda", nonce: int = 0):
        self.device = resolve_device(device)
        self.nonce = nonce
        self.round_keys = ref.aes_key_expand(key_bytes.cpu()).to(self.device)

    def __call__(self, payload: torch.Tensor) -> torch.Tensor:
        """payload (N, 16) int32 bytes on the host -> ciphertext on the host."""
        out = ops.aes_ctr_expanded(payload.to(self.device), self.round_keys,
                                   nonce=self.nonce).cpu()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out
