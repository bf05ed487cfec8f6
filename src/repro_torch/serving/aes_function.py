"""The paper's benchmark function, AES-128-CTR of a request's payload, as a
deployed function body.

Deploying it (the constructor) expands its key once and places the (11, 16)
round keys on the device.  A call moves the payload to the device, runs
``ops.aes_ctr_expanded`` there, brings the reply back and synchronises;
nothing but the round keys is kept from one call to the next.  It runs on
the card unless the caller passes ``device="cpu"``, where the op takes its
plain version.

``measure_body_us`` times the deployed body as the examples and the
experiments take it, and ``device_label`` names what it ran on.
"""
from __future__ import annotations

import subprocess
import time

import numpy as np
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


AES_PAYLOAD_BLOCKS = 38          # 600 B, the paper's payload, in 16-byte blocks


def measure_body_us(device="cuda", calls: int = 200, seed: int = 0) -> float:
    """The median host time of ``calls`` calls of the deployed body on a
    600 B payload (to the device, the kernel or its plain version, back,
    synchronised), in us, after one call that builds and warms it.  Raises
    on a missing card, as ``AesFunction`` does."""
    rng = np.random.default_rng(seed)
    key = torch.tensor(rng.integers(0, 256, 16), dtype=torch.int32)
    payload = torch.tensor(rng.integers(0, 256, (AES_PAYLOAD_BLOCKS, 16)), dtype=torch.int32)
    fn = AesFunction(key, device=device)
    fn(payload)
    ts = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn(payload)
        ts.append(1e6 * (time.perf_counter() - t0))
    return float(np.median(ts))


def device_label(device) -> str:
    """What a body ran on: the card's name and power limit as ``nvidia-smi``
    gives them (the name alone where it cannot be asked), or the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "the CPU (plain version)"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={dev.index or 0}"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(dev)} (power limit not read)"
