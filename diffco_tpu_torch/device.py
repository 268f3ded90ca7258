"""Device resolution for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU.
Without a card, asking for CUDA (explicitly or by default) raises: the
port never falls back to the CPU on its own.
"""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for and absent."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA device requested but no CUDA card is available; '
            "pass device='cpu' to run on the CPU")
    return dev


@contextlib.contextmanager
def fp32_matmul():
    """Float32 matrix products in full float32 inside the block
    (``torch.backends.cuda.matmul.allow_tf32 = False``), the caller's
    setting restored after it. The Gram build, the RBF solve and
    ``score_fn`` run under it: they are the JAX package's
    ``precision='highest'`` matmuls."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
