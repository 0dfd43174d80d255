"""Device resolution for the port's entry points.

Entry points default to the CUDA card.  Without a card they raise
instead of carrying on on the CPU; a caller that wants the CPU (the
tests) says ``device="cpu"``.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "tree_to", "to_device", "scalar"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``"cuda"``.  A CUDA device without a card raises.

    On the card, TF32 is switched off for cuDNN convolutions and for
    matmuls: the stem/head convs, the MSA projections and aggregation
    convs are plain torch ops, and cuDNN's TF32 default keeps only ~3
    decimal digits, which breaks fp32 parity with the reference.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port's plain-PyTorch path on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def to_device(x, device: torch.device) -> torch.Tensor:
    """An fp32 host array or tensor on ``device`` without waiting on it.

    A plain host-to-card copy from pageable memory synchronizes the
    stream, so the host would wait for every batch already in flight.
    Staging through pinned memory makes the copy asynchronous."""
    x = torch.as_tensor(x, dtype=torch.float32)
    if device.type == "cuda" and x.device.type == "cpu":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def tree_to(tree, device: torch.device):
    """Move every tensor leaf of a dict/list param tree to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


_SCALARS: dict = {}     # (value, device) -> 0-dim constant


def scalar(value: float, device: torch.device) -> torch.Tensor:
    """A 0-dim fp32 constant on ``device``, made once per (value, device)
    and never written to.  Dividing by it is a true division on every
    device: PyTorch turns division by a Python scalar into multiplication
    by its reciprocal on CUDA tensors.  ``torch.full`` fills it on the
    device, so making it does not wait for work queued on the card, as a
    copy from host memory would.

    Raises when a constant would first be made while a CUDA graph is
    being captured: the fill would only be recorded, so the cached
    tensor would hold garbage until the graph's first replay.  An
    executor runs its forward eagerly before it captures, which makes
    every constant the forward uses."""
    key = (float(value), torch.device(device))
    t = _SCALARS.get(key)
    if t is None:
        if key[1].type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"scalar({value}) first made inside a CUDA graph capture; "
                f"run the forward eagerly before capturing it")
        t = _SCALARS.setdefault(key, torch.full((), value,
                                                dtype=torch.float32,
                                                device=device))
    return t
