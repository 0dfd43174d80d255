"""``relu_attn_noncausal`` and ``relu_attn_causal``: the hand-written
CUDA kernels (``csrc/relu_attn.cu``, ``csrc/relu_attn_causal.cu``).

Replace ``repro/kernels/relu_attn/kernel.py::relu_attn_noncausal`` and
``::relu_attn_causal``.  A CUDA tensor launches the kernel (or raises);
a CPU tensor takes the plain version in ``ref``.  ``relu_attn_causal``
on meta tensors launches nothing: its output and workspace are
allocated on meta and its work (``relu_attn_causal_cost``) goes to
``registry.note_meta_cost`` (the dry-run's counters).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check, check_input, library, stream_of
from repro_torch.kernels.registry import (
    SCAN_MAX_WIDTH, SCAN_SCORE_PITCH, SCAN_TILE, SMEM_LIMIT, causal_ops,
    note_meta_cost, scan_pitch)
from repro_torch.kernels.relu_attn.ref import (
    EPS, relu_attn_causal_scan, relu_attn_noncausal_ref)

__all__ = ["relu_attn_noncausal", "relu_attn_smem_bytes", "relu_attn_plan",
           "relu_attn_causal_cost",
           "relu_attn_causal", "relu_attn_causal_smem_bytes",
           "relu_attn_causal_plan"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

RA_THREADS = 512          # threads of a CTA (``RA_THREADS`` in the source)


def _slots(d: int) -> int:
    """Partial states left for the tree (``ra_slots``): the threads
    over the state's 4 x 4 tiles give the token sets (at most 32
    partials after a warp's shuffles), a warp folding 32 / tiles sets
    where the tiles divide 32."""
    tiles = (-(-d // 4)) ** 2
    spw = 1 if 32 % tiles else 32 // tiles
    sets = max(1, min(RA_THREADS // tiles, 32 * spw))
    return sets // spw if sets > 1 else 1


def relu_attn_smem_bytes(d: int, block_n: int) -> int:
    """One CTA's shared memory (mirrors ``ra_smem_bytes`` in the CUDA
    source) for a tile of ``block_n`` tokens: the Q, K and V tiles at a
    row pitch of d rounded up to 4 (plus 4 where that is a multiple of
    8), then the partial states (kv and ksum)."""
    dp = -(-d // 4) * 4
    pitch = dp if dp // 4 % 2 else dp + 4
    return 4 * (3 * block_n * pitch + _slots(d) * (dp * dp + dp))


def relu_attn_plan(n: int, d: int, block_n: int = 256) -> dict:
    """``{"tile": t, "smem": bytes}`` for rows of ``n`` tokens: a tile
    of ``min(n, block_n)`` tokens staged at once by a CTA that takes one
    (g, head) row.  A function of the shape only, never of the batch, so
    a row gives the same bits at every batch."""
    tile = min(n, block_n)
    return {"tile": tile, "smem": relu_attn_smem_bytes(d, tile)}


def _out_strides(out, G, N, heads, D, device):
    """-> (out, images per branch, then its branch, image, token and head
    strides) for a (G, N, heads, d) or (branches, images, N, heads, d)
    fp32 destination with a contiguous last axis (allocated when None)."""
    if out is None:
        out = torch.empty((G, N, heads, D), dtype=torch.float32,
                          device=device)
    shape, st = tuple(out.shape), out.stride()
    if out.device != device or out.dtype != torch.float32 \
            or st[-1] != 1 or not (
                shape == (G, N, heads, D)
                or (len(shape) == 5 and shape[0] * shape[1] == G
                    and shape[2:] == (N, heads, D))):
        raise ValueError(f"out must be float32 on {device}, (G, N, heads, "
                         f"d) or (branches, images, N, heads, d) with G = "
                         f"{G}, N = {N}, heads = {heads}, d = {D} and a "
                         f"contiguous last axis; got {shape}, strides {st}")
    if len(shape) == 4:
        return (out, G, 0) + st[:3]
    return (out, shape[1]) + st[:4]


def _relu_attn(q, k, v, tile, eps, out):
    """Launch ``relu_attn_noncausal_f32`` with a tile of ``tile``
    tokens (the plan's, or forced by the tests) -> out."""
    G, N, heads, D = q.shape
    out, ob, so, si, sn_o, sh_o = _out_strides(out, G, N, heads, D,
                                               q.device)
    lib = library("relu_attn")
    fn = lib.relu_attn_noncausal_f32
    fn.argtypes = [_P] * 4 + [_I] * 4 + [_L] * 3 + [_I] + [_L] * 4 \
        + [_I, ctypes.c_float, _P]
    fn.restype = _I
    sg, sn, sh, _ = q.stride()
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), G,
                N, heads, D, sg, sn, sh, ob, so, si, sn_o, sh_o, tile, eps,
                stream_of(q))
    check(lib, status, "relu_attn_noncausal")
    return out


def relu_attn_noncausal(q, k, v, *, block_n: int = 256, eps: float = EPS,
                        out=None):
    """q, k, v: (G, N, heads, d) -> (G, N, heads, d) fp32, one launch.

    The inputs may be strided views (e.g. the q/k/v split of a stacked
    QKV tensor); their last axis must be contiguous and all three must
    share strides.  ``out``, when given, receives the result and is
    returned: a (G, N, heads, d) tensor, or a (branches, images, N,
    heads, d) view with branches * images = G (row g = branch * images +
    image), e.g. of the (images, H, W, branches * heads * d) map an MSA
    projection reads; its last axis must be contiguous.  ``block_n``
    caps the tokens staged at once (``relu_attn_plan``)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"relu_attn_noncausal runs on cuda or cpu, not "
                         f"{q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be (G, N, heads, d), got {tuple(q.shape)}")
    if q.device.type == "cpu":
        if out is not None:   # the kernel's rule for out, on the CPU too
            _out_strides(out, *q.shape, q.device)
        return relu_attn_noncausal_ref(q, k, v, eps, out=out)
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.stride() != q.stride() \
                or t.device != q.device:
            raise ValueError(f"{name} must match q in shape, strides and "
                             f"device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
    if q.stride(-1) != 1:
        raise ValueError("the head_dim axis of q/k/v must be contiguous")
    G, N, heads, D = q.shape
    plan = relu_attn_plan(N, D, block_n)
    if plan["smem"] > SMEM_LIMIT:
        raise ValueError(f"relu_attn_noncausal: d={D}, block_n={block_n} "
                         f"does not fit in {SMEM_LIMIT} B of shared memory")
    out = _relu_attn(q, k, v, plan["tile"], eps, out)
    relu_attn_noncausal.launches += 1
    return out


relu_attn_noncausal.launches = 0


def relu_attn_causal_smem_bytes(d: int) -> dict:
    """One CTA's shared memory in each launch of the scan (mirrors
    ``causal_states_smem`` / ``causal_out_smem`` in the CUDA source),
    with G = ceil(d / 64) column groups: ``states``, a ReLU(K) tile of
    the state's 64 rows and a V tile; ``out``, the ReLU(Q) and ReLU(K)
    tiles at ``scan_pitch(d)``, a V (or state) tile, the score tile and
    the normalizer."""
    t, g = SCAN_TILE, -(-d // 64)
    return {"states": 4 * (t * t + t * 64 * g),
            "out": 4 * (2 * t * scan_pitch(d) + t * 64 * g
                        + t * SCAN_SCORE_PITCH + -(-d // 4) * 4)}


def relu_attn_causal_plan(bh: int, n: int, d: int, chunk: int = 256
                          ) -> dict:
    """How ``relu_attn_causal`` runs (BH, N, D) rows in chunks of
    ``min(chunk, N)``: ``chunks`` per row, CUDA ``launches`` per call
    (states, prefix, outputs; the outputs alone for one chunk), the
    ``workspace`` bytes (a d x d state and a d normalizer per chunk) and
    ``smem`` (``relu_attn_causal_smem_bytes``)."""
    C = min(chunk, n)
    nc = -(-n // C)
    return {"chunk": C, "chunks": nc, "launches": 3 if nc > 1 else 1,
            "workspace": 4 * bh * nc * (d * d + d) if nc > 1 else 0,
            "smem": relu_attn_causal_smem_bytes(d)}


def relu_attn_causal_cost(bh: int, n: int, d: int, chunk: int = 256,
                          itemsize: int = 4) -> dict:
    """The work of one ``relu_attn_causal`` call on (BH, N, D) inputs of
    ``itemsize`` bytes: ``flops`` = ``triangle`` (ReLU(Q)ReLU(K)^T and
    its product with V, over each chunk's causal pairs) + ``read``
    (ReLU(Q) times the state) + ``update`` (ReLU(K)^T V into the state),
    from ``registry.causal_ops``; ``bytes``, q, k, v read once and the
    fp32 output written once."""
    tri, read, update = (bh * t for t in causal_ops(n, min(chunk, n),
                                                     2 * d, d * d))
    return {"flops": tri + read + update, "triangle": tri, "read": read,
            "update": update,
            "bytes": 3 * bh * n * d * itemsize + 4 * bh * n * d}


def relu_attn_causal(q, k, v, *, chunk: int = 256, eps: float = EPS):
    """q, k, v: (BH, N, D), all fp32 or all bf16 -> (BH, N, D) fp32,
    causal, in chunks of ``min(chunk, N)`` tokens (ragged N as if
    zero-padded), D <= 256.  One call, three CUDA launches
    (``csrc/relu_attn_causal.cu``): each chunk's state, the exclusive
    prefix over chunks, then the outputs of every (chunk, query tile),
    with the workspace (``relu_attn_causal_plan``) from PyTorch's
    allocator.  On the CPU: the same stages in plain PyTorch
    (``relu_attn_causal_scan``)."""
    if q.device.type == "cpu":
        return relu_attn_causal_scan(q, k, v, chunk=chunk, eps=eps)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"relu_attn_causal runs on cuda, cpu or meta, "
                         f"not {q.device}")
    if q.dim() != 3:
        raise ValueError(f"q must be (BH, N, D), got {tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q has dtype {q.dtype}, expected float32 or "
                        f"bfloat16")
    BH, N, D = q.shape
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        check_input(t, name, (BH, N, D), q.device, q.dtype)
    if not 0 < D <= SCAN_MAX_WIDTH or BH > 65535:
        raise ValueError(f"relu_attn_causal takes D in 1..{SCAN_MAX_WIDTH} "
                         f"and BH <= 65535, got D = {D}, BH = {BH}")
    plan = relu_attn_causal_plan(BH, N, D, chunk)
    out = torch.empty((BH, N, D), dtype=torch.float32, device=q.device)
    ws = torch.empty(plan["workspace"] // 4, dtype=torch.float32,
                     device=q.device)
    if q.device.type == "meta":
        cost = relu_attn_causal_cost(BH, N, D, chunk, q.element_size())
        note_meta_cost("relu_attn_causal", cost["flops"], cost["bytes"])
        return out
    lib = library("relu_attn_causal")
    fn = (lib.relu_attn_causal_f32 if q.dtype == torch.float32
          else lib.relu_attn_causal_bf16)
    fn.argtypes = [_P] * 5 + [_I] * 4 + [ctypes.c_float, _P]
    fn.restype = _I
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                ws.data_ptr(), BH, N, D,
                plan["chunk"], eps, stream_of(q))
    check(lib, status, "relu_attn_causal")
    relu_attn_causal.launches += 1
    return out


relu_attn_causal.launches = 0
