"""Pluggable kernel registry, counterpart of ``repro/kernels/registry.py``.

Every fused execution path registers a ``KernelImpl`` under a
``(kind, precision)`` key; the planner (``core.fusion.plan_program``)
and the executor (``core.program.execute``) consult the registry.

Built-in registrations (loaded lazily from the kernel packages):

    ("dsconv", "fp")   kernels/dsconv/ops.py     DW+PW CUDA kernel
    ("mbconv", "fp")   kernels/mbconv/ops.py     PW+DW+PW CUDA kernel
    ("msa",    "fp")   kernels/relu_attn/ops.py  one attention launch per
                                                 MSA module
    ("dsconv", "int8") kernels/dsconv/ops.py     FIX8 DW+PW CUDA kernel
                                                 (+ the emitting variant)
    ("mbconv", "int8") kernels/mbconv/ops.py     FIX8 PW+DW+PW CUDA kernel
                                                 (+ the emitting variant)
    ("msa",    "int8") kernels/int8_matmul/ops.py W8A8 projections (the
                                                 output one emitting),
                                                 grouped int8 aggregation,
                                                 one attention launch
    ("group_agg", "int8") kernels/group_conv/ops.py  an int8-only kind
    ("supersite", "fp")   kernels/supersite/ops.py  a conv chain in one
    ("supersite", "int8")                           launch (fp banded,
                                                    FIX8 whole-map)

The fit model is the Hopper kernel's shared memory: ``smem_bytes(site)``
is what one CTA of the kernel needs with the blocks ``tune`` chooses,
checked against ``smem_budget`` (227 KB, the most one CTA may have).  A
site that does not fit is demoted with the reason ``"vmem"``, the JAX
package's name for the same decision, so plan reports compare.

``tune(site, autotune=, device=)`` returns the first of
``candidates(site)`` (the kernel's deterministic pick) unless it may
sweep: with ``autotune`` on the card it times every candidate
(``kernels.autotune``) and freezes the fastest.  The int8 kinds keep
their path rules and tune nothing, as in JAX.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Protocol, Tuple

__all__ = ["KernelImpl", "KernelBase", "register", "get_kernel",
           "get_probe", "conv_block_precision", "resolve_conv_precision",
           "SMEM_LIMIT", "N_SM", "SMEM_PER_SM", "SMEM_2_PER_SM", "CLUSTERS",
           "SCAN_TILE", "SCAN_SCORE_PITCH", "SCAN_MAX_WIDTH", "scan_pitch",
           "kernel_wrappers"]

SMEM_LIMIT = 232_448   # bytes of shared memory one CTA may use on an H100
N_SM = 132             # streaming multiprocessors of an H100 SXM
# Shared memory of one SM (228 KB), 1 KB of it reserved per CTA.
SMEM_PER_SM = 233_472
# Two CTAs fit on one SM when each needs at most this much shared memory,
# where their registers allow two as well.
SMEM_2_PER_SM = SMEM_PER_SM // 2 - 1024
# Thread-block clusters of each size the H100 holds at once, with 1 and 2
# CTAs per SM (cudaOccupancyMaxActiveClusters, chip_smoke.py's mbconv
# sweep): the SMs of a cluster share one GPC, and the GPCs' sizes leave
# some SMs idle at 4, 8 and 16.
CLUSTERS = {1: {1: 132, 2: 66, 4: 30, 8: 15, 16: 7},
            2: {1: 264, 2: 132, 4: 62, 8: 30, 16: 14}}

# The chunk-parallel scans (``csrc/chunk_scan.cuh``): the token tile
# (``TILE``), the pitch of the score tile (``SP``) and the widest state
# row (4 groups of 64 columns).
SCAN_TILE = 64
SCAN_SCORE_PITCH = 68
SCAN_MAX_WIDTH = 256


def causal_ops(n: int, c: int, mix: int, state: int) -> tuple:
    """Products of one row of a chunked causal scan over ``n`` tokens in
    chunks of ``c``: per chunk of L tokens, ``mix`` multiply-adds per
    causal (query, key) pair (the L(L+1)/2 of the triangle, the masked
    half never needed), ``state`` per token to read the state (none in
    the first chunk, whose state is zero) and ``state`` per token to
    update it (none in the last, whose state no output reads).  ->
    (triangle flops, read flops, update flops)."""
    ls = [min(c, n - i) for i in range(0, n, c)]
    return (sum(L * (L + 1) for L in ls) * mix,
            2 * state * (n - ls[0]), 2 * state * (n - ls[-1]))


# A wrapper called on meta tensors launches nothing: it allocates its
# output and workspace on meta and reports the work the kernel would do
# to the sinks installed here (``launch/cost.py``'s counters).
_META_SINKS: list = []


@contextlib.contextmanager
def meta_cost_sink(fn: Callable):
    """Install ``fn(name, flops, nbytes)`` for the block: every wrapper
    called on meta tensors inside it reports its kernel's cost."""
    _META_SINKS.append(fn)
    try:
        yield fn
    finally:
        _META_SINKS.remove(fn)


def note_meta_cost(name: str, flops: float, nbytes: float) -> None:
    """A wrapper's report of the kernel it stands in for on meta."""
    for fn in list(_META_SINKS):
        fn(name, flops, nbytes)


def scan_pitch(n: int) -> int:
    """Floats between staged rows of ``n`` values (``apitch`` in
    ``chunk_scan.cuh``): n rounded up to 4, plus 4 where that holds an
    even number of float4s."""
    p = -(-n // 4) * 4
    return p if p // 4 % 2 else p + 4


class KernelImpl(Protocol):
    """The uniform kernel interface the planner and executor consume."""
    kind: str
    precision: str
    dtype: str
    smem_budget: float
    batch_dependent_tiles: bool
    takes_q: bool    # consumes a producer's QTensor (int8 dataflow)
    emits_q: bool    # can quantize its own output (an int8 Epilogue)

    def site_precision(self, params) -> str:
        """Precision the site's param subtree carries: fp | int8 | mixed."""
        ...

    def resolve_precision(self, site_precision: str, requested: str
                          ) -> Tuple[str, Optional[str]]:
        """(site precision, requested) -> (run precision, fallback reason
        or None to proceed)."""
        ...

    def smem_bytes(self, site, blocks: Dict[str, int]) -> int:
        """Shared memory of one CTA for ``site`` with ``blocks``."""
        ...

    def tune(self, site, *, autotune: bool = True,
             device=None) -> Dict[str, int]:
        """Block choices to freeze into the site's decision: the
        deterministic pick, or with ``autotune`` on the card
        (``device``) the fastest of ``candidates`` by a timed sweep
        (``kernels.autotune``, cached on disk)."""
        ...

    def candidates(self, site) -> Tuple[Dict[str, int], ...]:
        """The family's candidate blocks for this site, the deterministic
        pick first, each fitting one CTA's shared memory.  Empty =
        nothing to sweep."""
        ...

    def block_work(self, site, blocks: Dict[str, int]) -> float:
        """Relative overcompute (>= 1.0) of tiling ``site`` with
        ``blocks``: host arithmetic, no device."""
        ...

    def apply(self, params, x, site, decision=None, *, epilogue=None):
        """Run the fused kernel on one site; an int8 ``epilogue`` (given
        only to impls with ``emits_q``) makes it return a ``QTensor``."""
        ...

    def ref(self, params, x, site, **kw):
        """The site's reference-path computation (parity oracle)."""
        ...


def conv_block_precision(block) -> str:
    """Precision of a conv+BN (or qconv) block tree: every subblock
    quantized -> int8, none -> fp, anything else -> mixed."""
    kinds = {"int8" if (isinstance(v, dict) and "qconv" in v) else "fp"
             for v in block.values() if isinstance(v, dict)}
    if kinds == {"int8"}:
        return "int8"
    if kinds == {"fp"}:
        return "fp"
    return "mixed"


def resolve_conv_precision(site_prec: str, requested: str
                           ) -> Tuple[str, Optional[str]]:
    """Conv-kind policy: the kernels consume one weight dtype, so a
    forced mismatch (or a part-quantized tree) demotes to reference."""
    if site_prec == "mixed":
        return "fp", "mixed"
    if requested in ("auto", site_prec):
        return site_prec, None
    return "fp", "quantized" if site_prec == "int8" else "not-quantized"


class KernelBase:
    """Default ``KernelImpl`` behavior: conv-style precision policy, no
    shared-memory constraint, no blocks.  Impls override what differs."""
    kind = ""
    precision = "fp"
    dtype = "f32"
    smem_budget = SMEM_LIMIT
    batch_dependent_tiles = False  # tune keys blocks on the batch axis
    takes_q = False
    emits_q = False

    def site_precision(self, params) -> str:
        return conv_block_precision(params)

    def resolve_precision(self, site_prec, requested):
        return resolve_conv_precision(site_prec, requested)

    def smem_bytes(self, site, blocks) -> int:
        return 0

    def tune(self, site, *, autotune=True, device=None):
        return {}

    def candidates(self, site):
        return ()

    def block_work(self, site, blocks):
        return 1.0

    def apply(self, params, x, site, decision=None):
        raise NotImplementedError(type(self).__name__)

    def ref(self, params, x, site, **kw):
        raise NotImplementedError(type(self).__name__)


_REGISTRY: Dict[Tuple[str, str], Any] = {}
_BUILTIN_MODULES = (
    "repro_torch.kernels.dsconv.ops",
    "repro_torch.kernels.mbconv.ops",
    "repro_torch.kernels.relu_attn.ops",
    "repro_torch.kernels.int8_matmul.ops",
    "repro_torch.kernels.group_conv.ops",
    "repro_torch.kernels.supersite.ops",
)
_builtins_loaded = False


def register(cls):
    """Class decorator: instantiate and register under
    ``(cls.kind, cls.precision)``.  Last registration wins."""
    impl = cls()
    assert impl.kind and impl.precision, cls
    _REGISTRY[(impl.kind, impl.precision)] = impl
    return cls


def _ensure_builtins() -> None:
    global _builtins_loaded
    if _builtins_loaded:
        return
    import importlib
    for mod in _BUILTIN_MODULES:
        importlib.import_module(mod)
    _builtins_loaded = True


def get_kernel(kind: str, precision: str = "fp"):
    """Look up the ``KernelImpl`` for a (kind, precision) pair."""
    _ensure_builtins()
    try:
        return _REGISTRY[(kind, precision)]
    except KeyError:
        raise KeyError(
            f"no kernel registered for {(kind, precision)!r}; "
            f"available: {sorted(_REGISTRY)}") from None


def get_probe(kind: str):
    """The impl answering kind-level questions: the "fp" registration
    when present, else any registration of that kind."""
    _ensure_builtins()
    impl = _REGISTRY.get((kind, "fp"))
    if impl is not None:
        return impl
    for (k, _), candidate in sorted(_REGISTRY.items()):
        if k == kind:
            return candidate
    raise KeyError(f"no kernel registered for kind {kind!r}; "
                   f"available: {sorted(_REGISTRY)}")


def kernel_wrappers() -> Dict[str, Any]:
    """Every kernel wrapper of the port by name.  Each carries a
    ``launches`` counter that it raises by one where it launches its
    kernel, and nowhere else.  A launch issued while a stream captures
    counts too: the CUDA graph records it.  A replay of that graph runs
    no wrapper and counts nothing (``serving.executors.Executor``)."""
    from repro_torch.kernels.dsconv.kernel import (
        dsconv_fused, dsconv_fused_int8, dsconv_fused_int8_emit)
    from repro_torch.kernels.group_conv.kernel import group_agg_int8
    from repro_torch.kernels.int8_matmul.kernel import (
        int8_matmul, int8_matmul_emit)
    from repro_torch.kernels.mbconv.kernel import (
        mbconv_fused, mbconv_fused_int8, mbconv_fused_int8_emit)
    from repro_torch.kernels.relu_attn.kernel import (
        relu_attn_causal, relu_attn_noncausal)
    from repro_torch.kernels.ssd.kernel import ssd_chunked
    from repro_torch.kernels.supersite.kernel import (
        supersite_fused, supersite_fused_int8)
    return {f.__name__: f for f in (
        dsconv_fused, mbconv_fused, relu_attn_noncausal, mbconv_fused_int8,
        mbconv_fused_int8_emit, dsconv_fused_int8, int8_matmul,
        group_agg_int8, supersite_fused, supersite_fused_int8,
        int8_matmul_emit, dsconv_fused_int8_emit, relu_attn_causal,
        ssd_chunked)}
