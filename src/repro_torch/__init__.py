"""PyTorch + CUDA port of the EfficientViT serving stack (``repro``).

The module layout mirrors the JAX package ``src/repro/`` so each
counterpart sits at the same path.  The port imports ``torch`` and never
``jax`` or ``repro``; the tests hold it against the JAX package.

Entry points (``serving.vision.VisionEngine``, ``serving.executors.
ExecutorCache``, ``core.efficientvit.init_efficientvit``) run on the
CUDA card unless the caller asks for ``device="cpu"``.  On the card the
fused sites launch hand-written CUDA kernels (``csrc/``), built with
``nvcc`` at first use into ``build/repro_torch/`` at the repo root.
"""
