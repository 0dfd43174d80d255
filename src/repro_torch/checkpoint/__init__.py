"""Checkpoints, counterpart of ``repro/checkpoint/``: JAX's on-disk
layout, atomic writes, auto-resume and an async writer."""
