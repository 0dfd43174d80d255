"""Optimizers, counterpart of ``repro/optim/``: AdamW, the LR schedules
and the one-device part of int8 gradient compression."""
