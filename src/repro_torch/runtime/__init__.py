"""The training runtime, counterpart of ``repro/runtime/``: the
single-device ``Trainer`` and the straggler monitor.  ``elastic.py``
(re-meshing) goes with ``distributed/`` (ROADMAP A8g)."""
from repro_torch.runtime.straggler import StragglerMonitor  # noqa: F401
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: F401
