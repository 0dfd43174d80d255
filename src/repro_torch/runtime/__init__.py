"""The training runtime, counterpart of ``repro/runtime/``: the
``Trainer`` (one device, or a mesh under a process group), the straggler
monitor and the elastic re-mesh (``elastic``)."""
from repro_torch.runtime.straggler import StragglerMonitor  # noqa: F401
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: F401
