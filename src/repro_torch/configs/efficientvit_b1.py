"""EfficientViT-B1, B2 and B3 as selectable configs, counterpart of
``repro/configs/efficientvit_b1.py``: ``VISION[name]`` addresses each
vision model by its published name."""
from repro_torch.core.efficientvit import B1, B1_SMOKE, B2, B3

CONFIG = B1
SMOKE = B1_SMOKE

VISION = {"efficientvit-b1": B1, "efficientvit-b2": B2,
          "efficientvit-b3": B3}
