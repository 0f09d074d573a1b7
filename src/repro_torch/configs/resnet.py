"""The paper's own evaluation models: INT8 ResNet-18 / ResNet-50 on
224x224 ImageNet inputs (SS V).  CNN configs consumed by
``models/resnet.py``, not ``ModelConfig`` instances, so they stay out of
``ARCH_IDS`` (as in ``repro.configs.resnet``)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str
    variant: int          # 18 | 50
    image_size: int = 224
    num_classes: int = 1000


RESNET18 = ResNetConfig(name="resnet18", variant=18)
RESNET50 = ResNetConfig(name="resnet50", variant=50)
