"""vision.models — the model zoo (counterpart of
``paddle_tpu/vision/models/``; ref: python/paddle/vision/models/).

Every model takes ``device=`` (default the card; ``"cpu"`` for the CPU),
``dtype=`` and ``generator=`` beside the reference's arguments, and carries
the reference's parameter and buffer names, so ``utils.load_jax_params``
and ``utils.load_jax_buffers`` carry a reference model's weights and
BatchNorm statistics into its counterpart. Pretrained weights are not
bundled: ``pretrained=True`` raises with the reference's message.
"""
from .lenet import LeNet  # noqa: F401
from .alexnet import AlexNet, alexnet  # noqa: F401
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
from .resnet import (  # noqa: F401
    BasicBlock,
    BottleneckBlock,
    ResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
    wide_resnet50_2,
    wide_resnet101_2,
)
from .mobilenet import (MobileNetV1, MobileNetV2, mobilenet_v1,  # noqa: F401
                        mobilenet_v2)

__all__ = [
    "LeNet", "AlexNet", "alexnet", "VGG", "vgg11", "vgg13", "vgg16", "vgg19",
    "ResNet", "BasicBlock", "BottleneckBlock", "resnet18", "resnet34",
    "resnet50", "resnet101", "resnet152", "wide_resnet50_2",
    "wide_resnet101_2", "MobileNetV1", "MobileNetV2", "mobilenet_v1",
    "mobilenet_v2",
]


def _no_pretrained(name: str, pretrained: bool):
    if pretrained:
        raise ValueError(
            f"pretrained weights for {name} are not bundled (no network "
            "egress); convert the reference checkpoint and use "
            "set_state_dict instead"
        )


from .resnet import (  # noqa: E402,F401
    resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
    resnext101_64x4d, resnext152_32x4d, resnext152_64x4d,
)
from .extra_nets import *  # noqa: E402,F401,F403
