"""Models of the port: the 2D zoo of ``net_factory`` (UNet, UNet_CCT,
UNet_CCT_3H, UNet_DS, UNet_URDS, PNet2D, EfficientNet-UNet) and
ScribbleVC, the FCDiscriminator of deep_adversarial and its 3D
counterpart, the 3D nets of ``net_factory_3d`` and the legacy GAN
blocks."""

from .discriminator import FC3DDiscriminator, FCDiscriminator
from .efficientunet import EffiUNet
from .factory import (
    MODEL_NUM_OUTPUTS,
    PERTURBED_MODELS,
    apply_model,
    init_model,
    net_factory,
)
from .nets3d import (
    AttentionUNet3D,
    UNet3D,
    VNet,
    VoxResNet,
    net_factory_3d,
)
from .norm import FusedBatchNorm
from .pnet import PNet2D
from .scribblevc import ScribbleVC
from .unet import (
    UNet,
    UNetCCT,
    UNetCCT3H,
    UNetDS,
    UNetURDS,
    channel_dropout,
    feature_dropout,
    feature_noise,
)

__all__ = ["AttentionUNet3D", "EffiUNet", "FC3DDiscriminator",
           "FCDiscriminator",
           "FusedBatchNorm", "MODEL_NUM_OUTPUTS", "PERTURBED_MODELS",
           "PNet2D", "ScribbleVC", "UNet", "UNet3D", "UNetCCT", "UNetCCT3H",
           "UNetDS", "UNetURDS", "VNet", "VoxResNet", "apply_model",
           "channel_dropout", "feature_dropout", "feature_noise",
           "init_model", "net_factory", "net_factory_3d"]
