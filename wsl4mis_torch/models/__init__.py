"""Models of the port: UNet, UNet_CCT and their building blocks, the
FCDiscriminator of deep_adversarial, and ScribbleVC."""

from .discriminator import FCDiscriminator
from .factory import net_factory
from .norm import FusedBatchNorm
from .scribblevc import ScribbleVC
from .unet import UNet, UNetCCT

__all__ = ["FCDiscriminator", "FusedBatchNorm", "ScribbleVC", "UNet",
           "UNetCCT", "net_factory"]
