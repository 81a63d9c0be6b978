"""Models of the port: UNet, UNet_CCT and their building blocks, and the
FCDiscriminator of deep_adversarial."""

from .discriminator import FCDiscriminator
from .factory import net_factory
from .norm import FusedBatchNorm
from .unet import UNet, UNetCCT

__all__ = ["FCDiscriminator", "FusedBatchNorm", "UNet", "UNetCCT",
           "net_factory"]
