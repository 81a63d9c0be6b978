"""Models of the port: UNet, UNet_CCT and their building blocks."""

from .factory import net_factory
from .norm import FusedBatchNorm
from .unet import UNet, UNetCCT

__all__ = ["FusedBatchNorm", "UNet", "UNetCCT", "net_factory"]
