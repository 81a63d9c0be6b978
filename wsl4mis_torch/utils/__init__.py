"""Device, parameter bridge, checkpoints and logging helpers."""

from .device import resolve_device

__all__ = ["resolve_device"]
