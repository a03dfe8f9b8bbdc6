"""Model graphs built directly as Symbols (the port's gluon comes later)."""
from .vgg import vgg_symbol

__all__ = ["vgg_symbol"]
