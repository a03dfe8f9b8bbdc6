"""Operator registry and the ops of the port (every op of the JAX
package's registry)."""
from . import registry
from . import nn, matrix, elemwise, reduce, attention  # noqa: F401
from . import flash_attention, loss_output, init_ops  # noqa: F401
from . import optimizer_ops, control_flow, image_ops  # noqa: F401
from . import detection, spatial, contrib_tail  # noqa: F401
from . import linalg_ops, random_ops, ctc, contrib_ops  # noqa: F401
from . import quantization  # noqa: F401

__all__ = ["registry"]
