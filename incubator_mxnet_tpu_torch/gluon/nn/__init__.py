"""`gluon.nn`: the layers the port carries (reference
`python/mxnet/gluon/nn/`)."""
from .activations import *  # noqa: F401,F403
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
from .sparse import *  # noqa: F401,F403
