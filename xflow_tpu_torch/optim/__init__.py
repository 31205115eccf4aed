from xflow_tpu_torch.optim.base import Optimizer, get_optimizer
from xflow_tpu_torch.optim import ftrl, sgd  # noqa: F401  (registration)

__all__ = ["Optimizer", "get_optimizer"]
