from xflow_tpu_torch.models.base import Model, get_model, register_model
from xflow_tpu_torch.models import fm, lr, mvm  # noqa: F401  (register the models)

__all__ = ["Model", "get_model", "register_model"]
