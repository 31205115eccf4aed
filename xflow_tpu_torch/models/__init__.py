from xflow_tpu_torch.models.base import Model, get_model, register_model
from xflow_tpu_torch.models import fm  # noqa: F401  (registers the model)

__all__ = ["Model", "get_model", "register_model"]
