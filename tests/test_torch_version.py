"""PyTorch port, the package version: `xflow_tpu_torch.__version__`
(`version.py`, re-exported by the package as the JAX package does)
equals `xflow_tpu.__version__`."""

import xflow_tpu
import xflow_tpu_torch
from xflow_tpu_torch import version


def test_version_equals_the_jax_packages():
    assert xflow_tpu_torch.__version__ == version.__version__ == xflow_tpu.__version__
    assert xflow_tpu_torch.__all__ == xflow_tpu.__all__ == ["__version__"]
