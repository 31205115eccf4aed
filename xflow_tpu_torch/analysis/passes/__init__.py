"""The port's xflowlint passes. Importing this package registers every
pass with core.PASS_REGISTRY (`run_passes` imports it lazily)."""

from xflow_tpu_torch.analysis.passes import (  # noqa: F401
    config_keys,
    hostsync,
    lockset,
    schema_drift,
)
