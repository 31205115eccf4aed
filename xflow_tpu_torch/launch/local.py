"""The launch run id, after `xflow_tpu/launch/local.py`. The local
multi-process launcher itself is not taken over (it comes with the
launch layer)."""

from __future__ import annotations

from xflow_tpu_torch.telemetry import new_run_id


def resolve_launch_run_id() -> str:
    """The run id every process of this launch stamps: an exported
    XFLOW_RUN_ID, else a fresh one each launch (two launches from one
    process must not share an id, so not the process-cached
    `telemetry.resolve_run_id`)."""
    return new_run_id()
