"""xflowlint for the PyTorch port: the reference's AST tier, run over
the port's own sources (`xflow_tpu_torch/**/*.py` and `chip_smoke.py`).

It works from stdlib `ast` alone: nothing under analysis is imported or
executed, and the package imports neither torch nor jax, so it lints on
a machine with neither (the card's machine has no jax). The rule ids
and module names are the reference's (`xflow_tpu/analysis/`), so each
pass has a counterpart to read beside it:

- core.py      the Finding model, suppressions (`# xflowlint:
               disable=RULE`), the baseline, the Project/Module source
               set, the pass registry and `run_passes` (XF001: a file that
               does not parse)
- astutil.py   small AST helpers
- dataflow.py  the flow-sensitive abstract interpreter
- passes/      host syncs in the hot loops (XF110, XF111), cross-thread
               writes outside a lock (XF301), config keys against the
               port's config.py (XF401, XF402), record keys against
               docs/OBSERVABILITY.md (XF501, XF502)

The CLI is `python -m xflow_tpu_torch.tools.xflowlint`. The reference's
jit, recompile and sharding-contract rules and its jaxpr tier have no
subject in the port (no jit, no torch.compile, no CUDA graphs, no
PartitionSpecs), and it ships no shell script for the strict-mode rule.
"""

from xflow_tpu_torch.analysis.core import (  # noqa: F401
    Baseline,
    Finding,
    Module,
    Project,
    run_passes,
)
