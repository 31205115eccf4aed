"""xflow-tpu on PyTorch and CUDA: the port of `xflow_tpu` to an NVIDIA H100.

The package imports torch and numpy, never jax and nothing of `xflow_tpu`;
it keeps its own copies of what it needs. Module names follow the JAX
package, so each module's counterpart is found under the same path.

Storage decision: every table is held LOGICAL, ``[S, K]`` (``[S]`` for a
scalar table). The JAX package's packed ``[S/8, 8K]`` layout answers the
TPU's (8, 128) memory tiling, which the card does not have; tables
arriving packed (`weights.tables_from_jax`, checkpoints) are unpacked at
that boundary with a free reshape.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
On the CPU each kernel op takes its plain PyTorch version; on the card it
launches the hand-written CUDA kernel (`csrc/`, built at first use into
`_build/`) or raises.

Slices ported so far: FM inference, checkpoint -> sorted-window evaluate
(`evaluate.py`, `python -m xflow_tpu_torch evaluate`) and row-major
serving (`serve/runner.py`); single-device FM training with FTRL or SGD
(`train/trainer.py`, `python -m xflow_tpu_torch train`); single-device MVM
training, evaluation and serving (`models/mvm.py`: the product row side,
and the segment row side over plans stacked into sub-batches through the
multi-buffer gather and scatter); LR, the default model (row-major, no
kernel); single-device FFM training, evaluation and serving
(`models/ffm.py`: the aligned hybrid over the windowed gather and the
scatters, and the row-major route for batches that repeat a field);
and since then the rest of the JAX package: the host input plane,
serving and its fleet, online training, the trainer's records, the
multi-device engines, the launchers and the multi-slice tier, serving
from a mesh (`serve` over a world of ranks), the C API (`c_api/`), the
raw Criteo / Avazu converter, the native plane's sanitizer builds and
the corruption helpers (`testing/faults.py`).
"""

from xflow_tpu_torch.version import __version__

__all__ = ["__version__"]
