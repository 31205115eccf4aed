"""The multi-device engines over `torch.distributed` (`xflow_tpu/parallel/`):
the mesh and its process groups (`mesh.py`), start-up (`distributed.py`),
the collectives with their backward rules (`collectives.py`), the
row-major sharded step (`train_step.py`), the replicated sorted engine
(`sorted_sharded.py`) and the fully-sharded one (`sorted_fullshard.py`).
"""
