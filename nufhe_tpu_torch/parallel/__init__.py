"""Multi-device execution on ``torch.distributed``: one process per card,
NCCL between cards (gloo when the caller asks for the CPU), a
``DeviceMesh`` with dims ``('data', 'model')``.  The counterpart of
``nufhe_tpu/parallel/``."""
