"""Data parallelism for the port (``mmqg_tpu/parallel``, its data axis):
the mesh, batch and ZeRO-1/FSDP rules (``mesh``), one model replica per
device for serving and evaluation in one process (``replicas``), the
multi-process runtime of training (``multihost``) and the optimizer state
and parameters split over its processes (``zero``). The model axis (tensor
and sequence parallelism, GPipe) is ROADMAP item 19b."""

from mmqg_tpu_torch.parallel.mesh import (Mesh, make_mesh, pad_batch,
                                          padded_rows, row_block,
                                          visible_devices)

__all__ = ["Mesh", "make_mesh", "pad_batch", "padded_rows", "row_block",
           "visible_devices"]
