"""Data parallelism for the port (``mmqg_tpu/parallel``, its data axis):
the mesh and batch rules (``mesh``), one model replica per device for
serving and evaluation in one process (``replicas``), and the
multi-process runtime of training (``multihost``). The model axis (tensor
and sequence parallelism, ZeRO-1/FSDP, GPipe) is ROADMAP item 19b."""

from mmqg_tpu_torch.parallel.mesh import (Mesh, make_mesh, pad_batch,
                                          padded_rows, row_block,
                                          visible_devices)

__all__ = ["Mesh", "make_mesh", "pad_batch", "padded_rows", "row_block",
           "visible_devices"]
