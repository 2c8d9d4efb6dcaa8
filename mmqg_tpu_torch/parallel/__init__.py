"""Parallelism for the port (``mmqg_tpu/parallel``): the mesh, batch,
tensor-parallel and ZeRO-1/FSDP rules (``mesh``), one model replica per
row of the data axis for serving and evaluation in one process
(``replicas``), the multi-process runtime and its ``(data, model)`` grid
(``multihost``), the model axis's storage and collectives (``model_axis``),
the optimizer state and parameters split over the data axis (``zero``)
and the GPipe schedule (``gpipe``)."""

from mmqg_tpu_torch.parallel.mesh import (Mesh, make_mesh, pad_batch,
                                          padded_rows, row_block,
                                          visible_devices)

__all__ = ["Mesh", "make_mesh", "pad_batch", "padded_rows", "row_block",
           "visible_devices"]
