"""Several processes over ``torch.distributed``: the data axis (counterpart of
``cullavo_tpu/parallel``)."""
from cullavo_tpu_torch.parallel.mesh import (MeshConfig, ParallelContext, all_reduce_tree,
                                             gather_rows, initialize_distributed,
                                             parallel_context, process_count, process_index)
