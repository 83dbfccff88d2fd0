"""Several processes over ``torch.distributed``: the data, fsdp and tensor axes
of JAX's mesh (counterpart of ``cullavo_tpu/parallel``)."""
from cullavo_tpu_torch.parallel.mesh import (Layout, MeshConfig, ParallelContext, Shard,
                                             all_reduce_tree, gather_rows, gather_tree,
                                             initialize_distributed, parallel_context,
                                             process_count, process_index, shard_spec)
