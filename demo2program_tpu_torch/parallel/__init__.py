"""Data parallelism across processes (torch.distributed): parallel/mesh.py."""

from demo2program_tpu_torch.parallel.mesh import (  # noqa: F401
    DataMesh, all_reduce_gradients, all_reduce_sum, data_parallel_size,
    gather_host_rows, gather_rows, global_report, global_sum, make_mesh,
    make_mesh_2d, process_world, shard_batch, shard_batch_2d, shard_rows,
    world_of)
