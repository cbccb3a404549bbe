"""Mesh parallelism on ``torch.distributed``: (row, edge) device meshes,
sharded graphs, sharded train and embedding steps, multi-process init.

Port of ``decagon_tpu/parallel/``: one process a rank, each holding its
own slot of the sharded graph (``rowshard``) and of the relation-sharded
parameters (``sharded``)."""

from decagon_tpu_torch.parallel.mesh import (  # noqa: F401
    AXES,
    initialize_distributed,
    make_mesh,
)
from decagon_tpu_torch.parallel.rowshard import (  # noqa: F401
    ShardedGraph,
    build_sharded_device_graph,
)
from decagon_tpu_torch.parallel.sharded import (  # noqa: F401
    encode_sharded,
    make_sharded_embed_fn,
    make_sharded_train_step,
)
