from .mesh import (  # noqa: F401
    data_mesh,
    maybe_init_distributed,
    replicated,
    sharded_batch,
)
from .data_parallel import DataParallelTrainer, psum_train_step  # noqa: F401
from .tensor_parallel import (  # noqa: F401
    TensorParallelTrainer,
    mlp_tp_specs,
    shard_mlp,
    tp_mesh,
)
