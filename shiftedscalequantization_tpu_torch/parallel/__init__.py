from .mesh import (batch_sharding, make_mesh, replicated, shard_batch,
                   shard_params, shard_qstate)
