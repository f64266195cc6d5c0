"""The data x model x time mesh and its sharded train steps, ZeRO's split
optimizer, the time-sharded scan, tensor parallelism, and versioned actor
snapshots (the reference's surreal_tpu/parallel)."""

from surreal_tpu_torch.parallel.dp import (
    make_sharded_ddpg_step,
    make_sharded_ppo_lstm_step,
    make_sharded_ppo_step,
    replicate,
    shard_env_batch,
)
from surreal_tpu_torch.parallel.mesh import data_axis_size, make_mesh
from surreal_tpu_torch.parallel.param_sync import (
    ParamSyncState,
    param_sync_init,
    param_sync_refresh,
)
from surreal_tpu_torch.parallel.tshard import time_sharded_reverse_scan
