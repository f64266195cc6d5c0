"""The data mesh axis and its sharded train steps, and versioned actor
snapshots. The other mesh axes and ZeRO are not ported yet (ROADMAP.md,
Queue A: A15b)."""

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
