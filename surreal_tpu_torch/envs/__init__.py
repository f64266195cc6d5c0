from surreal_tpu_torch.envs.base import Environment, flatten_obs, obs_flat_dim
from surreal_tpu_torch.envs.registry import available_envs, make_env

__all__ = ["Environment", "available_envs", "flatten_obs", "make_env", "obs_flat_dim"]
