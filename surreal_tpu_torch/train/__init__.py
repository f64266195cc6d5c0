from surreal_tpu_torch.train.ddpg_trainer import DDPGTrainer
from surreal_tpu_torch.train.ppo_trainer import PPOTrainer

__all__ = ["DDPGTrainer", "PPOTrainer"]
