from surreal_tpu_torch.train.ppo_trainer import PPOTrainer

__all__ = ["PPOTrainer"]
