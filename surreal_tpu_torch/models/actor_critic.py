"""PPO actor-critic network (port of surreal_tpu/models/actor_critic.py,
MLP form): separate actor and critic tanh MLP torsos, a Gaussian mean
head, a value head and a state-independent log-std clipped to [-8, 2]."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from surreal_tpu_torch.models.blocks import MLP


class PPOActorCritic(nn.Module):
    def __init__(self, obs_dim: int, action_dim: int, hidden: Sequence[int] = (64, 64),
                 activation: str = "tanh", init_log_std: float = 0.0,
                 pixel_obs: bool = False, use_lstm: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if pixel_obs or use_lstm:
            raise NotImplementedError(
                "pixel and LSTM actor-critics are not ported yet (ROADMAP.md, Queue A)"
            )
        self.actor_torso = MLP(obs_dim, hidden, activation, generator)
        self.critic_torso = MLP(obs_dim, hidden, activation, generator)
        self.mean_head = nn.Linear(self.actor_torso.out_dim, action_dim)
        self.value_head = nn.Linear(self.critic_torso.out_dim, 1)
        with torch.no_grad():
            # orthogonal(0.01) / orthogonal(1.0) kernels, zero biases (flax)
            nn.init.orthogonal_(self.mean_head.weight, 0.01, generator=generator)
            nn.init.orthogonal_(self.value_head.weight, 1.0, generator=generator)
            nn.init.zeros_(self.mean_head.bias)
            nn.init.zeros_(self.value_head.bias)
        self.log_std = nn.Parameter(torch.full((action_dim,), float(init_log_std)))

    def forward(self, obs: torch.Tensor):
        """obs (..., D) -> (mean (..., A), log_std (A,), value (...))."""
        mean = self.mean_head(self.actor_torso(obs))
        value = self.value_head(self.critic_torso(obs))[..., 0]
        # Bounded log-std: the clip binds only when training is diverging.
        log_std = torch.clamp(self.log_std, -8.0, 2.0)
        return mean, log_std, value
