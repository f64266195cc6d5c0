"""PPO actor-critic network (port of surreal_tpu/models/actor_critic.py,
vector observations): an optional LSTM, separate actor and critic MLP
torsos, a Gaussian mean head, a value head and a state-independent log-std
clipped to [-8, 2]."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from surreal_tpu_torch.models.blocks import MLP, LSTMCell


class PPOActorCritic(nn.Module):
    def __init__(self, obs_dim: int, action_dim: int, hidden: Sequence[int] = (64, 64),
                 activation: str = "tanh", init_log_std: float = 0.0,
                 pixel_obs: bool = False, use_lstm: bool = False, lstm_size: int = 128,
                 generator: torch.Generator | None = None):
        super().__init__()
        if pixel_obs:
            raise NotImplementedError(
                "pixel actor-critics are not ported yet (ROADMAP.md, Queue A)")
        self.use_lstm = use_lstm
        self.lstm_size = lstm_size
        torso_in = lstm_size if use_lstm else obs_dim
        self.actor_torso = MLP(torso_in, hidden, activation, generator=generator)
        self.critic_torso = MLP(torso_in, hidden, activation, generator=generator)
        self.mean_head = nn.Linear(self.actor_torso.out_dim, action_dim)
        self.value_head = nn.Linear(self.critic_torso.out_dim, 1)
        with torch.no_grad():
            # orthogonal(0.01) / orthogonal(1.0) kernels, zero biases (flax)
            nn.init.orthogonal_(self.mean_head.weight, 0.01, generator=generator)
            nn.init.orthogonal_(self.value_head.weight, 1.0, generator=generator)
            nn.init.zeros_(self.mean_head.bias)
            nn.init.zeros_(self.value_head.bias)
        self.log_std = nn.Parameter(torch.full((action_dim,), float(init_log_std)))
        if use_lstm:
            self.lstm = LSTMCell(obs_dim, lstm_size, generator)

    def heads(self, x: torch.Tensor):
        """Torso input x (..., D) -> (mean (..., A), log_std (A,), value (...))."""
        mean = self.mean_head(self.actor_torso(x))
        value = self.value_head(self.critic_torso(x))[..., 0]
        # Bounded log-std: the clip binds only when training is diverging.
        log_std = torch.clamp(self.log_std, -8.0, 2.0)
        return mean, log_std, value

    def forward(self, obs: torch.Tensor, carry=None):
        """obs (..., D) -> (mean, log_std, value); with `use_lstm`, `carry`
        is the LSTM state `(c, h)` and the new carry is returned fourth."""
        if not self.use_lstm:
            return self.heads(obs)
        carry, x = self.lstm(carry, obs)
        return (*self.heads(x), carry)

    def initial_carry(self, batch_shape: tuple[int, ...] = ()):
        """Zero `(c, h)` of shape batch_shape + (lstm_size,) on the module's
        device; None without an LSTM."""
        if not self.use_lstm:
            return None
        zeros = torch.zeros(*batch_shape, self.lstm_size, device=self.log_std.device)
        return (zeros, zeros.clone())
