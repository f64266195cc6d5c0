"""PPO actor-critic network (port of surreal_tpu/models/actor_critic.py):
an optional conv stem for pixel observations (one, shared by both torsos),
an optional LSTM, separate actor and critic MLP torsos, a Gaussian mean
head, a value head and a state-independent log-std clipped to [-8, 2].
With `gtrxl` (port-only, `models/gtrxl.py`) one GTrXL torso replaces the
MLPs, and both heads read its output, as the GTrXL paper's agent does.

`compute_dtype` is the networks' (bfloat16: A13); `mean` and `value` are
cast to float32 after the heads and `log_std` stays float32, so the loss,
its kernels and the action sampling see float32 whatever the dtype."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from surreal_tpu_torch.models.blocks import MLP, ConvStem, LSTMCell, linear
from surreal_tpu_torch.models.gtrxl import GTrXL


class PPOActorCritic(nn.Module):
    """`obs_dim` is the flat observation's size, or with `pixel_obs` the
    frame stack's shape (H, W, C). `gtrxl`, GTrXL's keyword arguments
    (layers, width, heads, memory, mlp_width), makes the torso a
    GTrXL over flat observations; `hidden` and `activation` are then unused,
    and the algorithm drives the torso (`algos/ppo_gtrxl.py`)."""

    def __init__(self, obs_dim: int | Sequence[int], action_dim: int,
                 hidden: Sequence[int] = (64, 64), activation: str = "tanh",
                 init_log_std: float = 0.0, pixel_obs: bool = False, use_lstm: bool = False,
                 lstm_size: int = 128, generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype = torch.float32, gtrxl: dict | None = None):
        super().__init__()
        self.pixel_obs = pixel_obs
        self.compute_dtype = compute_dtype
        if pixel_obs:
            self.stem = ConvStem(obs_dim, generator=generator, compute_dtype=compute_dtype)
            obs_dim = self.stem.out_dim
        self.use_lstm = use_lstm
        self.lstm_size = lstm_size
        self.use_gtrxl = gtrxl is not None
        if self.use_gtrxl:
            if pixel_obs or use_lstm:
                raise ValueError("the GTrXL torso takes flat observations, without an LSTM")
            self.gtrxl = GTrXL(obs_dim, **gtrxl, generator=generator,
                               compute_dtype=compute_dtype)
            self.actor_torso = self.critic_torso = None
            head_in = self.gtrxl.out_dim
        else:
            torso_in = lstm_size if use_lstm else obs_dim
            self.actor_torso = MLP(torso_in, hidden, activation, generator=generator,
                                   compute_dtype=compute_dtype)
            self.critic_torso = MLP(torso_in, hidden, activation, generator=generator,
                                    compute_dtype=compute_dtype)
            head_in = self.actor_torso.out_dim
        self.mean_head = nn.Linear(head_in, action_dim)
        self.value_head = nn.Linear(head_in, 1)
        with torch.no_grad():
            # orthogonal(0.01) / orthogonal(1.0) kernels, zero biases (flax)
            nn.init.orthogonal_(self.mean_head.weight, 0.01, generator=generator)
            nn.init.orthogonal_(self.value_head.weight, 1.0, generator=generator)
            nn.init.zeros_(self.mean_head.bias)
            nn.init.zeros_(self.value_head.bias)
        self.log_std = nn.Parameter(torch.full((action_dim,), float(init_log_std)))
        if use_lstm:
            self.lstm = LSTMCell(obs_dim, lstm_size, generator, compute_dtype)

    def heads(self, x: torch.Tensor):
        """Torso input x (..., D) -> (mean (..., A), log_std (A,), value (...)),
        all three float32. With GTrXL, x is the torso's output itself."""
        if self.use_gtrxl:
            actor = critic = x.to(self.compute_dtype)
        else:
            actor, critic = self.actor_torso(x), self.critic_torso(x)
        mean = linear(self.mean_head, actor).to(torch.float32)
        value = linear(self.value_head, critic).to(torch.float32)[..., 0]
        # Bounded log-std: the clip binds only when training is diverging.
        log_std = torch.clamp(self.log_std, -8.0, 2.0)
        return mean, log_std, value

    def encode(self, obs: torch.Tensor) -> torch.Tensor:
        """The torsos' (or the LSTM's) input: the stem's features of pixel
        obs (..., H, W, C), else obs (..., D) itself."""
        return self.stem(obs) if self.pixel_obs else obs

    def forward(self, obs: torch.Tensor, carry=None):
        """obs (..., D) or (..., H, W, C) -> (mean, log_std, value); with
        `use_lstm`, `carry` is the LSTM state `(c, h)` and the new carry is
        returned fourth. A GTrXL torso has no forward of its own: its state is
        a ring and a cache (`algos/ppo_gtrxl.py` drives it)."""
        if self.use_gtrxl:
            raise TypeError("a GTrXL actor-critic steps through its torso's cache: "
                            "net.heads(net.gtrxl.step(...))")
        x = self.encode(obs)
        if not self.use_lstm:
            return self.heads(x)
        carry, x = self.lstm(carry, x)
        return (*self.heads(x), carry)

    def initial_carry(self, batch_shape: tuple[int, ...] = ()):
        """Zero `(c, h)` of shape batch_shape + (lstm_size,) in the compute
        dtype on the module's device; None without an LSTM."""
        if not self.use_lstm:
            return None
        zeros = torch.zeros(*batch_shape, self.lstm_size, dtype=self.compute_dtype,
                            device=self.log_std.device)
        return (zeros, zeros.clone())
