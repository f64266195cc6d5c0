"""Batched policy inference service (port of surreal_tpu/train/serving.py):
one batched forward on the device for many envs' observations, and a
minimal length-prefixed TCP loop for clients in other processes (external
simulators, demo UIs). Users in the same process call `PolicyService.act`
directly."""

from __future__ import annotations

import copy
import json
import socket
import socketserver
import struct
import threading
from typing import Mapping

import numpy as np
import torch
from torch import nn

from surreal_tpu_torch.device import resolve as resolve_device
from surreal_tpu_torch.models.distributions import DiagGauss
from surreal_tpu_torch.models.z_filter import ZFilterState, zfilter_normalize


class PolicyService:
    """Serves `module`, a PPO actor-critic (obs -> (mean, log_std, value))
    or a DDPG actor (obs -> action), from its own copy of the module on
    `device`, so a trainer that goes on updating the original does not
    change the answers; `update_params` swaps new parameters in."""

    def __init__(self, module: nn.Module, zfilter: ZFilterState | None = None,
                 stochastic: bool = False, seed: int = 0,
                 device: str | torch.device | None = None):
        self._device = resolve_device(device)
        self._module = copy.deepcopy(module).to(self._device).requires_grad_(False)
        self._zf = None if zfilter is None else ZFilterState(
            *(getattr(zfilter, f).to(self._device) for f in ("count", "mean", "m2")))
        self._stochastic = stochastic
        self._generator = torch.Generator(device=self._device).manual_seed(seed)
        # handler threads share the generator and the parameters
        self._lock = threading.Lock()

    @torch.no_grad()
    def act(self, obs: np.ndarray) -> np.ndarray:
        """(B, D) observations -> (B, A) actions."""
        o = torch.as_tensor(np.asarray(obs, np.float32), device=self._device)
        if self._zf is not None:
            o = zfilter_normalize(self._zf, o)
        with self._lock:
            out = self._module(o)
            if not isinstance(out, tuple):  # a deterministic actor
                if self._stochastic:
                    raise ValueError("stochastic serving needs a module that returns "
                                     "(mean, log_std, ...)")
                action = out
            elif self._stochastic:
                action = DiagGauss.sample(out[0], out[1], generator=self._generator)
            else:
                action = out[0]
        return action.cpu().numpy()

    def update_params(self, params: Mapping[str, torch.Tensor]) -> None:
        """Hot-swaps the parameters from a state dict (mid-episode refresh)."""
        with self._lock:
            self._module.load_state_dict(params)

    # ---- wire protocol: 4-byte big-endian length + JSON {obs: [[...]]} ----
    def serve(self, host: str = "127.0.0.1", port: int = 0):
        """Starts a daemon TCP server; returns (server, (host, port)). The
        caller ends it with `server.shutdown()` and `server.server_close()`."""
        service = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    hdr = _recv_exact(self.request, 4)
                    if hdr is None:
                        return
                    (n,) = struct.unpack(">I", hdr)
                    payload = _recv_exact(self.request, n)
                    if payload is None:
                        return
                    msg = json.loads(payload)
                    actions = service.act(np.asarray(msg["obs"], np.float32))
                    out = json.dumps({"action": actions.tolist()}).encode()
                    self.request.sendall(struct.pack(">I", len(out)) + out)

        server = socketserver.ThreadingTCPServer((host, port), Handler)
        server.daemon_threads = True
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        return server, server.server_address


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def request_actions(addr, obs: np.ndarray) -> np.ndarray:
    """Client helper for the wire protocol above."""
    with socket.create_connection(addr) as s:
        payload = json.dumps({"obs": np.asarray(obs).tolist()}).encode()
        s.sendall(struct.pack(">I", len(payload)) + payload)
        (n,) = struct.unpack(">I", _recv_exact(s, 4))
        msg = json.loads(_recv_exact(s, n))
    return np.asarray(msg["action"], np.float32)
