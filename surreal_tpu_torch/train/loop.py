"""The loop the trainers share: iterate, sum the episode returns on the
device, and read the metrics on the host once per log interval."""

from __future__ import annotations

import logging
import time
from typing import Callable

import numpy as np
import torch

log = logging.getLogger("surreal_tpu_torch.train")


class Trainer:
    """A trainer sets `device`, `global_iter` and `steps_per_iteration` and
    implements `_iterate`."""

    default_log_every = 10
    device: torch.device
    global_iter: int  # lifetime iteration count
    steps_per_iteration: int

    def _iterate(self) -> dict:
        """One train step on the trainer's own state; returns its metrics
        (scalar tensors, or numbers the host already knows),
        `episode_return_sum` and `episodes_done` among them."""
        raise NotImplementedError

    def _describe(self, m: dict) -> str:
        """The algorithm's part of the log line."""
        return ""

    def run(self, iterations: int, log_every: int | None = None,
            metric_sink: Callable | None = None) -> list[dict]:
        """Returns host-side metric dicts, one per log interval of `log_every`
        iterations (the trainer's `default_log_every` if None; reading them
        waits for the device). Raises FloatingPointError on a non-finite
        metric."""
        log_every = log_every or self.default_log_every
        logs = []
        ep_ret_acc = torch.zeros((), device=self.device)
        ep_cnt_acc = torch.zeros((), device=self.device)
        t0 = time.perf_counter()
        for it in range(1, iterations + 1):
            metrics = self._iterate()
            ep_ret_acc = ep_ret_acc + metrics["episode_return_sum"]
            ep_cnt_acc = ep_cnt_acc + metrics["episodes_done"]
            self.global_iter += 1
            if it % log_every == 0:
                m = {k: v if isinstance(v, int) else float(v) for k, v in metrics.items()}
                bad = [k for k, v in m.items() if not np.isfinite(v)]
                if bad:
                    raise FloatingPointError(
                        f"non-finite training metrics at iteration {it}: {bad} ({m})")
                m.pop("episode_return_sum")
                m.pop("episodes_done")
                cnt = float(ep_cnt_acc)
                dt = time.perf_counter() - t0
                m["iteration"] = self.global_iter
                m["env_steps"] = self.global_iter * self.steps_per_iteration
                m["env_steps_per_s"] = log_every * self.steps_per_iteration / dt
                if cnt > 0:
                    m["episode_return"] = float(ep_ret_acc) / cnt
                    ep_ret_acc = torch.zeros((), device=self.device)
                    ep_cnt_acc = torch.zeros((), device=self.device)
                logs.append(m)
                if metric_sink:
                    metric_sink(m)
                log.info("it %d steps %.2e sps %.0f ret %s %s", it, m["env_steps"],
                         m["env_steps_per_s"],
                         f"{m.get('episode_return', float('nan')):.1f}", self._describe(m))
                t0 = time.perf_counter()
        return logs
