"""A multi-rank dry run (the counterpart of the reference's
`__graft_entry__.dryrun_multichip`): one iteration of the whole PPO train
step (rollout, GAE, minibatched update) at tiny shapes, through the
trainers the CLI builds, on each of the reference's six layouts of
`n_devices` ranks:

1. dp: data = n;
2. dp + zero: ZeRO's Adam moments split over the data axis;
3. dp + lstm: the recurrent policy;
4. dp x time: data = n/2 x time = 2 (the GAE scan split over time);
5. dp x model: data = n/2 x model = 2 (the kernels split over model);
6. dp (ddpg): the off-policy trainer, two iterations.

The ranks are processes of their own (`parallel.mesh.spawn`), one gloo or
NCCL group by topology for all six layouts, which make their meshes on it
in turn. Rank 0 prints each layout's metrics; a non-finite metric, a
failed or a hung rank fails the run.

    python -m surreal_tpu_torch.dryrun 2 cuda
"""

from __future__ import annotations

import math
import os
import shutil
import sys
import tempfile

TIMEOUT_S = 600


def _layouts(n: int) -> list[tuple[str, tuple[int, int, int], dict]]:
    out = [("dp", (n, 1, 1), {}),
           ("dp + zero", (n, 1, 1), {"cfg": {"zero_optimizer": True}}),
           ("dp + lstm", (n, 1, 1), {"use_lstm": True, "lstm_size": 8})]
    if n % 2 == 0:
        out += [("dp x sp(time)", (n // 2, 1, 2), {}), ("dp x tp(model)", (n // 2, 2, 1), {})]
    return out + [("dp (ddpg)", (n, 1, 1), {"ddpg": True})]


def _finite(label: str, m: dict) -> dict:
    floats = {k: v for k, v in m.items() if isinstance(v, float)}
    assert all(math.isfinite(v) for v in floats.values()), (label, m)
    return {k: round(v, 4) for k, v in floats.items()}


def _rank(i: int, folder: str, n: int, device: str) -> None:
    import torch.distributed as dist

    from surreal_tpu_torch.algos import ddpg, ppo
    from surreal_tpu_torch.parallel import mesh as pmesh
    from surreal_tpu_torch.train import DDPGTrainer, PPOTrainer

    pmesh.distributed_init("file://" + os.path.join(folder, "store"), n, i, device=device,
                           timeout_s=TIMEOUT_S)
    try:
        for label, shape, kw in _layouts(n):
            mesh = pmesh.make_mesh(*shape, device=device)
            kw = dict(kw)
            if kw.pop("ddpg", False):
                cfg = ddpg.DDPGConfig(rollout_steps=4, updates_per_iteration=2,
                                      batch_size=2 * n, replay_capacity=64 * n,
                                      min_replay=2 * n)
                t = DDPGTrainer("cartpole-balance", cfg, num_envs=2 * n, seed=0,
                                actor_hidden=(16, 16), critic_hidden=(16, 16), mesh=mesh)
                m = t.run(2, log_every=2)[-1]
            else:
                cfg = ppo.PPOConfig(horizon=4, epochs=1, num_minibatches=1,
                                    **kw.pop("cfg", {}))
                t = PPOTrainer("cartpole-balance", cfg, num_envs=2 * n, seed=0,
                               hidden=(16, 16), mesh=mesh, **kw)
                m = t.run(1, log_every=1)[-1]
            shown = _finite(label, m)
            if mesh.primary:
                print(f"dryrun_multichip({n}) {label} OK:", shown, flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Runs the six layouts over `n_devices` ranks on `device` ("cuda": the
    visible cards, ranks sharing a card over gloo; "cpu")."""
    from surreal_tpu_torch.parallel.mesh import spawn

    folder = tempfile.mkdtemp(prefix="surreal_tpu_torch_dryrun_")
    try:
        spawn(_rank, n_devices, (folder, n_devices, device), timeout_s=TIMEOUT_S)
    finally:
        shutil.rmtree(folder, ignore_errors=True)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2,
                     sys.argv[2] if len(sys.argv) > 2 else "cuda")
