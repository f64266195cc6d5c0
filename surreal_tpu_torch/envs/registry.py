"""`make_env` dispatch (port of surreal_tpu/envs/registry.py): the same 26
names. Names accept "domain-task" and the "dm_control:domain-task" form;
"gym:<env_id>" builds a batch of gymnasium envs (`GymEnv`, which takes
`num_envs`)."""

from __future__ import annotations

from typing import Callable

from surreal_tpu_torch.envs.base import Environment


def _builtin() -> dict[str, Callable[..., Environment]]:
    from surreal_tpu_torch.envs.ball_in_cup import BallInCup
    from surreal_tpu_torch.envs.cartpole import Cartpole
    from surreal_tpu_torch.envs.cheetah import CheetahRun
    from surreal_tpu_torch.envs.classic import AcrobotSwingup, PendulumSwingup
    from surreal_tpu_torch.envs.finger import Finger
    from surreal_tpu_torch.envs.hopper import Hopper
    from surreal_tpu_torch.envs.manipulator import Manipulator
    from surreal_tpu_torch.envs.pointmass import PointMass
    from surreal_tpu_torch.envs.reacher import Reacher
    from surreal_tpu_torch.envs.swimmer import Swimmer
    from surreal_tpu_torch.envs.walker import Walker

    def part(cls, **fixed):
        return lambda **kw: cls(**fixed, **kw)

    return {
        "cartpole-balance": part(Cartpole, swing_up=False, sparse=False),
        "cartpole-balance_sparse": part(Cartpole, swing_up=False, sparse=True),
        "cartpole-swingup": part(Cartpole, swing_up=True, sparse=False),
        "cartpole-swingup_sparse": part(Cartpole, swing_up=True, sparse=True),
        "cartpole-two_poles": part(Cartpole, swing_up=True, sparse=False, n_poles=2),
        "cartpole-three_poles": part(Cartpole, swing_up=True, sparse=False, n_poles=3),
        "cheetah-run": part(CheetahRun),
        "pendulum-swingup": part(PendulumSwingup),
        "acrobot-swingup": part(AcrobotSwingup, sparse=False),
        "acrobot-swingup_sparse": part(AcrobotSwingup, sparse=True),
        "hopper-stand": part(Hopper, hopping=False),
        "hopper-hop": part(Hopper, hopping=True),
        "reacher-easy": part(Reacher, target_size=0.05),
        "reacher-hard": part(Reacher, target_size=0.015),
        "walker-stand": part(Walker, move_speed=0.0),
        "walker-walk": part(Walker, move_speed=1.0),
        "walker-run": part(Walker, move_speed=8.0),
        "point_mass-easy": part(PointMass),
        "ball_in_cup-catch": part(BallInCup),
        "finger-spin": part(Finger, task="spin"),
        "finger-turn_easy": part(Finger, task="turn", target_radius=0.07),
        "finger-turn_hard": part(Finger, task="turn", target_radius=0.03),
        "manipulator-bring_ball": part(Manipulator, prop="ball"),
        "manipulator-bring_peg": part(Manipulator, prop="peg"),
        "swimmer-swimmer6": part(Swimmer, n_links=6),
        "swimmer-swimmer15": part(Swimmer, n_links=15),
    }


_REGISTRY: dict[str, Callable[..., Environment]] = {}


def _ensure_builtin() -> None:
    if not _REGISTRY:
        _REGISTRY.update(_builtin())


def register(name: str, factory: Callable[..., Environment]) -> None:
    """Adds (or replaces) a name; `factory(**kwargs)` builds the env, with
    `device` and `dtype` among the kwargs that `make_env` passes on."""
    _ensure_builtin()
    _REGISTRY[name] = factory


def make_env(name: str, **kwargs) -> Environment:
    """Builds the named env; `device` (default "cuda") and `dtype` go to it."""
    _ensure_builtin()
    if name.startswith("gym:"):  # "gym:<env_id>": the host-loop adapter
        from surreal_tpu_torch.envs.gym_adapter import GymEnv

        return GymEnv(name.split(":", 1)[1], **kwargs)
    key = name.split(":", 1)[-1]  # strip a "dm_control:" style prefix
    if key not in _REGISTRY:
        raise KeyError(f"Unknown env {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[key](**kwargs)


def available_envs() -> list[str]:
    _ensure_builtin()
    return sorted(_REGISTRY)
