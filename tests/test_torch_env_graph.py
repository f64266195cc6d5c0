"""The env step replayed from CUDA graphs (`envs/base.py::_StepGraphs`).

On the CPU: a step builds no tensor from a numpy array or a Python list, in
any registry env (such a conversion is a host copy on the card, which a
graph cannot capture). On the card (`-m cuda`): the graphed step against the
same step op by op, from the same inputs and generator state, over 300 steps
that cross episode ends; the generator's stream after graphed steps; the
returned tensors left as they are by the next replay; the calls that stay op
by op. No JAX here: the card's tests live in this file too.
"""

import traceback

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from surreal_tpu_torch.envs.base import EnvState, Environment
from surreal_tpu_torch.envs.registry import available_envs, make_env

torch.set_num_threads(1)  # as torch_helpers sets it for every port test file

# cheetah (the benchmark's env), finger (pair contacts, the K-candidate
# reset), manipulator (pair and wall rows, the prop's and arm's indices),
# cartpole (no contact)
GRAPHED = ["cheetah-run", "finger-spin", "manipulator-bring_ball", "cartpole-swingup"]
STEPS = 300
BATCH = 64


class _HostData(TorchDispatchMode):
    """Records where a tensor of one or more dimensions is made from host
    data (a numpy array, a list) inside the port: each is an `aten.lift_fresh`
    of a fresh CPU tensor. A Python scalar (0-d) is not host data: a
    `fill_` takes it on the card."""

    def __init__(self):
        super().__init__()
        self.sites: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.lift_fresh.default and args[0].dim() > 0:
            frames = [f for f in traceback.extract_stack() if "surreal_tpu_torch" in f.filename]
            self.sites.append(f"{frames[-1].filename}:{frames[-1].lineno}" if frames else "?")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", available_envs())
def test_a_step_builds_no_tensor_from_host_data(name):
    env = make_env(name, device="cpu")
    assert type(env).step is Environment.step
    g = torch.Generator().manual_seed(0)
    state, _ = env.reset(3, g)
    action = torch.rand((3, env.action_dim), generator=g) * 2 - 1
    state, _ = env.step(state, action, g)  # the first fills the model's tensor caches
    with _HostData() as seen:
        env.step(state, action, g)
    assert not seen.sites, seen.sites


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _start(env: Environment, batch: int, gen: torch.Generator) -> EnvState:
    """Start states whose episodes end at steps spread over the first 200."""
    state, _ = env.reset(batch, gen)
    left = 1 + torch.randint(0, 200, (batch,), generator=gen, device=gen.device)
    return EnvState(q=state.q, qd=state.qd, t=(env.episode_steps - left).to(state.t.dtype))


def _action(env: Environment, batch: int, gen: torch.Generator) -> torch.Tensor:
    return torch.rand((batch, env.action_dim), generator=gen, device=gen.device) * 2 - 1


def _flat(state: EnvState, ts) -> dict[str, torch.Tensor]:
    out = {"q": state.q, "qd": state.qd, "t": state.t, "reward": ts.reward,
           "discount": ts.discount, "done": ts.done}
    out.update({f"obs.{k}": v for k, v in ts.obs.items()})
    out.update({f"carry_obs.{k}": v for k, v in ts.carry_obs.items()})
    return out


def _assert_bitwise(got: dict, want: dict, where: str):
    assert got.keys() == want.keys(), where
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, (where, k)
        assert torch.equal(got[k], want[k]), (
            where, k, (got[k].double() - want[k].double()).abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("name", GRAPHED)
def test_graphed_step_equals_the_step_op_by_op(card, name):
    """Each of 300 steps, from the same state, action and generator state:
    bitwise the same outputs (states, observations, rewards, done flags,
    step counters, the reset rows) and the same generator state after."""
    env = make_env(name, device=card)
    gen = torch.Generator(device=card).manual_seed(11)
    state = _start(env, BATCH, gen)
    done_steps = 0
    for i in range(STEPS):
        action = _action(env, BATCH, gen)
        before = gen.get_state()
        want = _flat(*env._step_ops(state, action, gen, None))
        after = gen.get_state()
        gen.set_state(before)
        state, ts = env.step(state, action, gen)
        assert torch.equal(gen.get_state(), after), i
        _assert_bitwise(_flat(state, ts), want, f"step {i}")
        done_steps += bool(ts.done.any())
    assert len(env._graphs) == 1  # one signature, captured once
    assert done_steps >= 50  # the episode ends fall over the first 200 steps


@pytest.mark.cuda
@pytest.mark.parametrize("name", GRAPHED)
def test_graphed_steps_leave_the_generator_as_the_steps_op_by_op(card, name):
    """After 300 steps, each drawing its action and its reset from one
    generator, the graphed run's next draw equals the run's op by op, and
    so do its done flags and step counters all the way."""
    runs = []
    for graphed in (True, False):
        env = make_env(name, device=card)
        gen = torch.Generator(device=card).manual_seed(23)
        state = _start(env, BATCH, gen)
        dones, counters = [], []
        for _ in range(STEPS):
            action = _action(env, BATCH, gen)
            state, ts = (env.step(state, action, gen) if graphed
                         else env._step_ops(state, action, gen, None))
            dones.append(ts.done)
            counters.append(state.t)
        runs.append((torch.stack(dones), torch.stack(counters), _action(env, BATCH, gen)))
    assert torch.stack([r[0] for r in runs]).any(0).any()  # episodes ended
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_what_a_step_returns_outlives_the_next_replay(card):
    env = make_env("cheetah-run", device=card)
    gen = torch.Generator(device=card).manual_seed(5)
    state = _start(env, BATCH, gen)
    first = env.step(state, _action(env, BATCH, gen), gen)
    kept = {k: v.clone() for k, v in _flat(*first).items()}
    env.step(first[0], _action(env, BATCH, gen), gen)
    env.step(state, _action(env, BATCH, gen), gen)
    _assert_bitwise(_flat(*first), kept, "after two more replays")


@pytest.mark.cuda
def test_an_injected_draw_or_a_grad_input_runs_op_by_op(card):
    env = make_env("cheetah-run", device=card)
    gen = torch.Generator(device=card).manual_seed(7)
    state = _start(env, BATCH, gen)
    action = _action(env, BATCH, gen)
    draw = env.draw_reset(BATCH, gen)
    got = env.step(state, action, gen, reset_draw=draw)
    _assert_bitwise(_flat(*got), _flat(*env._step_ops(state, action, gen, draw)), "draw")
    grad_action = action.clone().requires_grad_(True)
    new_state, _ = env.step(state, grad_action, gen)
    assert new_state.q.requires_grad  # the autograd graph runs through the physics
    assert "_graphs" not in env.__dict__


@pytest.mark.cuda
@pytest.mark.parametrize("name", available_envs())
def test_every_registry_env_captures_and_matches(card, name):
    """Three steps of each registry env at 8 envs, graphed against op by op
    from the same inputs."""
    env = make_env(name, device=card)
    gen = torch.Generator(device=card).manual_seed(3)
    state = _start(env, 8, gen)
    for i in range(3):
        action = _action(env, 8, gen)
        before = gen.get_state()
        want = _flat(*env._step_ops(state, action, gen, None))
        gen.set_state(before)
        state, ts = env.step(state, action, gen)
        _assert_bitwise(_flat(state, ts), want, f"step {i}")
