"""Pixel observations, the port against the JAX reference on the CPU: the
conv stem and the pixel actor-critic (weights carried by
`params_from_flax`), the parameter tree's round trip, `PixelWrapper` on
cheetah-run across an episode's end, and one whole pixel PPO train_step.

Tolerances:
- stem and actor-critic outputs and gradients: 1e-5 · max(1, |ref|)
  (float32 convolutions and matmuls summed in another order; measured
  < 1e-6);
- frames and frame stacks: the rasteriser's (tests/test_torch_render.py):
  at most 1 grey level on at most 1% of the pixels;
- rewards: 1e-5 · max(1, |ref|), the control step's float32 agreement
  (tests/test_torch_envs_*.py; measured < 1e-6); dones and discounts
  exactly;
- the PPO step: the trajectory 1e-4, values 1e-3 (tests/test_torch_ppo.py's
  bars); the update, fed the reference's own trajectory (the same uint8
  frames on both sides) and permutations: the torsos and heads within
  4e-6 abs (tests/test_torch_ppo.py's bar; measured 6e-8), the stem
  within 3e-5 (measured 1.4e-5 at 256 rows, 1.5e-8 at 8). The stem's 1.5M
  relu inputs a minibatch include some within rounding of 0, which send
  a gradient through one side's unit and not the other's; Adam's first
  steps scale each element's gradient to ~lr (3e-4), so such a change
  reads at that scale. Metrics rtol 1e-4, atol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surreal_tpu.algos import ppo as jppo
from surreal_tpu.envs import base as jbase
from surreal_tpu.envs import make_env as jmake_env
from surreal_tpu.envs.wrappers import PixelWrapper as JPixelWrapper
from surreal_tpu.envs.wrappers import pixel_flatten_obs as jpixel_flatten
from surreal_tpu.models.actor_critic import PPOActorCritic as FlaxAC
from surreal_tpu.models.blocks import ConvStem as FlaxStem
from surreal_tpu.models.ddpg_nets import DDPGActor as FlaxActor
from surreal_tpu.models.ddpg_nets import DDPGCritic as FlaxCritic
from surreal_tpu.ops import pallas_ppo_loss
from surreal_tpu_torch.algos import ppo as tppo
from surreal_tpu_torch.envs.base import EnvState
from surreal_tpu_torch.envs.cheetah import CheetahRun
from surreal_tpu_torch.envs.wrappers import PixelState, PixelWrapper, pixel_flatten_obs
from surreal_tpu_torch.models.actor_critic import PPOActorCritic
from surreal_tpu_torch.models.blocks import ConvStem, same_pads
from surreal_tpu_torch.models.convert import params_from_flax, params_to_flax
from surreal_tpu_torch.models.ddpg_nets import DDPGActor, DDPGCritic
from torch_helpers import ScriptedResets, assert_close, fast_jit, reference_reset_draws
from torch_helpers import reference_reset_rows, to_torch

TOL_NET, TOL_REWARD, TOL_TRAJ, TOL_VALUE = 1e-5, 1e-5, 1e-4, 1e-3
ATOL_PARAM, ATOL_STEM = 4e-6, 3e-5
MAX_LEVELS, MAX_SHARE = 1, 0.01
HIDDEN = (16, 16)


def assert_frames_close(ref, got, name):
    ref, got = np.asarray(ref), got.numpy()
    assert ref.shape == got.shape and got.dtype == np.uint8, (name, ref.shape, got.shape)
    diff = np.abs(ref.astype(np.int16) - got.astype(np.int16))
    assert diff.max() <= MAX_LEVELS and (diff > 0).mean() <= MAX_SHARE, (name, diff.max())


def _frames(shape, dtype, seed=0):
    x = np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)
    return x if dtype == "uint8" else (x / 255.0).astype(np.float32)


def _grads_close(ref_grads, module, name, stem_key="stem"):
    got = params_to_flax({n: p.grad for n, p in module.named_parameters()}, stem_key)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(ref_grads),
                                 jax.tree_util.tree_leaves_with_path(got), strict=True):
        assert_close(a, b, TOL_NET, f"{name} grad {jax.tree_util.keystr(path)}")


def test_same_pads_are_xla_s():
    """84 x 84 through (8, 4), (4, 2), (3, 1): the pads are (2, 2), then the
    asymmetric (1, 2), then (1, 1), and 11 x 11 x 64 features."""
    assert [same_pads(84, 8, 4), same_pads(21, 4, 2), same_pads(11, 3, 1)] == [
        (2, 2), (1, 2), (1, 1)]
    assert same_pads(48, 8, 4) == (2, 2) and same_pads(64, 8, 4) == (2, 2)
    assert ConvStem((84, 84, 3)).dense.in_features == 11 * 11 * 64


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("hw", [(84, 84), (48, 64)], ids=["84x84", "48x64"])
def test_conv_stem_matches_reference(hw, dtype):
    x = _frames((3, *hw, 3), dtype)
    stem = FlaxStem()
    params = stem.init(jax.random.PRNGKey(0), x)
    port = ConvStem((*hw, 3))
    port.load_state_dict(params_from_flax(jax.device_get(params), stem_key=""))
    out = port(torch.tensor(x))
    assert_close(stem.apply(params, x), out, TOL_NET, "stem")
    grads = jax.grad(lambda p: jnp.sum(jnp.sin(stem.apply(p, x))))(params)
    torch.sum(torch.sin(out)).backward()
    _grads_close(grads, port, "stem", stem_key="")


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("hw", [(84, 84), (48, 64)], ids=["84x84", "48x64"])
def test_pixel_actor_critic_matches_reference(hw, dtype):
    """One stem shared by both torsos: outputs and the gradients of a loss
    over all three heads."""
    x = _frames((3, *hw, 3), dtype, seed=1)
    net = FlaxAC(action_dim=6, hidden=HIDDEN, pixel_obs=True)
    params = net.init(jax.random.PRNGKey(1), x)
    port = PPOActorCritic((*hw, 3), 6, HIDDEN, pixel_obs=True)
    port.load_state_dict(params_from_flax(jax.device_get(params)))
    assert sum(isinstance(m, ConvStem) for m in port.modules()) == 1

    def loss(out):
        mean, log_std, value = out
        return (mean ** 2).sum() + 3.0 * log_std.sum() + (value ** 3).sum()

    outs = port(torch.tensor(x))
    for name, a, b in zip(("mean", "log_std", "value"), net.apply(params, x), outs):
        assert_close(a, b, TOL_NET, name)
    grads = jax.grad(lambda p: loss(net.apply(p, x)))(params)
    loss(outs).backward()
    _grads_close(grads, port, "actor-critic")


def test_params_round_trip():
    """params_to_flax ∘ params_from_flax is the identity on the pixel trees:
    the actor-critic's `stem`, the DDPG nets' auto-named `ConvStem_0`, a
    bare stem's own tree, and the conv kernels' (kh, kw, in, out) layout (48 x 64 frames, kh != kw
    nowhere, so the check is on the permutation's axes)."""
    x = _frames((1, 48, 64, 2), "uint8")
    trees = [(FlaxAC(action_dim=6, hidden=HIDDEN, pixel_obs=True).init(jax.random.PRNGKey(0), x),
              PPOActorCritic((48, 64, 2), 6, HIDDEN, pixel_obs=True), "stem"),
             (FlaxActor(6, HIDDEN, pixel_obs=True).init(jax.random.PRNGKey(1), x),
              DDPGActor((48, 64, 2), 6, HIDDEN, pixel_obs=True), "ConvStem_0"),
             (FlaxCritic(HIDDEN, pixel_obs=True).init(jax.random.PRNGKey(2), x,
                                                      jnp.zeros((1, 6))),
              DDPGCritic((48, 64, 2), 6, HIDDEN, pixel_obs=True), "ConvStem_0"),
             (FlaxStem().init(jax.random.PRNGKey(3), x), ConvStem((48, 64, 2)), "")]
    for params, module, stem_key in trees:
        params = jax.device_get(params)
        module.load_state_dict(params_from_flax(params, stem_key))
        back = params_to_flax(module.state_dict(), stem_key)
        assert jax.tree.structure(back) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back), strict=True):
            np.testing.assert_array_equal(np.asarray(a), b)
    w = trees[0][1].stem.conv_0.weight
    k = np.asarray(trees[0][0]["params"]["stem"]["Conv_0"]["kernel"])
    np.testing.assert_array_equal(w[5, 1, 2, 7].item(), k[2, 7, 1, 5])  # (kh, kw) not swapped


# ---------------------------------------------------------------------------
# PixelWrapper on cheetah-run
# ---------------------------------------------------------------------------

B = 4


def _inner_dones(t0, steps, ar, episode_steps=1000):
    """(steps · ar, B) done flags of the inner steps, from the start times."""
    t, out = np.array(t0), []
    for _ in range(steps * ar):
        t = t + 1
        out.append(t >= episode_steps)
        t = np.where(out[-1], 0, t)
    return np.stack(out)


@pytest.mark.parametrize("ar", [1, 2], ids=["repeat1", "repeat2"])
def test_pixel_wrapper_matches_reference(ar):
    """Reset, then three steps with env 0 and 2 ending their episode at the
    first step and env 1 at the second, with the reference's reset draws."""
    jenv = jmake_env("cheetah-run")
    jw = JPixelWrapper(jenv, action_repeat=ar)
    reset_fn, step_fn = jbase.vectorize(jw)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    js, jts = fast_jit(reset_fn)(keys)
    port = PixelWrapper(CheetahRun(device="cpu"), action_repeat=ar)
    assert port.episode_steps == jw.episode_steps == 1000 // ar
    assert port.obs_spec()["pixel"].shape == jw.obs_spec()["pixel"].shape == (84, 84, 3)
    # reset(key) draws from split(key)[0], as an auto-reset from a state holding key
    draw0 = reference_reset_draws(jenv, dataclasses.replace(js.inner, key=keys),
                                  np.zeros((1, B)))[0]
    ps, pts = port.reset(B, reset_draw={k: to_torch(v) for k, v in draw0.items()})
    assert_frames_close(js.stack, ps.stack, "reset stack")
    assert_frames_close(jpixel_flatten(jts.obs), pixel_flatten_obs(pts.obs), "reset obs")
    f0 = np.asarray(js.stack)
    assert (f0[..., 0] == f0[..., 1]).all() and (f0[..., 0] == f0[..., 2]).all()  # tiled

    t0 = np.array([1000 - ar, 1000 - 2 * ar, 1000 - ar, 0], np.int32)
    js = dataclasses.replace(js, inner=dataclasses.replace(js.inner, t=jnp.asarray(t0)))
    # the port starts from the reference's state: q, qd, t and the stack
    ps = PixelState(EnvState(to_torch(js.inner.q), to_torch(js.inner.qd), to_torch(t0)),
                    to_torch(js.stack))
    inner_draws = reference_reset_draws(jenv, js.inner, _inner_dones(t0, 3, ar))
    jstep = fast_jit(step_fn)
    rs = np.random.RandomState(0)
    for i in range(3):
        action = rs.uniform(-1, 1, (B, 6)).astype(np.float32)
        old_stack = ps.stack
        js, jts = jstep(js, action)
        draws = [{k: to_torch(v) for k, v in d.items()} for d in inner_draws[i * ar:(i + 1) * ar]]
        ps, pts = port.step(ps, torch.tensor(action), reset_draw=draws)
        np.testing.assert_array_equal(np.asarray(jts.done), pts.done.numpy())
        np.testing.assert_array_equal(np.asarray(jts.discount), pts.discount.numpy())
        assert_close(jts.reward, pts.reward, TOL_REWARD, "reward")
        assert_frames_close(js.stack, ps.stack, f"stack {i}")
        assert_frames_close(jpixel_flatten(jts.carry_obs), pixel_flatten_obs(pts.carry_obs),
                            f"carry obs {i}")
        assert_frames_close(jpixel_flatten(jts.obs), pixel_flatten_obs(pts.obs), f"obs {i}")
        assert torch.equal(pixel_flatten_obs(pts.obs), old_stack)  # the stack before the step
        np.testing.assert_array_equal(np.asarray(js.inner.t), ps.inner.t.numpy())
        assert_close(js.inner.q, ps.inner.q, TOL_REWARD, "q")
        done = pts.done.numpy()
        assert done.sum() == (2 if i == 0 else 1 if i == 1 else 0)
        s = ps.stack.numpy()
        for b in np.flatnonzero(done):  # a fresh episode's stack: its first frame tiled
            assert (s[b, ..., 0] == s[b, ..., 2]).all()


def test_grayscale_truncates_the_mean():
    port = PixelWrapper(CheetahRun(device="cpu"), grayscale=False, frame_stack=2)
    state, ts = port.reset(2, torch.Generator().manual_seed(0))
    assert ts.obs["pixel"].shape == (2, 84, 84, 6)
    rgb = state.stack[..., :3]
    gray = PixelWrapper(CheetahRun(device="cpu"))._frame(state.inner.q)
    want = (rgb.double().sum(-1, keepdim=True) / 3).floor().to(torch.uint8)
    assert torch.equal(gray, want)
    keep = PixelWrapper(CheetahRun(device="cpu"), keep_low_dim=True)
    _, ts = keep.reset(2, torch.Generator().manual_seed(0))
    assert set(ts.obs) == {"pixel", "position", "velocity"}


# ---------------------------------------------------------------------------
# One pixel PPO train_step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[(4, 4, 2, (84, 84)), (16, 16, 1, (48, 64))],
                ids=["B4_T4", "B16_T16_fused"])
def reference(request):
    """The reference's pixel rollout and update (frame stack 3, grayscale,
    action repeat 1), epochs 2: 4 envs, horizon 4 and 2 minibatches at
    84 x 84; 16 envs, horizon 16 and one minibatch at 48 x 64, whose 256
    rows admit the fused loss on both sides (the reference's Pallas kernel
    in interpret mode)."""
    B, T, mbs, hw = request.param
    cfg = jppo.PPOConfig(horizon=T, epochs=2, num_minibatches=mbs, fused_loss=True,
                         use_zfilter=False)
    jenv = jmake_env("cheetah-run")
    env = JPixelWrapper(jenv, *hw)
    reset_fn, step_fn = jbase.vectorize(env)
    env_state, ts0 = fast_jit(reset_fn)(jax.random.split(jax.random.PRNGKey(1), B))
    t0 = jnp.where(jnp.arange(B) % 4 == 0, 1000 - T // 2, 0).astype(jnp.int32)
    env_state = dataclasses.replace(env_state,
                                    inner=dataclasses.replace(env_state.inner, t=t0))
    obs = jpixel_flatten(ts0.obs)
    net = FlaxAC(action_dim=6, hidden=HIDDEN, pixel_obs=True)
    params = jax.jit(net.init)(jax.random.PRNGKey(0), obs[:1])  # one program, not ~100
    state = jppo.init_state(cfg, params, 1)
    k_roll, k_up = jax.random.split(jax.random.PRNGKey(7))
    traj, env_state2, obs2, _, _ = fast_jit(
        lambda s, es, o, r, k: jppo.rollout(cfg, net.apply, step_fn, jpixel_flatten,
                                            s, es, o, r, k))(state, env_state, obs,
                                                             jnp.zeros((B,)), k_roll)
    orig = pallas_ppo_loss.fused_clip_loss
    pallas_ppo_loss.fused_clip_loss = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    try:
        # XLA's default optimisation: the stem's gradients run ~4x slower
        # compiled at level 0 (fast_jit) than that saves in compiling
        new_state, metrics = jax.jit(
            lambda s, tr, k: jppo.update(cfg, net.apply, s, tr, k))(state, traj, k_up)
    finally:
        pallas_ppo_loss.fused_clip_loss = orig
    perms = np.stack([np.asarray(jax.random.permutation(k, B * T))
                      for k in jax.random.split(k_up, cfg.epochs)])
    noise = (np.asarray(traj.action) - np.asarray(traj.mean)) / np.exp(np.asarray(traj.log_std))
    assert np.asarray(traj.done).any(), "the rollout must cross an episode boundary"
    return dict(B=B, T=T, mbs=mbs, hw=hw, params=jax.device_get(params), env_state=env_state,
                obs=obs, traj=jax.device_get(traj), obs2=obs2, new_state=new_state,
                metrics=jax.device_get(metrics), perms=perms, noise=noise,
                reset_rows=reference_reset_rows(jenv, env_state.inner, traj.done))


def _port(ref):
    cfg = tppo.PPOConfig(horizon=ref["T"], epochs=2, num_minibatches=ref["mbs"],
                         fused_loss=True, use_zfilter=False)
    net = PPOActorCritic((*ref["hw"], 3), 6, HIDDEN, pixel_obs=True)
    net.load_state_dict(params_from_flax(ref["params"]))
    return cfg, tppo.init_state(cfg, net, 1)


def test_pixel_rollout_matches_reference(reference):
    cfg, state = _port(reference)
    es = reference["env_state"]
    env = PixelWrapper(ScriptedResets(reference["reset_rows"]), *reference["hw"])
    env_state = PixelState(EnvState(to_torch(es.inner.q), to_torch(es.inner.qd),
                                    to_torch(es.inner.t)), to_torch(es.stack))
    traj, _, obs2, _, stats = tppo.rollout(
        cfg, env, pixel_flatten_obs, state, env_state, to_torch(reference["obs"]),
        torch.zeros(reference["B"]), torch.Generator().manual_seed(0),
        noise=to_torch(reference["noise"]))
    tr = reference["traj"]
    assert traj.obs.dtype == torch.uint8 and stats["episodes_done"].dtype == torch.float32
    assert_frames_close(tr.obs, traj.obs, "trajectory frames")
    assert_frames_close(reference["obs2"], obs2, "final obs")
    for name in ("action", "log_prob", "mean", "log_std", "reward", "discount"):
        assert_close(getattr(tr, name), getattr(traj, name), TOL_TRAJ, name)
    for name in ("value", "next_value"):
        assert_close(getattr(tr, name), getattr(traj, name), TOL_VALUE, name)
    np.testing.assert_array_equal(np.asarray(tr.done), traj.done.numpy())


def test_pixel_update_matches_reference(reference):
    cfg, state = _port(reference)
    tr = reference["traj"]
    traj = tppo.Trajectory(**{f.name: to_torch(getattr(tr, f.name))
                              for f in dataclasses.fields(tppo.Trajectory)})
    assert traj.obs.dtype == torch.uint8
    state, metrics = tppo.update(cfg, state, traj, None, perms=to_torch(reference["perms"]))
    ref_params = reference["new_state"].params
    got = params_to_flax(dict(state.net.named_parameters()))
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(ref_params),
                                 jax.tree_util.tree_leaves_with_path(got), strict=True):
        err = np.abs(np.asarray(a) - b).max()
        tol = ATOL_STEM if "'stem'" in jax.tree_util.keystr(path) else ATOL_PARAM
        assert err <= tol, (jax.tree_util.keystr(path), err)
    moved = max(np.abs(np.asarray(a) - np.asarray(b)).max() for a, b in zip(
        jax.tree.leaves(ref_params), jax.tree.leaves(reference["params"])))
    assert moved > 10 * ATOL_STEM  # the two Adam steps moved the params well past both
    for k, v in reference["metrics"].items():
        # atol 1e-6: the policy loss is a mean of ~±1 terms that cancel to ~4e-4
        np.testing.assert_allclose(float(v), float(metrics[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert float(reference["new_state"].lr_scale) == float(state.lr_scale)
