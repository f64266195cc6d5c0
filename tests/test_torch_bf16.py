"""bfloat16 network compute (ROADMAP A13) in the port against the JAX
package on the CPU: each block's forward and its gradients into the
float32 parameters, against flax's `dtype=bfloat16`; and the trainers in
bfloat16. One update on each learner path is held in
tests/test_torch_bf16_updates.py.

Both sides multiply bfloat16 by bfloat16 with float32 accumulation and
one rounding (a matmul agrees bit for bit), and both add a Dense's or a
conv's bias after rounding its product (F.linear would not:
`blocks.linear`). Tolerances, each with the largest value measured on the
CPU:
- forwards, in bfloat16 ulps (2^-8 relative to max(1, |ref|)):
  TOL_FWD_ULPS (2) for the feed-forward blocks; MLPs and the plain
  actor-critic agree bit for bit, the conv stem to 0.25 ulp (the
  convolution's summation order), the DDPG nets to 0.69. TOL_LSTM_ULPS (4)
  for the LSTM: XLA's CPU backend expands the logistic to
  1 / (1 + exp(-x)) and rounds each of its three steps to bfloat16, where
  torch rounds the sigmoid once (an ulp apart on 34% of inputs); 1.32
  ulps after 5 steps of the cell, 1.6 after 3 of the LSTM actor-critic;
- gradients into the float32 parameters, per leaf and relative to its
  largest element: within TOL_GRAD (2^-5) plus twice the reference's own
  distance from its float32 twin (the same network in float32). XLA sums a
  broadcast bias's cotangents in bfloat16, torch in float32 with one
  rounding, so a bias's gradient is as far from the reference's as the
  reference's is from float32: measured up to 8.9% on a conv bias (the
  reference's own distance 9.3%), at most 1.7% on every other leaf.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surreal_tpu.models import blocks as jblocks
from surreal_tpu.models import ddpg_nets as jnets
from surreal_tpu.models.actor_critic import PPOActorCritic as FlaxAC
from surreal_tpu_torch.algos import ddpg as tddpg
from surreal_tpu_torch.algos import ppo as tppo
from surreal_tpu_torch.models import blocks as tblocks
from surreal_tpu_torch.models import ddpg_nets as tnets
from surreal_tpu_torch.models.actor_critic import PPOActorCritic
from surreal_tpu_torch.models.convert import params_from_flax, params_to_flax
from surreal_tpu_torch.train import DDPGTrainer, PPOTrainer
from torch_helpers import fast_jit, to_torch

BF, TBF = jnp.bfloat16, torch.bfloat16
ULP = 2.0 ** -8
TOL_FWD_ULPS, TOL_LSTM_ULPS = 2.0, 4.0
TOL_GRAD = 2.0 ** -5
OBS_DIM, ACT_DIM, HIDDEN = 17, 6, (32, 32)
SHAPE = (84, 84, 3)


def _fwd_err(ref, got) -> float:
    """|ref - got| in bfloat16 ulps of max(1, |ref|)."""
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32), np.float64)
    got = got.detach().to(torch.float32).numpy().astype(np.float64)
    assert ref.shape == got.shape
    return float(np.abs(ref - got).max() / max(1.0, np.abs(ref).max()) / ULP)


def _grad_errs(ref_grads, f32_grads, module, stem_key) -> dict:
    """Per leaf: (|port - ref|, |ref - ref's float32 twin|), each relative to
    the leaf's largest reference element."""
    got = params_to_flax({n: p.grad for n, p in module.named_parameters()}, stem_key)
    out = {}
    for (path, a), (_, b), (_, c) in zip(jax.tree_util.tree_leaves_with_path(ref_grads),
                                         jax.tree_util.tree_leaves_with_path(got),
                                         jax.tree_util.tree_leaves_with_path(f32_grads),
                                         strict=True):
        a = np.asarray(a)
        scale = np.abs(a).max()
        out[jax.tree_util.keystr(path)] = (float(np.abs(a - b).max() / scale),
                                           float(np.abs(a - np.asarray(c)).max() / scale))
    return out


def _check_block(make, params, args, port, stem_key="stem", ulps=TOL_FWD_ULPS, port_fn=None):
    """The jitted flax forward in bfloat16 (`make(dtype)` -> apply) against
    the port's (`port`, or `port_fn` over `port`'s parameters), output for
    output (with their dtypes); and the gradients of a random projection of
    all outputs into the float32 parameters, each leaf no farther from the
    reference's than TOL_GRAD plus twice the reference's own distance from
    its float32 twin (the same network with compute_dtype float32)."""
    ref = jax.tree.leaves(fast_jit(make(BF))(params, *args))
    rs = np.random.RandomState(9)
    ws = [rs.randn(*np.shape(r)).astype(np.float32) for r in ref]

    def grads(dtype):
        def project(p):
            return sum(jnp.sum(o.astype(jnp.float32) * w)
                       for o, w in zip(jax.tree.leaves(make(dtype)(p, *args)), ws))
        return fast_jit(jax.grad(project))(params)

    got = (port_fn or port)(*map(to_torch, args))
    got = [g for g in jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, torch.Tensor))]
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        assert str(g.dtype).split(".")[-1] == str(r.dtype), (g.dtype, r.dtype)
        assert _fwd_err(r, g) <= ulps, _fwd_err(r, g)
    sum((g.to(torch.float32) * to_torch(w)).sum() for g, w in zip(got, ws)).backward()
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in port.parameters())
    for leaf, (err, ref_err) in _grad_errs(grads(BF), grads(jnp.float32), port,
                                           stem_key).items():
        assert err <= TOL_GRAD + 2 * ref_err, (leaf, err, ref_err)


def _frames(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, *SHAPE)).astype(np.uint8)


# --- the blocks ---

@pytest.mark.parametrize("layer_norm", [False, True], ids=["plain", "layer_norm"])
@pytest.mark.parametrize("activation", ["tanh", "relu"])
def test_mlp_bf16_matches_flax(activation, layer_norm):
    def make(dtype):
        return jblocks.MLP((32, 24, 16), activation, layer_norm, compute_dtype=dtype).apply

    net = jblocks.MLP((32, 24, 16), activation, layer_norm)
    rs = np.random.RandomState(2)
    x = (3 * rs.randn(64, OBS_DIM) + 1).astype(np.float32)
    params = jax.device_get(net.init(jax.random.PRNGKey(0), x))
    if layer_norm:  # away from flax's init of scale 1, bias 0
        ln = params["params"]["LayerNorm_0"]
        ln["scale"] = (1 + 0.3 * rs.randn(32)).astype(np.float32)
        ln["bias"] = (0.3 * rs.randn(32)).astype(np.float32)
    port = tblocks.MLP(OBS_DIM, (32, 24, 16), activation, layer_norm, compute_dtype=TBF)
    port.load_state_dict(params_from_flax(params))
    _check_block(make, params, (x,), port)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_conv_stem_bf16_matches_flax(dtype):
    """The uint8 frames are scaled by 1/255 in bfloat16, as the reference
    does."""
    x = _frames(4)
    if dtype == "float32":
        x = (x / 255.0).astype(np.float32)
    params = jax.device_get(jblocks.ConvStem().init(jax.random.PRNGKey(0), x))
    port = tblocks.ConvStem(SHAPE, compute_dtype=TBF)
    port.load_state_dict(params_from_flax(params, ""))
    _check_block(lambda dt: jblocks.ConvStem(compute_dtype=dt).apply, params, (x,), port,
                 stem_key="")


@pytest.mark.parametrize("steps", [1, 5], ids=["step", "sequence"])
def test_lstm_cell_bf16_matches_flax(steps):
    """flax's OptimizedLSTMCell(dtype=bfloat16) from a bfloat16 carry, one
    step or five with two rows of the carry zeroed after the second."""
    B, D, H = 8, 24, 16
    rs = np.random.RandomState(4)
    xs = rs.randn(steps, B, D).astype(np.float32)
    carry0 = tuple((s * rs.randn(B, H)).astype(np.float32) for s in (1.0, 0.5))
    keep = np.ones((B, 1), np.float32)
    keep[[1, 6]] = 0
    params = jax.device_get(fnn.OptimizedLSTMCell(H).init(jax.random.PRNGKey(0), carry0, xs[0]))
    for g in "ifgo":  # flax's biases start at zero
        params["params"][f"h{g}"]["bias"] = (0.2 * rs.randn(H)).astype(np.float32)

    def make(dtype):
        cell = fnn.OptimizedLSTMCell(H, dtype=dtype)

        def apply(p, xs, c0):
            carry = tuple(c.astype(dtype) for c in c0)
            outs = []
            for t in range(steps):
                carry, h = cell.apply({"params": p["params"]["lstm"]}, carry, xs[t])
                outs.append(h)
                if t == 1:
                    carry = tuple(c * keep.astype(dtype) for c in carry)
            return outs, carry

        return apply

    port = torch.nn.ModuleDict({"lstm": tblocks.LSTMCell(D, H, compute_dtype=TBF)})
    wrapped = {"params": {"lstm": params["params"]}}
    port.load_state_dict(params_from_flax(wrapped))

    def port_apply(xs, c0):
        carry = tuple(c.to(TBF) for c in c0)
        outs = []
        for t in range(steps):
            carry, h = port["lstm"](carry, xs[t])
            outs.append(h)
            if t == 1:
                carry = tuple(c * to_torch(keep).to(TBF) for c in carry)
        return outs, carry

    _check_block(make, wrapped, (xs, carry0), port, ulps=TOL_LSTM_ULPS, port_fn=port_apply)


@pytest.mark.parametrize("form", ["plain", "pixel", "lstm"])
def test_actor_critic_bf16_matches_flax(form):
    """mean and value float32 after the bfloat16 heads, log_std float32; the
    LSTM form over 3 steps from a bfloat16 carry, which stays bfloat16."""
    rs = np.random.RandomState(5)
    kw = {"pixel": dict(pixel_obs=True), "lstm": dict(use_lstm=True, lstm_size=16)}.get(form, {})
    def make(dtype):
        return FlaxAC(action_dim=ACT_DIM, hidden=HIDDEN, compute_dtype=dtype, **kw)

    jnet = make(BF)
    port = PPOActorCritic(SHAPE if form == "pixel" else OBS_DIM, ACT_DIM, HIDDEN,
                          compute_dtype=TBF, **kw)
    x = _frames(4) if form == "pixel" else rs.randn(3, 16, OBS_DIM).astype(np.float32)
    if form == "lstm":
        carry = jnet.initial_carry((16,))
        assert carry[0].dtype == BF and port.initial_carry((16,))[0].dtype == TBF
        params = jax.device_get(jnet.init(jax.random.PRNGKey(2), x[0], carry))
        for g in "ifgo":
            params["params"]["lstm"][f"h{g}"]["bias"] = (0.2 * rs.randn(16)).astype(np.float32)

        def make_seq(dtype):
            def apply(p, xs):
                c, outs = make(dtype).initial_carry((16,)), []
                for t in range(3):
                    *out, c = make(dtype).apply(p, xs[t], c)
                    outs.append(out)
                return outs, c
            return apply

        def port_fn(xs):
            c, outs = port.initial_carry((16,)), []
            for t in range(3):
                *out, c = port(xs[t], c)
                outs.append(out)
            return outs, c

        port.load_state_dict(params_from_flax(params))
        _check_block(make_seq, params, (x,), port, ulps=TOL_LSTM_ULPS, port_fn=port_fn)
        return
    params = jax.device_get(jnet.init(jax.random.PRNGKey(0), x))
    # the mean head's orthogonal(0.01) init: scaled up so that its output sees the torso
    params["params"]["mean_head"]["kernel"] = params["params"]["mean_head"]["kernel"] * 100
    params["params"]["log_std"] = (0.3 * rs.randn(ACT_DIM)).astype(np.float32)
    port.load_state_dict(params_from_flax(params))
    _check_block(lambda dt: make(dt).apply, params, (x,), port)


@pytest.mark.parametrize("pixels", [False, True], ids=["state", "pixel"])
@pytest.mark.parametrize("which", ["actor", "critic"])
def test_ddpg_nets_bf16_match_flax(which, pixels):
    """The actor's tanh in float32, Q cast to float32; on pixels the
    critic's bfloat16 stem output meets the float32 action in a float32
    concatenation, as jnp.concatenate promotes it."""
    rs = np.random.RandomState(6)
    shape = SHAPE if pixels else OBS_DIM
    obs = _frames(4) if pixels else rs.randn(64, OBS_DIM).astype(np.float32)
    act = rs.uniform(-1, 1, (len(obs), ACT_DIM)).astype(np.float32)
    if which == "actor":
        def make(dtype):
            return jnets.DDPGActor(ACT_DIM, (48, 32), pixel_obs=pixels, compute_dtype=dtype)

        port, args = tnets.DDPGActor(shape, ACT_DIM, (48, 32), pixel_obs=pixels,
                                     compute_dtype=TBF), (obs,)
    else:
        def make(dtype):
            return jnets.DDPGCritic((48, 32), pixel_obs=pixels, compute_dtype=dtype)

        port, args = tnets.DDPGCritic(shape, ACT_DIM, (48, 32), pixel_obs=pixels,
                                      compute_dtype=TBF), (obs, act)
    params = jax.device_get(make(BF).init(jax.random.PRNGKey(1), *args))
    # flax's last layer is ±sqrt(3e-3 / fan_in): scaled up so the output sees the
    # torso, and the actor's tanh stays off its saturation
    scale = 30 if which == "actor" and pixels else 300
    params["params"]["Dense_0"]["kernel"] = params["params"]["Dense_0"]["kernel"] * scale
    port.load_state_dict(params_from_flax(params, "ConvStem_0"))
    _check_block(lambda dt: make(dt).apply, params, args, port, stem_key="ConvStem_0")


def test_compute_dtype_leaves_the_parameters_float32():
    """The module is never cast: its parameters, state dict and Adam
    moments stay float32 masters; the dtype is taken by name too."""
    assert tblocks.resolve_dtype("bfloat16") is TBF is tblocks.resolve_dtype(TBF)
    with pytest.raises(ValueError, match="compute dtype"):
        tblocks.resolve_dtype("int8")
    net = PPOActorCritic(SHAPE, ACT_DIM, HIDDEN, pixel_obs=True, use_lstm=True,
                         lstm_size=8, compute_dtype=TBF)
    state = tppo.init_state(tppo.PPOConfig(), net, 1)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert all(m.dtype == torch.float32 for m in state.opt_state.mu.values())
    mean, log_std, value, carry = net(torch.zeros(2, *SHAPE, dtype=torch.uint8),
                                      net.initial_carry((2,)))
    assert mean.dtype == log_std.dtype == value.dtype == torch.float32
    assert carry[0].dtype == carry[1].dtype == TBF


# --- the trainers ---

PIXELS = {"height": 48, "width": 48, "action_repeat": 2}
TRAINERS = {
    "ppo_fused": lambda: PPOTrainer(
        "cartpole-balance", tppo.PPOConfig(horizon=32, epochs=2, num_minibatches=1,
                                           fused_loss=True),
        num_envs=8, hidden=(16, 16), device="cpu", compute_dtype="bfloat16"),
    "lstm_ppo": lambda: PPOTrainer(
        "cartpole-balance", tppo.PPOConfig(horizon=8, epochs=1, num_minibatches=2),
        num_envs=4, hidden=(16, 16), device="cpu", compute_dtype="bfloat16", use_lstm=True,
        lstm_size=8),
    "pixel_ppo": lambda: PPOTrainer(
        "cartpole-balance", tppo.PPOConfig(horizon=8, epochs=1, num_minibatches=2),
        num_envs=4, hidden=(16, 16), device="cpu", compute_dtype="bfloat16", pixel_obs=True,
        pixel_kwargs=PIXELS),
    "ddpg": lambda: DDPGTrainer(
        "cartpole-balance", tddpg.DDPGConfig(rollout_steps=4, updates_per_iteration=2,
                                             batch_size=16, min_replay=16, replay_capacity=256),
        num_envs=8, actor_hidden=(16, 16), critic_hidden=(16, 16), device="cpu",
        compute_dtype=TBF),
    "pixel_ddpg": lambda: DDPGTrainer(
        "cartpole-balance", tddpg.DDPGConfig(rollout_steps=4, updates_per_iteration=2,
                                             batch_size=8, min_replay=16, replay_capacity=64,
                                             shared_encoder=True, aug_shift=2),
        num_envs=4, actor_hidden=(16, 16), critic_hidden=(16, 16), device="cpu",
        compute_dtype=TBF, pixel_obs=True, pixel_kwargs=PIXELS),
}


@pytest.mark.parametrize("kind", list(TRAINERS))
def test_trainers_run_in_bf16(kind):
    """Two iterations (DDPG's second updates) and an evaluation: finite
    metrics, parameters and optimizer moments float32, the networks'
    outputs float32, the LSTM carry bfloat16."""
    t = TRAINERS[kind]()
    logs = t.run(2, log_every=1)
    assert [m["iteration"] for m in logs] == [1, 2]
    assert all(np.isfinite(v) for m in logs for v in m.values())
    nets = [m for m in vars(t.state).values() if isinstance(m, torch.nn.Module)]
    assert nets and all(p.dtype == torch.float32 for n in nets for p in n.parameters())
    assert all(mod.compute_dtype == TBF for n in nets for mod in n.modules()
               if hasattr(mod, "compute_dtype"))
    if kind.endswith("ddpg"):
        assert t.state.update_step > 0
        assert all(m.dtype == torch.float32 for m in t.state.critic_opt.mu.values())
        assert t.state.actor(t.obs).dtype == torch.float32
    else:
        assert all(m.dtype == torch.float32 for m in t.state.opt_state.mu.values())
        out = t.state.net(t.obs, t.carry) if t.use_lstm else t.state.net(t.obs)
        assert all(x.dtype == torch.float32 for x in out[:3])
        if t.use_lstm:
            assert t.carry[0].dtype == t.carry[1].dtype == TBF
            assert t.full_state["carry"][0].dtype == TBF
    t.env.episode_steps = 5
    assert np.isfinite(t.evaluate(episodes=2)["return_mean"])


def test_service_and_video_take_a_bf16_module(tmp_path):
    """PolicyService and record_video run unchanged on a trainer's bfloat16
    module: float32 actions, the service's answers equal to the module's
    own forward."""
    from surreal_tpu_torch.train.serving import PolicyService
    from surreal_tpu_torch.train.video import read_gif, record_video

    t = TRAINERS["ppo_fused"]()
    obs = np.random.RandomState(0).randn(5, t.obs.shape[1]).astype(np.float32)
    service = PolicyService(t.state.net, device="cpu")
    with torch.no_grad():
        want = t.state.net(to_torch(obs))[0].numpy()
    got = service.act(obs)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    policy, zf = t.deterministic_policy()
    path = str(tmp_path / "bf16.gif")
    assert np.isfinite(record_video(t.env, policy, path, steps=3, zfilter=zf, size=32))
    assert read_gif(path).shape[0] == 3
