"""Pixel DDPG, the port against the JAX reference on the CPU: DrQ's random
shift from the reference's offsets, `sync_encoder`, a uint8 ring's round
trip, one update block with `shared_encoder` and `aug_shift` from the same
networks, ring contents and draws (replay indices and shift offsets
recomputed from the reference's keys), and the trainer's pixel knobs.

Tolerances: the shift and the ring exactly (a gather of uint8); the update
block's parameters, targets and Adam moments within 1e-5 abs and its
metrics rtol 1e-4, as tests/test_torch_ddpg.py's vector update, on all
but 1e-4 of each conv stem tensor's elements, and those within the three
Adam steps' reach, 3 · lr. DDPG's Adam (optax's eps of 1e-8) moves an
element by ~lr · sign(g) even where g is rounding noise: a few stem
gradient elements are sums over the batch and the positions that cancel
to ~1e-9, and the two sides round them to different signs (measured: 1 of
36,864 elements of Conv_2's kernel and 28 of 786,432 of the stem's
Dense_0 kernel beyond 1e-5, the largest 2.3e-4 at the critic's lr of
1e-3; every other tensor within 3e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surreal_tpu.algos import ddpg as jddpg
from surreal_tpu.data import replay as jreplay
from surreal_tpu.models import ddpg_nets as jnets
from surreal_tpu_torch.algos import ddpg as tddpg
from surreal_tpu_torch.data import replay as treplay
from surreal_tpu_torch.models import ddpg_nets as tnets
from surreal_tpu_torch.models.convert import params_from_flax, params_to_flax
from torch_helpers import fast_jit, to_torch

ATOL_PARAM, RTOL_METRIC, STEM_SHARE = 1e-5, 1e-4, 1e-4
SHAPE, ACT_DIM, B = (48, 64, 3), 2, 4
HID = (16, 16)
STEM = "ConvStem_0"  # the compact flax nets auto-name their conv stem


def _frames(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, *SHAPE)).astype(np.uint8)


@pytest.mark.parametrize("pad", [1, 4])
def test_random_shift_matches_reference(pad):
    obs = _frames(6, 0)
    key = jax.random.PRNGKey(pad)
    ref = np.asarray(jddpg.random_shift(key, jnp.asarray(obs), pad))
    offsets = to_torch(jax.random.randint(key, (6, 2), 0, 2 * pad + 1))
    got = tddpg.random_shift(torch.tensor(obs), pad, offsets=offsets)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(ref, got.numpy())
    drawn = tddpg.random_shift(torch.tensor(obs), pad, torch.Generator().manual_seed(0))
    assert drawn.shape == obs.shape and drawn.dtype == torch.uint8


def _flax_nets(shared=True):
    actor = jnets.DDPGActor(ACT_DIM, HID, pixel_obs=True, detach_stem=shared)
    critic = jnets.DDPGCritic(HID, pixel_obs=True)
    x = jnp.zeros((1, *SHAPE), jnp.uint8)
    ap = actor.init(jax.random.PRNGKey(0), x)
    cp = critic.init(jax.random.PRNGKey(1), x, jnp.zeros((1, ACT_DIM)))
    return actor, critic, ap, cp


def _port_nets(ap, cp, shared=True):
    actor = tnets.DDPGActor(SHAPE, ACT_DIM, HID, pixel_obs=True, detach_stem=shared)
    critic = tnets.DDPGCritic(SHAPE, ACT_DIM, HID, pixel_obs=True)
    actor.load_state_dict(params_from_flax(jax.device_get(ap), STEM))
    critic.load_state_dict(params_from_flax(jax.device_get(cp), STEM))
    return actor, critic


def test_sync_encoder_matches_reference():
    _, _, ap, cp = _flax_nets()
    actor, critic = _port_nets(ap, cp)
    assert not torch.equal(actor.stem.conv_0.weight, critic.stem.conv_0.weight)
    head = actor.head.weight.clone()
    tddpg.sync_encoder(actor, critic)
    ref = jax.device_get(jddpg.sync_encoder(ap, cp))
    got = params_to_flax(actor.state_dict(), STEM)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(got), strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert torch.equal(actor.head.weight, head)  # only the stem moved
    actor.stem.conv_0.weight.data.add_(1.0)  # a copy, not shared storage
    assert not torch.equal(actor.stem.conv_0.weight, critic.stem.conv_0.weight)


@pytest.fixture(scope="module")
def rings():
    """Both rings holding the same 24 steps of uint8 frames (capacity 16:
    wrapped), with dones."""
    rs = np.random.RandomState(3)
    kw = dict(replay_capacity=16 * B, rollout_steps=8)
    jr = jddpg.init_replay(jddpg.DDPGConfig(**kw), B, 1, ACT_DIM, obs_shape=SHAPE,
                           obs_dtype=jnp.uint8)
    tr = tddpg.init_replay(tddpg.DDPGConfig(**kw), B, 1, ACT_DIM, "cpu", obs_shape=SHAPE,
                           obs_dtype=torch.uint8)
    for i in range(3):
        chunk = {"obs": _frames(8 * B, 10 + i).reshape(8, B, *SHAPE),
                 "action": rs.uniform(-1, 1, (8, B, ACT_DIM)).astype(np.float32),
                 "reward": rs.rand(8, B).astype(np.float32),
                 "done": rs.rand(8, B) < 0.1}
        jr = jreplay.replay_insert(jr, jax.tree.map(jnp.asarray, chunk))
        tr = treplay.replay_insert(tr, {k: to_torch(v) for k, v in chunk.items()})
    return jr, tr


def test_uint8_ring_round_trip(rings):
    jr, tr = rings
    assert tr.data["obs"].dtype == torch.uint8 and tr.data["obs"].shape == (16, B, *SHAPE)
    assert tr.total == int(jr.total) == 24
    for k in jr.data:
        np.testing.assert_array_equal(np.asarray(jr.data[k]), tr.data[k].numpy())
    a, b = torch.tensor([8, 12, 20]), torch.tensor([0, 3, 1])
    w = treplay.replay_sample_nstep(tr, None, 3, n_step=3, index=(a, b))
    assert w["obs"].dtype == torch.uint8 and w["obs"].shape == (4, 3, *SHAPE)
    for i in range(3):
        for s in range(4):
            np.testing.assert_array_equal(
                w["obs"][s, i].numpy(), np.asarray(jr.data["obs"])[(int(a[i]) + s) % 16, int(b[i])])


def test_pixel_update_block_matches_reference(rings):
    """Three updates with shared_encoder and aug_shift = 4: the actor's stem
    follows the critic's after every update, and the shifted frames are
    the reference's."""
    jr, tr = rings
    kw = dict(batch_size=8, n_step=3, updates_per_iteration=3, shared_encoder=True,
              aug_shift=4)
    jcfg, tcfg = jddpg.DDPGConfig(**kw), tddpg.DDPGConfig(**kw)
    actor, critic, ap, cp = _flax_nets()
    ap = jddpg.sync_encoder(ap, cp)
    jstate = jddpg.init_state(jcfg, ap, cp, 1)
    ta, tc = _port_nets(ap, cp)
    tstate = tddpg.init_state(tcfg, ta, tc, 1)
    key = jax.random.PRNGKey(11)
    new, jm = fast_jit(lambda s, r, k: jddpg.update(jcfg, actor.apply, critic.apply, s, r, k))(
        jstate, jr, key)
    indices, offsets = [], []
    for key_u in jax.random.split(key, jcfg.updates_per_iteration):
        k_sample, _, k_aug, k_aug2 = jax.random.split(key_u, 4)
        k_t, k_b = jax.random.split(k_sample)
        oldest = max(int(jr.total) - jr.capacity_t, 0)
        num_valid = int(jr.total) - (jcfg.n_step + 1) + 1 - oldest
        indices.append((to_torch(oldest + jax.random.randint(k_t, (8,), 0, num_valid)),
                        to_torch(jax.random.randint(k_b, (8,), 0, B))))
        offsets.append(tuple(to_torch(jax.random.randint(k, (8, 2), 0, 9))
                             for k in (k_aug, k_aug2)))
    tstate, tm = tddpg.update(tcfg, tstate, tr, None, indices, aug_offsets=offsets)
    for name, ref_tree, module in (
            ("actor", new.actor_params, tstate.actor), ("critic", new.critic_params, tstate.critic),
            ("target_actor", new.target_actor_params, tstate.target_actor),
            ("target_critic", new.target_critic_params, tstate.target_critic)):
        got = params_to_flax(dict(module.named_parameters()), STEM)
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(ref_tree),
                                     jax.tree_util.tree_leaves_with_path(got), strict=True):
            err, where = np.abs(np.asarray(a) - b), jax.tree_util.keystr(path)
            if "ConvStem_0" in where:
                lr = tcfg.critic_lr if "critic" in name else tcfg.actor_lr
                assert err.max() <= 3 * lr, (name, where, err.max())
                assert (err > ATOL_PARAM).mean() <= STEM_SHARE, (name, where, err.max())
            else:
                assert err.max() <= ATOL_PARAM, (name, where, err.max())
    moved = max(np.abs(np.asarray(a) - np.asarray(b)).max() for a, b in zip(
        jax.tree.leaves(new.critic_params["params"]["ConvStem_0"]),
        jax.tree.leaves(cp["params"]["ConvStem_0"])))
    assert moved > 50 * ATOL_PARAM  # the TD loss moved the encoder well past the tolerance
    for a, c in zip(tstate.actor.stem.parameters(), tstate.critic.stem.parameters()):
        assert torch.equal(a, c)
    for k, v in jm.items():
        np.testing.assert_allclose(float(v), float(tm[k]), rtol=RTOL_METRIC, atol=1e-7,
                                   err_msg=k)
    for ref_opt, opt in ((new.actor_opt, tstate.actor_opt), (new.critic_opt, tstate.critic_opt)):
        assert int(ref_opt[1].count) == opt.count == 3
        for ref_tree, moments in ((ref_opt[1].mu, opt.mu), (ref_opt[1].nu, opt.nu)):
            for a, b in zip(jax.tree.leaves(ref_tree),
                            jax.tree.leaves(params_to_flax(moments, STEM)), strict=True):
                np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=ATOL_PARAM)


def test_trainer_pixel_knobs():
    """The reference's checks: the pixel knobs without pixels raise
    ValueError; with them, one stem from step 0 (targets too), a uint8 ring
    of frame stacks, the Z-filter off."""
    from surreal_tpu_torch.train import DDPGTrainer

    for knob in ({"shared_encoder": True}, {"aug_shift": 4}):
        with pytest.raises(ValueError, match="pixel-mode knob"):
            DDPGTrainer("cheetah-run", tddpg.DDPGConfig(**knob), num_envs=2, device="cpu")
    cfg = tddpg.DDPGConfig(replay_capacity=64, rollout_steps=2, shared_encoder=True,
                           use_zfilter=True)
    tr = DDPGTrainer("cheetah-run", cfg, num_envs=2, actor_hidden=HID, critic_hidden=HID,
                     device="cpu", pixel_obs=True,
                     pixel_kwargs={"height": 48, "width": 64, "action_repeat": 2})
    assert not tr.cfg.use_zfilter and tr.obs.shape == (2, 48, 64, 3)
    assert tr.replay.data["obs"].dtype == torch.uint8
    assert tr.replay.data["obs"].shape == (32, 2, 48, 64, 3)
    s = tr.state
    for a, c, ta in zip(s.actor.stem.parameters(), s.critic.stem.parameters(),
                        s.target_actor.stem.parameters()):
        assert torch.equal(a, c) and torch.equal(ta, c)
    assert s.actor.detach_stem and tr.env.episode_steps == 500
