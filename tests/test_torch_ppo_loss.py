"""Port fused PPO loss (plain forward and closed-form backward, the CPU side
of `ops/ppo_loss_kernel.py`) against the JAX reference: the Pallas kernel
`fused_clip_loss` in interpret mode and `ppo._loss_fn` under `jax.grad`.
Batch recipe of tests/test_pallas_ppo_loss.py at N=512 (and 768). Tolerances:
rtol 1e-5 for values (means of N float32 terms summed in another order),
atol 1e-6 for gradients (per-row values of size ~1/N, and their sum over
rows for a log_std shared by all rows)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surreal_tpu.algos import ppo as jppo
from surreal_tpu.models.distributions import DiagGauss as JGauss
from surreal_tpu.ops import pallas_ppo_loss
from surreal_tpu_torch.algos import ppo as tppo
from surreal_tpu_torch.ops import ppo_loss_kernel as plk

RTOL, ATOL_GRAD = 1e-5, 1e-6
# The (A,) log_std gradient against jax.grad of _loss_fn: two float32 sums
# of N row terms in different orders, of size ~1. At N=768 each lies within
# 8e-7 of a float64 evaluation of the closed form, and they differ by 1.5e-6.
ATOL_ROW_SUM_VS_AUTODIFF = 2e-6
KEYS = ("mean", "log_std", "value", "action", "logp_old", "mean_old", "log_std_old",
        "adv", "vtarg", "v_old")


def make_batch(seed, ties=False, N=512, log_std_rows=False):
    """log_std (A,) shared by all rows, or (N, A) with log_std_rows."""
    rs = np.random.RandomState(seed)
    A = 6
    f = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    mean, value, action = f(N, A), f(N), f(N, A)
    log_std = f(A) * 0.3
    if log_std_rows:
        log_std = log_std + 0.1 * f(N, A)
    mean_old = mean + 0.1 * f(N, A)
    log_std_old = log_std + np.float32(0.05)
    adv, vtarg, v_old = f(N), f(N), value + 0.1 * f(N)
    if ties:
        # value error ties: v - v_old is exactly ±clip_eps, so the clipped
        # and raw errors are equal; and rows with adv = 0, where the
        # clipped and unclipped surrogates are equal.
        rows = np.arange(0, N, 4)
        v_old[rows] = 0.0
        value[rows] = np.where(rs.rand(len(rows)) < 0.5, np.float32(0.2), np.float32(-0.2))
        adv[np.arange(1, N, 4)] = 0.0
    logp_old = np.asarray(JGauss.log_prob(mean_old, log_std_old, action))
    return dict(mean=mean, log_std=log_std, value=value, action=action, logp_old=logp_old,
                mean_old=mean_old, log_std_old=log_std_old, adv=adv, vtarg=vtarg, v_old=v_old)


def jax_fused(b, cfg):
    def fn(m, ls, v):
        return pallas_ppo_loss.fused_clip_loss(
            m, ls, v, *(b[k] for k in KEYS[3:]), clip_eps=cfg.clip_eps,
            value_coef=cfg.value_coef, entropy_coef=cfg.entropy_coef, interpret=True)
    return fn


def jax_ref(b, cfg):
    batch = (None, b["action"], b["logp_old"], b["mean_old"],
             jnp.broadcast_to(b["log_std_old"], b["mean"].shape), b["adv"], b["vtarg"],
             b["v_old"])

    def fn(m, ls, v):
        return jppo._loss_fn(cfg, lambda p, o: (m, ls, v), None, batch, jnp.float32(1.0),
                             jnp.float32(cfg.entropy_coef))
    return fn


def port_fused(b, cfg, g=None):
    """The port's loss, metrics and gradients; with `g`, the gradients of
    g·loss (g the loss's cotangent)."""
    t = {k: torch.tensor(v) for k, v in b.items()}
    leaves = [t[k].requires_grad_() for k in ("mean", "log_std", "value")]
    loss, metrics = plk.fused_clip_loss(
        *leaves, *(t[k] for k in KEYS[3:]), clip_eps=cfg.clip_eps,
        value_coef=cfg.value_coef, entropy_coef=cfg.entropy_coef)
    grads = torch.autograd.grad(loss, leaves, None if g is None else torch.tensor(g))
    return loss, metrics, grads


def _check(loss_j, met_j, grads_j, loss_t, met_t, grads_t, atol_dlog_std=ATOL_GRAD):
    np.testing.assert_allclose(float(loss_j), float(loss_t), rtol=RTOL, atol=1e-7)
    for k in met_j:
        np.testing.assert_allclose(float(met_j[k]), float(met_t[k]), rtol=RTOL, atol=1e-7,
                                   err_msg=k)
    for name, a, b, atol in zip(("dmean", "dlog_std", "dvalue"), grads_j, grads_t,
                                (ATOL_GRAD, atol_dlog_std, ATOL_GRAD)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("entropy_coef", [0.0, 0.01])
@pytest.mark.parametrize("ties", [False, True])
def test_fused_matches_pallas_kernel_interpret(entropy_coef, ties):
    cfg = jppo.PPOConfig(entropy_coef=entropy_coef)
    b = make_batch(0, ties)
    fn = jax_fused(b, cfg)
    args = (b["mean"], b["log_std"], b["value"])
    loss_j, met_j = fn(*args)
    grads_j = jax.grad(lambda *a: fn(*a)[0], argnums=(0, 1, 2))(*args)
    _check(loss_j, met_j, grads_j, *port_fused(b, cfg))


@pytest.mark.parametrize("entropy_coef", [0.0, 0.01])
def test_fused_matches_reference_autodiff(entropy_coef):
    """Without ties the closed-form backward equals autodiff of _loss_fn."""
    cfg = jppo.PPOConfig(entropy_coef=entropy_coef)
    b = make_batch(1)
    fn = jax_ref(b, cfg)
    args = (b["mean"], b["log_std"], b["value"])
    loss_j, met_j = fn(*args)
    grads_j = jax.grad(lambda *a: fn(*a)[0], argnums=(0, 1, 2))(*args)
    _check(loss_j, met_j, grads_j, *port_fused(b, cfg))


@pytest.mark.parametrize("N", [512, 768])
@pytest.mark.parametrize("log_std_rows", [False, True], ids=["log_std_A", "log_std_NA"])
@pytest.mark.parametrize("g", [1.0, 2.5])
def test_fused_cases_match_pallas_kernel_interpret(g, log_std_rows, N):
    """The loss's cotangent g (the gradient of g·loss), log_std as (A,) (JAX
    broadcasts it, so jax.grad gives the sum over rows) and as (N, A), and a
    minibatch of 768 rows."""
    cfg = jppo.PPOConfig(entropy_coef=0.01)
    b = make_batch(5, N=N, log_std_rows=log_std_rows)
    fn = jax_fused(b, cfg)
    args = (b["mean"], b["log_std"], b["value"])
    loss_j, met_j = fn(*args)
    grads_j = jax.grad(lambda *a: g * fn(*a)[0], argnums=(0, 1, 2))(*args)
    assert grads_j[1].shape == b["log_std"].shape
    _check(loss_j, met_j, grads_j, *port_fused(b, cfg, g))


@pytest.mark.parametrize("N", [512, 768])
@pytest.mark.parametrize("log_std_rows", [False, True], ids=["log_std_A", "log_std_NA"])
def test_fused_cases_match_reference_autodiff(log_std_rows, N):
    """The same cases against jax.grad of _loss_fn, with g = 2.5."""
    cfg = jppo.PPOConfig(entropy_coef=0.01)
    b = make_batch(6, N=N, log_std_rows=log_std_rows)
    fn = jax_ref(b, cfg)
    args = (b["mean"], b["log_std"], b["value"])
    loss_j, met_j = fn(*args)
    grads_j = jax.grad(lambda *a: 2.5 * fn(*a)[0], argnums=(0, 1, 2))(*args)
    _check(loss_j, met_j, grads_j, *port_fused(b, cfg, 2.5),
           atol_dlog_std=ATOL_GRAD if log_std_rows else ATOL_ROW_SUM_VS_AUTODIFF)


def test_plain_backward_sums_shared_log_std_over_rows():
    """The (A,) log_std gradient is the row sum of the (N, A) one at the
    same values."""
    b = {k: torch.tensor(v) for k, v in make_batch(7).items()}
    args = [b[k] for k in KEYS]
    g = torch.tensor(2.5)
    shared = plk.loss_bwd_plain(*args, g, 0.2, 0.5, 0.01)
    args[1] = args[1].expand_as(args[0]).contiguous()
    rows = plk.loss_bwd_plain(*args, g, 0.2, 0.5, 0.01)
    assert shared[1].shape == (6,) and rows[1].shape == (512, 6)
    torch.testing.assert_close(shared[1], rows[1].sum(0), rtol=0, atol=1e-6)
    for a, r in zip(shared[::2], rows[::2]):
        assert torch.equal(a, r)


def test_plain_forward_loss_and_metrics():
    """The forward's loss combines its metrics as _loss_fn does."""
    b = {k: torch.tensor(v) for k, v in make_batch(8).items()}
    loss, metrics = plk.loss_fwd_plain(*(b[k] for k in KEYS), 0.2, 0.5, 0.01)
    assert loss.shape == () and metrics.shape == (5,)
    assert torch.equal(loss, metrics[0] + 0.5 * metrics[1] - 0.01 * metrics[2])


@pytest.mark.parametrize("objective", ["clip", "adaptive_kl"])
def test_plain_loss_fn_matches_reference(objective):
    """The port's unfused `_loss_fn` and torch autograd against the
    reference's `_loss_fn` and jax.grad."""
    jcfg = jppo.PPOConfig(objective=objective, entropy_coef=0.01)
    tcfg = tppo.PPOConfig(objective=objective, entropy_coef=0.01)
    b = make_batch(2)
    fn = jax_ref(b, jcfg)
    args = (b["mean"], b["log_std"], b["value"])
    loss_j, met_j = fn(*args)
    grads_j = jax.grad(lambda *a: fn(*a)[0], argnums=(0, 1, 2))(*args)
    t = {k: torch.tensor(v) for k, v in b.items()}
    leaves = [t[k].requires_grad_() for k in ("mean", "log_std", "value")]
    batch = (None, t["action"], t["logp_old"], t["mean_old"],
             t["log_std_old"].expand_as(t["mean"]), t["adv"], t["vtarg"], t["v_old"])
    loss_t, met_t = tppo._loss_fn(tcfg, lambda o: tuple(leaves), batch,
                                  torch.tensor(1.0), 0.01)
    grads_t = torch.autograd.grad(loss_t, leaves)
    _check(loss_j, met_j, grads_j, loss_t, met_t, grads_t)


def test_gate_dispatches_fused(monkeypatch):
    """cfg.fused_loss routes _loss_fn through the fused function exactly when
    the reference's predicate admits (clip objective, no anneal, N % 256 == 0)."""
    calls = []
    orig = plk.fused_clip_loss
    monkeypatch.setattr(plk, "fused_clip_loss", lambda *a, **k: calls.append(1) or orig(*a, **k))
    b = {k: torch.tensor(v) for k, v in make_batch(3).items()}
    batch = (None, b["action"], b["logp_old"], b["mean_old"], b["log_std_old"], b["adv"],
             b["vtarg"], b["v_old"])
    net = lambda o: (b["mean"], b["log_std"], b["value"])  # noqa: E731
    cases = [
        (tppo.PPOConfig(fused_loss=True), 512, 1),
        (tppo.PPOConfig(fused_loss=False), 512, 0),
        (tppo.PPOConfig(fused_loss=True, objective="adaptive_kl"), 512, 0),
        (tppo.PPOConfig(fused_loss=True, entropy_final=0.0, entropy_anneal_iters=5), 512, 0),
        (tppo.PPOConfig(fused_loss=True), 384, 0),
    ]
    for cfg, n, want in cases:
        calls.clear()
        sub = tuple(x if x is None else x[:n] for x in batch)
        sub_net = lambda o, n=n: tuple(x[:n] if x.dim() and x.shape[0] == 512 else x  # noqa: E731
                                       for x in net(o))
        loss, _ = tppo._loss_fn(cfg, sub_net, sub, torch.tensor(1.0), cfg.entropy_coef)
        assert len(calls) == want, (cfg, n)
        assert torch.isfinite(loss)


def test_kernel_wrappers_reject_cpu_tensors():
    b = {k: torch.tensor(v) for k, v in make_batch(4).items()}
    args = [b[k] for k in KEYS]
    with pytest.raises(ValueError, match="CUDA"):
        plk._kernel_args(*args)
