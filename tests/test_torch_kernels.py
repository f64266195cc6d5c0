"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: on a machine without a card each test skips (decided in the
`cuda_device` fixture, never at import). On the card:
    python -m pytest -m cuda tests/test_torch_kernels.py
Tolerances: GAE 1e-4 abs (a float32 scan; the kernel splits T into chunks
and recombines them, and fuses each multiply-add), the loss and its metrics
1e-5 abs (sums of N rows in another order), loss gradients 1e-6 abs
(per-row values of size ~1/N, and their fixed-order row sum for a shared
log_std against torch's sum(0)).
"""

import numpy as np
import pytest
import torch

from surreal_tpu_torch.ops import gae_kernel, returns
from surreal_tpu_torch.ops import ppo_loss_kernel as plk

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from surreal_tpu_torch.device import resolve

    return resolve("cuda")


COEFS = (0.2, 0.5, 0.01)  # clip_eps, value_coef, entropy_coef


def _loss_batch(N, A, dev, shared_log_std_old, log_std_rows=False):
    """log_std (A,) shared by all rows, or (N, A) with log_std_rows."""
    g = torch.Generator().manual_seed(N + A)
    f = lambda *s: torch.randn(*s, generator=g).to(dev)  # noqa: E731
    mean, value, action = f(N, A), f(N), f(N, A)
    log_std = 0.3 * f(A)
    if log_std_rows:  # the old policy's log_std stays close to each row's
        log_std = log_std + 0.1 * f(N, A)
    mean_old = mean + 0.1 * f(N, A)
    log_std_old = log_std + 0.05
    if not shared_log_std_old:
        log_std_old = log_std_old.expand(N, A).contiguous()
    z = (action - mean_old) * torch.exp(-log_std_old)
    logp_old = -0.5 * (z * z + np.log(2 * np.pi)).sum(-1) - log_std_old.expand(N, A).sum(-1)
    adv = f(N)
    adv[::7] = 0.0  # ties between the clipped and unclipped surrogate
    return (mean, log_std, value, action, logp_old, mean_old, log_std_old, adv, f(N),
            value + 0.1 * f(N))


def _at_offset(x):
    """A contiguous copy of x that starts one row (one element for an (A,)
    vector) into its storage: not 16-byte aligned."""
    buf = torch.empty((x.shape[0] + 1,) + x.shape[1:], device=x.device, dtype=x.dtype)
    buf[1:] = x
    return buf[1:]


def _check_loss_kernels(batch, g_loss):
    """Kernel against plain, forward (loss, metrics) within 1e-5 and
    backward (every output, the (A,) row sum included) within 1e-6."""
    k_fwd = plk.loss_fwd(*batch, *COEFS)
    p_fwd = plk.loss_fwd_plain(*batch, *COEFS)
    k_bwd = plk.loss_bwd(*batch, g_loss, *COEFS)
    p_bwd = plk.loss_bwd_plain(*batch, g_loss, *COEFS)
    torch.cuda.synchronize()
    for a, b in zip(k_fwd, p_fwd):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= 1e-5
    for a, b in zip(k_bwd, p_bwd):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= 1e-6


@pytest.mark.parametrize("B", [256, 100])
def test_gae_kernel_matches_plain(cuda_device, B):
    g = torch.Generator().manual_seed(B)
    T = 128
    r, v, nv = (torch.randn(T, B, generator=g).to(cuda_device) for _ in range(3))
    disc = (torch.rand(T, B, generator=g) > 0.02).float().to(cuda_device)
    done = (torch.rand(T, B, generator=g) < 0.05).to(cuda_device)
    before = gae_kernel.GAE.launches
    k = returns.gae(r, v, nv, disc, done, 0.99, 0.95, backend="pallas")
    assert gae_kernel.GAE.launches == before + 1
    p = returns.gae_plain(r, v, nv, disc, done, 0.99, 0.95)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert (a - b).abs().max().item() <= 1e-4


def _gae_batch(T, B, dev, p_done=0.05):
    g = torch.Generator().manual_seed(1000 * T + B)
    r, v, nv = (torch.randn(T, B, generator=g).to(dev) for _ in range(3))
    disc = (torch.rand(T, B, generator=g) > 0.02).float().to(dev)
    done = (torch.rand(T, B, generator=g) < p_done).to(dev)
    return r, v, nv, disc, done


@pytest.mark.parametrize("T,B", [(128, 256), (256, 128), (256, 256), (100, 100), (1, 7),
                                 (2048, 128)])
def test_gae_kernel_matches_plain_at_shapes(cuda_device, T, B):
    """The recipes' shapes, ragged T and B (a short last chunk, a masked
    column edge), one step, and T = 2048 walked in 8 segments."""
    batch = _gae_batch(T, B, cuda_device)
    k = returns.gae(*batch, 0.99, 0.95, backend="pallas")
    p = returns.gae_plain(*batch, 0.99, 0.95)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert a.shape == b.shape == (T, B) and a.is_contiguous()
        assert (a - b).abs().max().item() <= 1e-4


def test_gae_kernel_long_scans_across_segments(cuda_device):
    """No done and no termination: the carry crosses every chunk and every
    segment of T = 1000."""
    r, v, nv, disc, done = _gae_batch(1000, 64, cuda_device)
    disc, done = torch.ones_like(disc), torch.zeros_like(done)
    for a, b in zip(returns.gae(r, v, nv, disc, done, 0.99, 0.95, backend="pallas"),
                    returns.gae_plain(r, v, nv, disc, done, 0.99, 0.95)):
        assert (a - b).abs().max().item() <= 1e-4


def test_gae_kernel_takes_misaligned_views(cuda_device):
    """Contiguous views one row into their storage, at a B that leaves the
    base off every 16-byte boundary: taken in place, no copy."""
    batch = [_at_offset(x) for x in _gae_batch(128, 255, cuda_device)]
    assert all(x.is_contiguous() for x in batch)
    assert all(x.data_ptr() % 16 for x in batch[:4])
    for a, b in zip(returns.gae(*batch, 0.99, 0.95, backend="pallas"),
                    returns.gae_plain(*batch, 0.99, 0.95)):
        assert (a - b).abs().max().item() <= 1e-4


@pytest.mark.parametrize("T,B", [(128, 256), (2048, 128)])
def test_gae_kernel_is_deterministic(cuda_device, T, B):
    """A fixed order of composition and no atomics: two calls are bitwise equal."""
    batch = _gae_batch(T, B, cuda_device)
    first, second = (returns.gae(*batch, 0.99, 0.95, backend="pallas") for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_gae_kernel_propagates_nan_like_plain(cuda_device, bad):
    """0*NaN is formed as in the plain version: a NaN reaches every earlier
    step of its column, across dones too, and no other column."""
    r, v, nv, disc, done = _gae_batch(128, 256, cuda_device, p_done=0.2)
    r[77, 5] = bad
    assert done[:77, 5].any()
    k = returns.gae(r, v, nv, disc, done, 0.99, 0.95, backend="pallas")
    p = returns.gae_plain(r, v, nv, disc, done, 0.99, 0.95)
    for a, b in zip(k, p):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.isinf(a), torch.isinf(b))
        finite = torch.isfinite(b)
        assert (a[finite] - b[finite]).abs().max().item() <= 1e-4
    bad_cols = (~torch.isfinite(k[0])).any(0).nonzero().flatten().tolist()
    assert bad_cols == [5] and not torch.isfinite(k[0][:78, 5]).any()
    assert torch.isfinite(k[0][78:, 5]).all()


@pytest.mark.parametrize("row", [64, 63, 0, 127])
def test_gae_kernel_done_row_cuts_the_scan(cuda_device, row):
    """adv at a done step is its own delta, at a chunk's first step, its
    last, and both ends of T."""
    T, B = 128, 40
    r = torch.ones(T, B, device=cuda_device)
    v = torch.zeros(T, B, device=cuda_device)
    done = torch.zeros(T, B, dtype=torch.bool, device=cuda_device)
    done[row] = True
    adv, vt = returns.gae(r, v, v, torch.ones_like(r), done, 0.99, 0.95, backend="pallas")
    assert torch.equal(adv[row], torch.ones(B, device=cuda_device))
    if row:
        assert torch.allclose(adv[row - 1], 1 + 0.99 * 0.95 * adv[row])
    assert torch.equal(vt, adv)


def test_gae_is_one_device_kernel(cuda_device):
    """torch.profiler sees exactly one device kernel in `returns.gae`: no
    cast of dones, no fill, no second pass; and one launch is counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = _gae_batch(128, 256, cuda_device)
    returns.gae(*batch, 0.99, 0.95, backend="pallas")  # warm-up: build and load
    torch.cuda.synchronize()
    before = gae_kernel.GAE.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        returns.gae(*batch, 0.99, 0.95, backend="pallas")
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "gae_kernel" in names[0], names
    assert gae_kernel.GAE.launches == before + 1


def test_gae_kernel_rejects_what_it_does_not_take(cuda_device):
    r, v, nv, disc, done = _gae_batch(8, 128, cuda_device)
    for bad in ((r.double(), v, nv, disc, done), (r, v[:4], nv, disc, done),
                (r, v, nv.t().contiguous().t(), disc, done), (r, v, nv, disc.cpu(), done),
                (r[:0], v[:0], nv[:0], disc[:0], done[:0])):
        with pytest.raises(ValueError):
            gae_kernel.gae_cuda(*bad, 0.99, 0.95)


def test_gae_kernel_takes_bool_dones_only(cuda_device):
    """The kernel reads dones as bytes, as the rollout stores them."""
    x = torch.zeros(8, 128, device=cuda_device)
    with pytest.raises(ValueError, match="bool"):
        gae_kernel.gae_cuda(x, x, x, x, x, 0.99, 0.95)


ACTIONS = [1, 2, 6]  # cartpole's one actuator, finger-spin's two, cheetah's six


@pytest.mark.parametrize("A", ACTIONS)
@pytest.mark.parametrize("shared_log_std_old", [False, True])
def test_loss_kernels_match_plain(cuda_device, shared_log_std_old, A):
    batch = _loss_batch(4096, A, cuda_device, shared_log_std_old)
    _check_loss_kernels(batch, torch.ones((), device=cuda_device))


@pytest.mark.parametrize("A", ACTIONS)
@pytest.mark.parametrize("log_std_rows", [False, True], ids=["log_std_A", "log_std_NA"])
@pytest.mark.parametrize("N", [256, 2048, 4096, 4100, 16384])  # 2048: the pixel PPO minibatch
def test_loss_kernels_match_plain_at_sizes(cuda_device, N, log_std_rows, A):
    """A ragged tail (4100) and a row loop (4100, 16384 > the cluster's 4096
    threads), both log_std forms, and a cotangent g_loss other than 1, at
    each path's number of action dims."""
    batch = _loss_batch(N, A, cuda_device, False, log_std_rows)
    _check_loss_kernels(batch, torch.tensor(2.5, device=cuda_device))


@pytest.mark.parametrize("log_std_rows", [False, True], ids=["log_std_A", "log_std_NA"])
def test_loss_kernels_take_misaligned_views(cuda_device, log_std_rows):
    """Views one row into their storage: the 16-byte copies leave a head
    and a tail to scalar loads and stores."""
    batch = [_at_offset(x) for x in _loss_batch(4100, 6, cuda_device, False, log_std_rows)]
    assert all(x.is_contiguous() and x.data_ptr() % 16 for x in batch)
    _check_loss_kernels(batch, _at_offset(torch.full((1,), 2.5, device=cuda_device))[0])


@pytest.mark.parametrize("log_std_rows", [False, True], ids=["log_std_A", "log_std_NA"])
def test_loss_kernels_are_deterministic(cuda_device, log_std_rows):
    """A fixed reduction order and no atomics: two calls are bitwise equal."""
    batch = _loss_batch(16384, 6, cuda_device, False, log_std_rows)
    g = torch.tensor(2.5, device=cuda_device)
    first = (*plk.loss_fwd(*batch, *COEFS), *plk.loss_bwd(*batch, g, *COEFS))
    second = (*plk.loss_fwd(*batch, *COEFS), *plk.loss_bwd(*batch, g, *COEFS))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_loss_kernel_propagates_nan_like_plain(cuda_device):
    batch = list(_loss_batch(256, 6, cuda_device, False))
    batch[0] = batch[0].clone()
    batch[0][3, 2] = float("nan")
    k_loss, k_metrics = plk.loss_fwd(*batch, *COEFS)
    p_loss, p_metrics = plk.loss_fwd_plain(*batch, *COEFS)
    assert torch.equal(torch.isnan(k_metrics), torch.isnan(p_metrics))
    assert torch.isnan(k_metrics[0]) and torch.isnan(k_loss) and torch.isnan(p_loss)
    g = torch.ones((), device=cuda_device)
    for a, b in zip(plk.loss_bwd(*batch, g, *COEFS), plk.loss_bwd_plain(*batch, g, *COEFS)):
        assert torch.equal(torch.isnan(a), torch.isnan(b))


def test_loss_kernels_on_a_bf16_actor_critics_outputs(cuda_device):
    """The loss kernels take float32 under bfloat16 networks (A13), as the
    reference's Pallas loss does: the heads' outputs are cast to float32
    and log_std stays float32. N = 4096 rows of a bfloat16 (256, 256)
    actor-critic's outputs on the card, held against the plain versions;
    and the backward's float32 cotangents reach the float32 parameters
    through the cast."""
    from surreal_tpu_torch.models.actor_critic import PPOActorCritic

    N, A = 4096, 6
    net = PPOActorCritic(17, A, (256, 256), generator=torch.Generator().manual_seed(0),
                         compute_dtype=torch.bfloat16).to(cuda_device)
    g = torch.Generator().manual_seed(1)
    f = lambda *s: torch.randn(*s, generator=g).to(cuda_device)  # noqa: E731
    mean, log_std, value = net(f(N, 17))
    assert mean.dtype == log_std.dtype == value.dtype == torch.float32
    # the old policy close to the network's, as after a rollout of it
    mean_old = mean.detach() + 0.1 * f(N, A)
    log_std_old = (log_std.detach() + 0.05).expand(N, A).contiguous()
    action = mean_old + torch.exp(log_std_old) * f(N, A)
    z = (action - mean_old) * torch.exp(-log_std_old)
    logp_old = -0.5 * (z * z + np.log(2 * np.pi)).sum(-1) - log_std_old.sum(-1)
    rest = (action, logp_old, mean_old, log_std_old, f(N), f(N), value.detach() + 0.1 * f(N))
    _check_loss_kernels((mean.detach(), log_std.detach(), value.detach(), *rest),
                        torch.ones((), device=cuda_device))
    loss, _ = plk.fused_clip_loss(mean, log_std, value, *rest, clip_eps=0.2, value_coef=0.5,
                                  entropy_coef=0.01)
    loss.backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in net.parameters())


def test_fused_autograd_on_card_matches_cpu(cuda_device):
    batch = _loss_batch(512, 6, "cpu", False)

    def run(dev):
        t = [x.to(dev) for x in batch]
        leaves = [x.requires_grad_() for x in t[:3]]
        loss, metrics = plk.fused_clip_loss(*leaves, *t[3:], clip_eps=0.2, value_coef=0.5,
                                            entropy_coef=0.01)
        grads = torch.autograd.grad(loss, leaves)
        return [loss.cpu(), *(m.cpu() for m in metrics.values()), *(g.cpu() for g in grads)]

    before = (plk.FWD.launches, plk.BWD.launches)
    on_card = run(cuda_device)
    assert (plk.FWD.launches, plk.BWD.launches) == (before[0] + 1, before[1] + 1)
    for a, b in zip(on_card, run("cpu")):
        assert (a - b).abs().max().item() <= 1e-5


def test_fused_loss_is_one_kernel_each_way(cuda_device):
    """torch.profiler sees exactly one device kernel in a forward of
    fused_clip_loss and one in its backward: no torch op runs around them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = _loss_batch(4096, 6, cuda_device, False)
    leaves = [x.requires_grad_() for x in batch[:3]]
    g = torch.ones((), device=cuda_device)

    def forward():
        return plk.fused_clip_loss(*leaves, *batch[3:], clip_eps=0.2, value_coef=0.5,
                                   entropy_coef=0.01)

    torch.autograd.grad(forward()[0], leaves, g)  # warm-up: build and load
    torch.cuda.synchronize()
    counts = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loss, metrics = forward()
        torch.cuda.synchronize()
    counts.append([e.name for e in prof.events() if e.device_type == DeviceType.CUDA])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(loss, leaves, g)
        torch.cuda.synchronize()
    counts.append([e.name for e in prof.events() if e.device_type == DeviceType.CUDA])
    assert len(counts[0]) == 1 and "ppo_loss_fwd" in counts[0][0], counts
    assert len(counts[1]) == 1 and "ppo_loss_bwd" in counts[1][0], counts


def test_kernel_rejects_mixed_devices(cuda_device):
    batch = list(_loss_batch(256, 6, cuda_device, False))
    batch[3] = batch[3].cpu()
    with pytest.raises(ValueError):
        plk.loss_fwd(*batch, *COEFS)


def test_ppo_lstm_update_launches_gae_kernel_once(cuda_device):
    """The recurrent path's GAE takes the reference's default on the card,
    the torch scan (`backend="xla"`), as the reference's ppo_lstm does: the
    kernel is launched by `backend="pallas"` only, so an update on the card
    launches it no time, whatever the epochs and minibatches."""
    from surreal_tpu_torch.algos import ppo, ppo_lstm
    from surreal_tpu_torch.models.actor_critic import PPOActorCritic

    T, B, H = 16, 8, 16
    cfg = ppo.PPOConfig(horizon=T, epochs=2, num_minibatches=2)
    g = torch.Generator().manual_seed(0)
    net = PPOActorCritic(17, 6, (32, 32), use_lstm=True, lstm_size=H, generator=g).to(cuda_device)
    state = ppo.init_state(cfg, net, 17)
    f = lambda *s: torch.randn(*s, generator=g).to(cuda_device)  # noqa: E731
    traj = ppo_lstm.LSTMTrajectory(
        obs=f(T, B, 17), action=f(T, B, 6), log_prob=f(T, B) - 8, mean=f(T, B, 6),
        log_std=torch.zeros(T, B, 6, device=cuda_device), value=f(T, B), next_value=f(T, B),
        reward=f(T, B), discount=torch.ones(T, B, device=cuda_device),
        done=(torch.rand(T, B, generator=g) < 0.1).to(cuda_device),
        init_carry=(0.1 * f(B, H), 0.1 * f(B, H)))
    before = gae_kernel.GAE.launches
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    state, metrics = ppo_lstm.update(cfg, state, traj, gen)
    assert gae_kernel.GAE.launches == before
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert state.opt_state.count == 4


@pytest.mark.parametrize("capacity_t,chunk_lens", [(8, [5, 5]), (8, [3] * 7), (6, [2, 6])])
def test_replay_on_card_matches_cpu(cuda_device, capacity_t, chunk_lens):
    """Insert with wraparound and the n-step gather on the card against the
    CPU, from the same chunks and the same indices: exact, both move data
    only."""
    from surreal_tpu_torch.data import replay

    g = torch.Generator().manual_seed(capacity_t)
    B = 4
    rings = {d: replay.replay_init({"obs": torch.zeros(B, 3, device=d),
                                    "done": torch.zeros(B, dtype=torch.bool, device=d)},
                                   capacity_t) for d in ("cpu", cuda_device)}
    for T in chunk_lens:
        chunk = {"obs": torch.randn(T, B, 3, generator=g),
                 "done": torch.rand(T, B, generator=g) < 0.3}
        rings = {d: replay.replay_insert(r, {k: v.to(d) for k, v in chunk.items()})
                 for d, r in rings.items()}
    cpu, card = rings["cpu"], rings[cuda_device]
    assert cpu.total == card.total == sum(chunk_lens)
    for k in cpu.data:
        assert torch.equal(cpu.data[k], card.data[k].cpu())
    oldest = max(cpu.total - capacity_t, 0)
    a = oldest + torch.randint(0, cpu.total - 4 + 1 - oldest, (64,), generator=g)
    b = torch.randint(0, B, (64,), generator=g)
    w_cpu = replay.replay_sample_nstep(cpu, None, 64, 3, index=(a, b))
    w_card = replay.replay_sample_nstep(card, None, 64, 3,
                                        index=(a.to(cuda_device), b.to(cuda_device)))
    for k in w_cpu:
        assert w_card[k].shape == (4, 64) + cpu.data[k].shape[2:]
        assert torch.equal(w_cpu[k], w_card[k].cpu())
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    own = replay.replay_sample_nstep(card, gen, 64, 3)
    assert own["obs"].device.type == "cuda" and own["obs"].shape == (4, 64, 3)
