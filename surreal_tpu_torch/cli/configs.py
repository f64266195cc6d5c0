"""Per-algorithm config generators (port of surreal_tpu/cli/configs.py):
a three-part Config triple (learner / env / session) with
required-placeholder validation, overridable from the CLI by dotted keys.
The BASE_* configs are the reference's, key for key, so `config.json`
reads the same from either CLI.
"""

from __future__ import annotations

from surreal_tpu_torch.config import Config, REQUIRED, extend_config

BASE_ENV_CONFIG = Config(
    env_name=REQUIRED("e.g. cheetah-run"),
    num_envs=256,
    pixel_obs=False,
    # PixelWrapper knobs (used when pixel_obs=True)
    pixel=Config(height=84, width=84, frame_stack=3, grayscale=True,
                 keep_low_dim=False, action_repeat=4),
)

BASE_SESSION_CONFIG = Config(
    experiment_name="exp",
    results_dir="results",
    # Apply the per-task recipe defaults (envs/recipes.py) for the chosen
    # (env, algo): the reference ships its working hyperparameters the same
    # way (ppo_configs.py/ddpg_configs.py). `--session.use_recipe false`
    # reverts to the bare base config.
    use_recipe=True,
    seed=0,
    total_env_steps=5_000_000,
    eval_every_steps=500_000,
    eval_episodes=16,
    checkpoint_every_steps=1_000_000,
    keep_latest_checkpoints=3,
    # 'auto': resume from the latest checkpoint if one exists; 'true':
    # require one; 'false': always start fresh.
    restore="auto",
    tensorboard=True,
    log_every_iterations=20,
    # eval-worker video recording (reference's video_env): one GIF per eval
    video=False,
    video_steps=400,
    # parallel layout (SURVEY.md §2D/E): data-parallel shards etc.
    mesh=Config(data=None, model=1, time=1),
    multihost=Config(coordinator=None, num_processes=None, process_id=None),
)

PPO_BASE_LEARNER_CONFIG = Config(
    algo="ppo",
    horizon=128,
    gamma=0.99,
    lam=0.95,
    clip_eps=0.2,
    epochs=4,
    num_minibatches=8,
    lr=3e-4,
    entropy_coef=0.0,
    value_coef=0.5,
    max_grad_norm=0.5,
    normalize_adv=True,
    use_zfilter=True,
    objective="clip",
    kl_target=0.01,
    adapt_lr=True,
    lr_adapt_factor=1.5,
    lr_min_scale=0.01,
    lr_max_scale=10.0,
    kl_beta_init=1.0,
    fused_loss=False,
    overlap=False,  # double-buffered rollout(k)/train(k-1) overlap
    publish_every=1,  # actor param staleness (reference's pub-sub lag)
    zero_optimizer=False,  # shard Adam moments over the data axis (ZeRO-1)
    use_lstm=False,
    lstm_size=128,
    hidden=[256, 256],
    compute_dtype="float32",
)

DDPG_BASE_LEARNER_CONFIG = Config(
    algo="ddpg",
    rollout_steps=16,
    updates_per_iteration=16,
    batch_size=256,
    replay_capacity=1_000_000,
    min_replay=10_000,
    gamma=0.99,
    n_step=3,
    actor_lr=1e-4,
    critic_lr=1e-3,
    tau=5e-3,
    hard_sync_every=0,
    target_noise=0.0,  # TD3 target-policy smoothing std (0 = plain DDPG)
    target_noise_clip=0.5,
    actor_delay=1,  # TD3 delayed actor/target updates (1 = plain DDPG)
    shared_encoder=False,  # pixel mode: one conv stem, critic-trained (SAC-AE)
    aug_shift=0,  # pixel mode: DrQ random-shift augmentation radius (px)
    use_zfilter=False,
    noise_type="ou",
    sigma_min=0.05,
    sigma_max=0.4,
    publish_every=1,  # actor param staleness (reference's pub-sub lag)
    zero_optimizer=False,  # shard Adam moments over the data axis (ZeRO-1)
    actor_hidden=[300, 200],
    critic_hidden=[400, 300],
    compute_dtype="float32",
)


def generate_configs(algo: str, overrides: dict | None = None):
    """-> (learner_config, env_config, session_config), validated.

    Precedence: base config < per-task recipe (envs/recipes.py, keyed by
    the requested env/algo/pixel) < explicit user overrides — so the CLI
    reproduces the recorded results/ numbers out of the box while any
    user-specified flag still wins.
    """
    overrides = Config(overrides or {})
    base_learner = {
        "ppo": PPO_BASE_LEARNER_CONFIG,
        "ddpg": DDPG_BASE_LEARNER_CONFIG,
    }[algo]
    base_env, base_session = BASE_ENV_CONFIG, BASE_SESSION_CONFIG

    env_over = Config(overrides.get("env") or {})
    sess_over = Config(overrides.get("session") or {})
    if bool(sess_over.get("use_recipe", True)):
        from surreal_tpu_torch.envs.recipes import get_recipe

        recipe = get_recipe(env_over.get("env_name"), algo,
                            pixel=bool(env_over.get("pixel_obs", False)))
        if recipe is not None:
            env_layer = dict(recipe.overrides.get("env") or {})
            # fill the REQUIRED placeholder so the mid-merge validates
            env_layer.setdefault("env_name", env_over.get("env_name"))
            base_learner = extend_config(recipe.overrides.get("learner"), base_learner)
            base_env = extend_config(env_layer, base_env)
            base_session = extend_config(recipe.overrides.get("session"), base_session)

    learner = extend_config(overrides.get("learner"), base_learner)
    env = extend_config(overrides.get("env"), base_env)
    session = extend_config(overrides.get("session"), base_session)
    return learner, env, session


def to_algo_config(learner: Config):
    """Config -> the port's typed dataclass consumed by the algorithm, from
    the same keys as the reference's."""
    if learner.algo == "ppo":
        from surreal_tpu_torch.algos.ppo import PPOConfig

        keys = [
            "horizon", "gamma", "lam", "clip_eps", "epochs", "num_minibatches",
            "lr", "entropy_coef", "value_coef", "max_grad_norm", "normalize_adv",
            "use_zfilter", "objective", "kl_target", "adapt_lr",
            "lr_adapt_factor", "lr_min_scale", "lr_max_scale", "kl_beta_init",
            "fused_loss", "publish_every", "zero_optimizer",
        ]
        return PPOConfig(**{k: learner[k] for k in keys})
    elif learner.algo == "ddpg":
        from surreal_tpu_torch.algos.ddpg import DDPGConfig

        keys = [
            "rollout_steps", "updates_per_iteration", "batch_size",
            "replay_capacity", "min_replay", "gamma", "n_step", "actor_lr",
            "critic_lr", "tau", "hard_sync_every", "target_noise",
            "target_noise_clip", "actor_delay", "shared_encoder", "aug_shift",
            "use_zfilter", "noise_type",
            "sigma_min", "sigma_max", "publish_every", "zero_optimizer",
        ]
        return DDPGConfig(**{k: learner[k] for k in keys})
    raise ValueError(f"unknown algo {learner.algo!r}")
