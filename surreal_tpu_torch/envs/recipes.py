"""Per-task training recipes: the shipped defaults that reproduce results/
(the port's own copy of surreal_tpu/envs/recipes.py, held equal to it by
tests/test_torch_config.py).

Each entry is the recorded winning recipe for one (env, algo[, pixel])
triple, with the results/ file that produced it and its recorded
deterministic eval mean.

Precedence in `cli.configs.generate_configs`: base config < recipe <
explicit user overrides. Disable with `--session.use_recipe false`.

A recipe's `overrides` uses the same nested {learner, env, session} shape
as CLI overrides. `evidence` is the results file whose header command line
encodes exactly these hyperparameters; `eval_mean` is that file's recorded
deterministic eval.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Recipe:
    overrides: dict
    evidence: str  # results/<file>.txt whose header command matches
    eval_mean: float | None  # recorded EVAL return_mean (None = run pending)
    note: str = ""


def _ppo(steps, num_envs=256, horizon=None, minibatches=None, entropy=None,
         lr=None, sets=(), pixel_overrides=None):
    learner = {}
    if horizon is not None:
        learner["horizon"] = horizon
    if minibatches is not None:
        learner["num_minibatches"] = minibatches
    if entropy is not None:
        learner["entropy_coef"] = entropy
    if lr is not None:
        learner["lr"] = lr
    learner.update(dict(sets))
    env = {"num_envs": num_envs}
    if pixel_overrides:
        env["pixel"] = dict(pixel_overrides)
    return {"learner": learner, "env": env,
            "session": {"total_env_steps": steps}}


def _ddpg(steps, num_envs=128, sets=()):
    return {"learner": dict(sets), "env": {"num_envs": num_envs},
            "session": {"total_env_steps": steps}}


# Keyed by (env_name, algo, pixel_obs). Recorded-result citations are the
# headers of the evidence files (results/<...>.txt line 1 is the exact
# tools/run_training.py command; EVAL is the recorded deterministic eval).
RECIPES: dict[tuple[str, str, bool], Recipe] = {
    ("cheetah-run", "ppo", False): Recipe(
        _ppo(15_000_000, 256),
        "results/cheetah_ppo_r4.txt", 784.5,
        "defaults; seed-stable (±9.8)"),
    ("walker-stand", "ppo", False): Recipe(
        _ppo(40_000_000, 128, horizon=256, minibatches=16, entropy=0.005),
        "results/walker_stand_fixed_ppo_r4.txt", 971.9,
        "horizon-256 recipe (h128 probe plateaued at 314)"),
    ("walker-walk", "ppo", False): Recipe(
        _ppo(80_000_000, 128, horizon=256, minibatches=16, entropy=0.005),
        "results/walker_walk_long_ppo_r4.txt", 824.2,
        "3 seeds: det 824/733/928 (stoch 844/799/957 - seed 2 solves "
        "outright). Walk-or-fall episode bimodality on 2/3 seeds survives "
        "mb8 (681), entropy-anneal (676) and LSTM (738) probes; DDPG is "
        "the robustly-solved path (934.5 +- 15 @ 6M)"),
    ("walker-run", "ppo", False): Recipe(
        _ppo(40_000_000, 128, horizon=256, minibatches=16, entropy=0.005),
        "results/walker_run_ppo_r4.txt", 502.1),
    ("hopper-stand", "ppo", False): Recipe(
        _ppo(50_000_000, 128, entropy=0.01),
        "results/hopper_stand_ent01_50m_s0_r5.txt", 753.1,
        "entropy 0.01 kills the seed lottery (defaults: 5.9-901 across "
        "seeds): 753.1/926.6/770.4 on seeds 0/1/2, mean 816.7, no "
        "collapses. Probed and rejected: h256 (351 bimodal), mb4 (503), "
        "h64 (collapses, 4.3), entropy anneal 0.01->0.002 (498 bimodal "
        "on seed 0 - the late low-entropy phase re-opens the collapse)"),
    ("finger-spin", "ppo", False): Recipe(
        _ppo(100_000_000, 128, minibatches=4, entropy=0.005,
             sets=[("lr_max_scale", 2.0), ("hidden", [64, 64])]),
        "results/finger_spin_h64_s0_r5.txt", 932.7,
        "8 seeds: 933/922/924/875/393/406/864/325 (median 870, 5/8 >= "
        "864). The slow-spin attractor family (~325-406 threshold-riding "
        "plateaus, each converged with sigma <= 11; results/"
        "diag_spin_basin_r5.txt) claims ~3-in-8 seeds; the (256,256) net "
        "lands in it on 2/3 seeds. Entropy does NOT remove it, it "
        "re-deals the lottery: at ent 0.01 seeds 0-3 ALL land ~400 while "
        "seed 4 gets 965 (results/finger_spin_h64_ent01_s{0..4}_r5.txt) "
        "- ent 0.005 has the best hit rate of everything probed "
        "(mb2/mb8/anneal recorded)"),
    ("finger-turn_hard", "ppo", False): Recipe(
        _ppo(100_000_000, 128, horizon=256, minibatches=16, entropy=0.005,
             sets=[("lr_max_scale", 2.0)]),
        "results/finger_turn_hard_h256_r4.txt", 862.8,
        "h256 breaks the r3 ~560 plateau; stoch eval 921.9. r5 extra "
        "seeds: 774.7 (stoch 876.9) / 512.9 - the turn-family "
        "commit-or-hold episode lottery (see finger-turn_easy) applies "
        "here too on 2/3 seeds"),
    ("finger-turn_easy", "ppo", False): Recipe(
        _ppo(100_000_000, 128, minibatches=4, entropy=0.005,
             sets=[("lr_max_scale", 2.0), ("hidden", [64, 64])]),
        "results/finger_turn_easy_h64_s1_r5.txt", 908.7,
        "best recipe found; seed spread 566/909/551/520 (mean 637 vs the "
        "r3 recipe's 594). The zero episodes are a commit-or-hold policy "
        "that freezes on targets born >= 85 deg away (diagnosed from eval "
        "traces, results/diag_turn_easy_r5.txt; env parity verified both "
        "directions). 250M extension grinds seed 0 to 658 (still "
        "bimodal); ent 0.01/h256/mb probes recorded as falsifications"),
    ("cartpole-balance", "ppo", False): Recipe(
        _ppo(4_000_000, 256, entropy=0.01),
        "results/cartpole_balance_ppo_r5.txt", 970.6, "±0.6 — solved"),
    ("cartpole-balance_sparse", "ppo", False): Recipe(
        _ppo(8_000_000, 256, entropy=0.01),
        "results/cartpole_balance_sparse_ppo_r4.txt", 1000.0, "SOLVED"),
    ("cartpole-swingup", "ppo", False): Recipe(
        _ppo(30_000_000, 256, sets=[("lr_max_scale", 1.0), ("lr_min_scale", 1.0),
                                    ("adapt_lr", False)]),
        "results/cartpole_swingup_flat_lr_ppo_r4.txt", 846.7,
        "LR adaptation must be OFF here (ON required for swingup_sparse)"),
    ("cartpole-swingup_sparse", "ppo", False): Recipe(
        _ppo(40_000_000, 256, horizon=256, minibatches=16, entropy=0.01),
        "results/cartpole_swingup_sparse_h256_r4.txt", 664.0,
        "h256 + adaptive LR required (flat-LR variant scores 0)"),
    ("cartpole-two_poles", "ppo", False): Recipe(
        _ppo(50_000_000, 256, horizon=256, minibatches=16, entropy=0.01),
        "results/cartpole_two_poles_ent01_r4.txt", 280.5,
        "honest plateau; unsolved by published model-free baselines too"),
    ("cartpole-three_poles", "ppo", False): Recipe(
        _ppo(25_000_000, 256, entropy=0.003),
        "results/cartpole_three_poles_ppo_r4.txt", 142.9),
    ("pendulum-swingup", "ppo", False): Recipe(
        _ppo(12_000_000, 256, entropy=0.01),
        "results/pendulum_ent_ppo_r4.txt", 661.0),
    ("acrobot-swingup", "ppo", False): Recipe(
        _ppo(25_000_000, 256, entropy=0.003),
        "results/acrobot_swingup_ppo_r4.txt", 21.8,
        "published dm_control baselines are also ~tens"),
    ("acrobot-swingup_sparse", "ppo", False): Recipe(
        _ppo(25_000_000, 256, entropy=0.01),
        "results/acrobot_swingup_sparse_ppo_r4.txt", 3.4),
    ("reacher-easy", "ppo", False): Recipe(
        _ppo(10_000_000, 256, entropy=0.003),
        "results/reacher_easy_ppo_r3.txt", 822.9),
    ("reacher-hard", "ppo", False): Recipe(
        _ppo(10_000_000, 256, entropy=0.003),
        "results/reacher_hard_ppo_r4.txt", 732.3),
    ("point_mass-easy", "ppo", False): Recipe(
        _ppo(8_000_000, 256, entropy=0.01, sets=[("lr_max_scale", 2.0)]),
        "results/point_mass_ppo_r3.txt", 670.8),
    ("swimmer-swimmer6", "ppo", False): Recipe(
        _ppo(50_000_000, 256, entropy=0.003, sets=[("lr_max_scale", 2.0)]),
        "results/swimmer6_long_fixed_ppo_r4.txt", 624.7),
    ("swimmer-swimmer15", "ppo", False): Recipe(
        _ppo(40_000_000, 256),
        "results/swimmer15_fixed_ppo_r4.txt", 508.3,
        "defaults beat the swimmer6 recipe here (4.4 with ent 0.003/lrx2)"),
    ("manipulator-bring_ball", "ppo", False): Recipe(
        _ppo(8_000_000, 128, entropy=0.005),
        "results/manipulator_ppo_r3.txt", 0.57,
        "published A3C/DDPG baselines also ≈0; r5 final-engine re-run pending"),
    ("manipulator-bring_peg", "ppo", False): Recipe(
        _ppo(8_000_000, 128, entropy=0.005),
        "results/manipulator_peg_ppo_r3.txt", 17.1,
        "r5 final-engine re-run pending"),
    # ---- DDPG ----
    ("walker-walk", "ddpg", False): Recipe(
        _ddpg(6_000_000, 256),
        "results/walker_ddpg_r4.txt", 934.5),
    ("ball_in_cup-catch", "ddpg", False): Recipe(
        _ddpg(3_000_000, 128),
        "results/ball_in_cup_ddpg_s1_r4.txt", 963.8),
    ("cheetah-run", "ddpg", False): Recipe(
        _ddpg(6_000_000, 256),
        "results/cheetah_ddpg_r3.txt", 389.3,
        "TD3 knobs measured worse here (203) — results/cheetah_ddpg_td3_r4.txt"),
    ("pendulum-swingup", "ddpg", False): Recipe(
        _ddpg(3_000_000, 128),
        "results/pendulum_ddpg_r3.txt", 119.2),
    ("manipulator-bring_ball", "ddpg", False): Recipe(
        _ddpg(4_000_000, 128),
        "results/manipulator_ddpg_r3.txt", 0.59),
    # ---- pixels (PixelWrapper; BASELINE config 4) ----
    ("cheetah-run", "ppo", True): Recipe(
        _ppo(20_000_000, 128, entropy=0.003, lr=1e-4,
             sets=[("lr_max_scale", 2.0)]),
        "results/cheetah_pixel_ppo_r2.txt", 821.9,
        "beats the state-based 784; 20M decision steps = 80M env-steps (AR 4)"),
    ("ball_in_cup-catch", "ppo", True): Recipe(
        _ppo(60_000_000, 128, entropy=0.01, lr=1e-4,
             sets=[("lr_max_scale", 4.0)],
             pixel_overrides={"action_repeat": 2}),
        "results/ball_in_cup_pixel_ppo_long_r4.txt", 778.0,
        "stoch eval 911.5"),
}


def get_recipe(env_name: str | None, algo: str, pixel: bool = False):
    """Recipe for (env, algo, pixel) or None. Accepts 'dm_control:' prefixes."""
    if not env_name:
        return None
    key = str(env_name).split(":", 1)[-1]
    return RECIPES.get((key, algo, bool(pixel)))
