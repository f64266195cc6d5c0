"""The port's config layer against the reference's: `Config`,
`extend_config` and `set_dotted` on the reference's own cases
(tests/test_config.py), the recipes, `generate_configs` for every recipe,
`to_algo_config`, and the CLI's override parser. Configs only: nothing is
trained and nothing is compiled."""

import dataclasses

import pytest

from surreal_tpu import config as jconfig
from surreal_tpu.cli import configs as jconfigs
from surreal_tpu.cli import main as jmain
from surreal_tpu.envs import recipes as jrecipes
from surreal_tpu_torch import config as tconfig
from surreal_tpu_torch.cli import configs as tconfigs
from surreal_tpu_torch.cli import main as tmain
from surreal_tpu_torch.envs import recipes as trecipes

BOTH = pytest.mark.parametrize("cfg", [jconfig, tconfig], ids=["reference", "port"])


@BOTH
def test_attr_access(cfg):
    c = cfg.Config({"a": 1, "b": {"c": 2}})
    assert c.a == 1
    assert c.b.c == 2
    c.b.d = 3
    assert c["b"]["d"] == 3


@BOTH
def test_extend_config_merges_and_validates(cfg):
    base = cfg.Config(lr=1e-3, net={"hidden": [64, 64], "act": "tanh"},
                      env=cfg.REQUIRED("env name"))
    out = cfg.extend_config({"net": {"act": "relu"}, "env": "cheetah-run"}, base)
    assert out.to_dict() == {"lr": 1e-3, "net": {"hidden": [64, 64], "act": "relu"},
                             "env": "cheetah-run"}


@pytest.mark.parametrize("user,base,match", [
    ({}, lambda c: c.Config(env=c.REQUIRED("env name")), "required"),
    ({"typo": 1}, lambda c: c.Config(lr=1e-3), "Unknown config key"),
    ({"net": 3}, lambda c: c.Config(net={"a": 1}), "expects a nested section"),
], ids=["missing_required", "unknown_key", "scalar_for_section"])
def test_extend_config_errors_match(user, base, match):
    msgs = []
    for cfg in (jconfig, tconfig):
        with pytest.raises(cfg.ConfigError, match=match) as e:
            cfg.extend_config(user, base(cfg))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("value", ["3e-4", "7", "true", "False", "none", "[1, 2]",
                                   '{"a": 1}', "[bad", "relu"])
def test_set_dotted_parses_like_the_reference(value):
    out = []
    for cfg in (jconfig, tconfig):
        c = cfg.Config(algo={"lr": 1e-3})
        c.set_dotted("algo.lr", value)
        c.set_dotted("new.deep.key", value)
        out.append(c.to_dict())
        assert cfg.Config.loads(c.dumps()).to_dict() == c.to_dict()
    assert out[0] == out[1]


def test_recipes_equal_the_reference():
    assert list(trecipes.RECIPES) == list(jrecipes.RECIPES)
    for key, rec in jrecipes.RECIPES.items():
        assert dataclasses.asdict(trecipes.RECIPES[key]) == dataclasses.asdict(rec), key
    assert [f.name for f in dataclasses.fields(trecipes.Recipe)] == \
        [f.name for f in dataclasses.fields(jrecipes.Recipe)]
    for name in ("cheetah-run", "dm_control:walker-walk", None, "nope"):
        for algo in ("ppo", "ddpg"):
            want = jrecipes.get_recipe(name, algo)
            got = trecipes.get_recipe(name, algo)
            assert (got is None and want is None) or \
                dataclasses.asdict(got) == dataclasses.asdict(want)


def _both(algo, overrides):
    return [tuple(c.to_dict() for c in mod.generate_configs(algo, overrides))
            for mod in (jconfigs, tconfigs)]


@pytest.mark.parametrize("key", list(jrecipes.RECIPES), ids=lambda k: "-".join(map(str, k)))
def test_generate_configs_equal_for_every_recipe(key):
    env, algo, pixel = key
    ref, port = _both(algo, {"env": {"env_name": env, "pixel_obs": pixel}})
    assert port == ref
    assert port[2]["total_env_steps"] == \
        jrecipes.RECIPES[key].overrides["session"]["total_env_steps"]


@pytest.mark.parametrize("overrides", [
    {"env": {"env_name": "walker-stand"}, "session": {"use_recipe": False}},
    {"env": {"env_name": "walker-stand", "num_envs": 64}, "learner": {"horizon": 32}},
    {"env": {"env_name": "cartpole-balance"}, "learner": {"entropy_coef": 0.0, "lr": 1e-4}},
], ids=["use_recipe_false", "user_beats_recipe", "user_beats_recipe_entropy"])
def test_generate_configs_precedence(overrides):
    ref, port = _both("ppo", overrides)
    assert port == ref


@pytest.mark.parametrize("algo,overrides", [
    ("ppo", {}),  # env_name is required
    ("ddpg", {"env": {"env_name": "x"}, "learner": {"nope": 1}}),
])
def test_generate_configs_errors(algo, overrides):
    with pytest.raises(tconfig.ConfigError):
        tconfigs.generate_configs(algo, overrides)


@pytest.mark.parametrize("algo,env", [("ppo", "cartpole-balance"), ("ppo", "finger-spin"),
                                      ("ddpg", "cheetah-run")])
def test_to_algo_config_equals_the_reference_on_shared_fields(algo, env):
    learner_j = jconfigs.generate_configs(algo, {"env": {"env_name": env}})[0]
    learner_t = tconfigs.generate_configs(algo, {"env": {"env_name": env}})[0]
    ref = dataclasses.asdict(jconfigs.to_algo_config(learner_j))
    port = dataclasses.asdict(tconfigs.to_algo_config(learner_t))
    shared = set(ref) & set(port)
    assert shared == set(ref) and shared == set(port)
    assert {k: port[k] for k in shared} == {k: ref[k] for k in shared}


@pytest.mark.parametrize("argv", [
    ["--learner.lr", "1e-4", "--env.num_envs", "512"],
    ["--learner.lr=1e-4", "--env.env_name=cheetah-run"],
    ["--learner.hidden", "[16,16]", "--learner.fused_loss", "true",
     "--session.use_recipe", "False", "--session.mesh.data", "none"],
    [],
], ids=["space", "equals", "lists_and_booleans", "empty"])
def test_parse_overrides_agrees(argv):
    assert tmain._parse_overrides(argv) == jmain._parse_overrides(argv)


@pytest.mark.parametrize("argv", [["stray"], ["--learner.lr"]])
def test_parse_overrides_rejects_like_the_reference(argv):
    for mod in (jmain, tmain):
        with pytest.raises(SystemExit):
            mod._parse_overrides(argv)
