"""The port's config engine against ``deflow_tpu.config``.

Over the same overrides, the port's ``compose`` and ``from_cli`` give the
same ``to_dict()`` as the JAX package's engine reading the port's own
``conf/``, and the same as the JAX package's ``conf/`` but for the keys the
port's copy changes: ``device`` (added) and ``model.target._target_`` (the
port's model class).  Both resolve ``${...}`` interpolation and parse
an override ``2e-4`` as a float.
"""

import pytest

from deflow_tpu import config as jax_config
from deflow_tpu_torch import config

OVERRIDES = [
    [],
    ["model=fastflow3d", "voxel_size=[0.1, 0.1, 6]"],
    ["model=deflow", "model.target.num_iters=2", "lr=2e-4", "gradient_clip=1e-3"],
    ["dataset_path=/data/av2", "batch_size=8", "checkpoint=null", "save_res=true",
     "+extra.nested=3", "output_dir=runs/out", "device=cpu"],
    ["model.target.grid_feature_size=[64, 64]", "precision=fp32",
     "res_name=", "av2_mode=test", "+tag=${output_dir}/x"],
]


def _as_jax_conf(d):
    d = dict(d)
    assert d.pop("device") in (None, "cpu")
    target = d["model"]["target"]
    assert target["_target_"] == "deflow_tpu_torch.models.DeFlow"
    d["model"] = dict(d["model"], target=dict(target,
                                              _target_="deflow_tpu.models.DeFlow"))
    return d


@pytest.mark.parametrize("overrides", OVERRIDES)
def test_compose_matches_jax(overrides):
    got = config.compose("config", overrides).to_dict()
    assert got == jax_config.compose("config", overrides,
                                     config_dir=config._CONF_DIR).to_dict()
    jax_overrides = [o for o in overrides if not o.startswith("device=")]
    assert _as_jax_conf(got) == jax_config.compose("config", jax_overrides).to_dict()
    assert got["val_data"] == got["dataset_path"] + "/val"
    assert got["output_zip_dir"] == got["output_dir"] + "/submissions"
    assert got["model"]["target"]["voxel_size"] == got["voxel_size"]
    # YAML 1.1 reads the file's `lr: 2e-4` as a string, in both engines;
    # an override parses as a float
    assert isinstance(got["lr"], float) == any(o.startswith("lr=") for o in overrides)


def test_from_cli_matches_jax():
    argv = ["model.target.num_iters=2", "lr=1e-3", "voxel_size=[3.2,3.2,6]",
            "num_workers=4"]
    got = config.from_cli(argv)
    assert _as_jax_conf(got.to_dict()) == jax_config.from_cli(argv).to_dict()
    assert got.lr == 1e-3
    assert got.model.target.num_iters == 2 and got["num_workers"] == 4
    assert got.copy() == got and got.select("model.target.voxel_size") == [3.2, 3.2, 6]


@pytest.mark.parametrize("text", ["2e-4", "1E3", "-3", "0.5", "[1, 2.5, 6]", "true",
                                  "null", "None", "abc", "", "{a: 1}", "${x}"])
def test_parse_value_matches_jax(text):
    got, want = config.parse_value(text), jax_config.parse_value(text)
    assert got == want and type(got) is type(want)


@pytest.mark.parametrize("overrides,match", [
    (["no_such_key=1"], "unknown config key"),
    (["model=no_such_model"], "unknown model config"),
    (["+a=${b}", "+b=${a}"], "interpolation cycle"),
    (["noequals"], "must be key=value"),
])
def test_errors_match_jax(overrides, match):
    for engine in (config, jax_config):
        with pytest.raises(engine.ConfigError, match=match):
            engine.compose("config", overrides,
                           config_dir=config._CONF_DIR if engine is jax_config else None)
