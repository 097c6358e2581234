"""The port's configuration schema is its own copy of the JAX package's
(``live_ekf_slam_tpu_torch/config.py``): held here field for field against
``live_ekf_slam_tpu/config.py``, so the two cannot drift."""

import dataclasses

import pytest
import yaml

from live_ekf_slam_tpu import config as jconfig
from live_ekf_slam_tpu_torch import config as tconfig


def _schema(mod) -> dict:
    """Every dataclass of a config module: its fields and their defaults."""
    def default(f):
        v = f.default
        return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v

    return {name: [(f.name, f.type, default(f)) for f in dataclasses.fields(obj)]
            for name, obj in vars(mod).items()
            if isinstance(obj, type) and dataclasses.is_dataclass(obj)}


def test_schema_classes_and_fields_equal():
    assert _schema(tconfig) == _schema(jconfig)
    assert sorted(tconfig._PRESETS) == sorted(jconfig._PRESETS)


@pytest.mark.parametrize("name", ["defaults", "compat_all_on"]
                         + sorted(jconfig._PRESETS))
def test_config_trees_equal(name):
    if name == "defaults":
        got, want = tconfig.Config(), jconfig.Config()
    elif name == "compat_all_on":
        got = tconfig.Config(compat=tconfig.CompatConfig.all_on())
        want = jconfig.Config(compat=jconfig.CompatConfig.all_on())
        assert all(dataclasses.asdict(got.compat).values())
    else:
        got, want = tconfig.preset(name), jconfig.preset(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.state_dim == want.state_dim
    assert got.filter_noise() == want.filter_noise()
    assert (got.grid_shift, got.grid_scale) == (want.grid_shift, want.grid_scale)


def test_load_config_round_trips(tmp_path):
    params = {
        "filter": "ukf_slam", "dt": 0.01, "num_iterations": 300,
        "init_pose": {"x": 1.0, "y": -2.0, "yaw": 0.5},
        "constraints": {"vision": {"range_max": 4.0}},
        "process_noise": {"cov": {"V_00": 0.02}},
        "sensing_noise": {"mean": {"w_b": 0.01}},
        "ukf": {"W_0": 0.3},
        "map": {"num_landmarks": 12, "bound": 8.0},
    }
    path = tmp_path / "params.yaml"
    path.write_text(yaml.safe_dump(params))
    got = tconfig.load_config(str(path), sim_noise_scale=0.5)
    want = jconfig.load_config(str(path), sim_noise_scale=0.5)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.filter, got.num_landmark_slots, got.ukf.W_0) == ("ukf_slam", 12, 0.3)
    assert got.replace(filter="ekf_slam").filter == "ekf_slam"
    with pytest.raises(ValueError, match="Unknown preset"):
        tconfig.preset("nope")
