"""The harness finds every cell's parts by the names in BENCHMARK.json."""

import json

import pytest

from benchmark.lib import cells


SPEC = cells.spec()


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_parts(name):
    c = cells.cell(name)
    assert (cells.ROOT / c["config"]["scene"]).is_file()
    assert c["traffic"]["mode"] in ("mis", "bsdf")
    assert set(c["own"]["limits"]) == {"frame_mismatch_pct", "film_error_pct"}
    names = {m["name"] for m in c["end_to_end"]}
    assert {"msamples_per_s", "setup_s"} <= names
    assert c["per_layer"], "every cell reports a per-layer metric"


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
def test_metric_reader(metric):
    assert callable(cells.reader(metric))


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    data = json.loads((cells.ROOT / config["file"]).read_text())
    assert data["name"] == config["name"] and data["reduced"] == config["reduced"]
    assert data["source"] == config["source"]


def test_unknown_cell():
    with pytest.raises(KeyError):
        cells.cell("no_such_cell.mis")
