"""Every cell of BENCHMARK.json is found from files alone, and the file
keeps to the shape the benchmark's runner reads."""

import json
import re

import hb_cell
import pytest

BENCH = hb_cell.load_json(hb_cell.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", CELLS)
def test_cell_found_from_files(workload):
    cell = hb_cell.find_cell(workload)
    assert cell.config["name"] == workload.split(".")[0]
    mod = hb_cell.plugin("traffic", cell.mix["kind"])
    assert callable(mod.make)
    assert set(cell.limits) >= {"greedy_gap"}
    for group in (False, True):
        for m in hb_cell.metrics_of(workload, group, BENCH):
            reader = hb_cell.plugin("metrics", m["name"])
            assert reader.UNIT == m["unit"]
            assert bool(getattr(reader, "TRACED", False)) == group


def test_each_config_is_its_source_unreduced():
    """The port's registry config equals each config file on every width
    its architecture names, but the keys the file lists as ``reduced``."""
    from repro_torch.configs import get_config
    for c in BENCH["configs"]:
        cfg = hb_cell.load_json(hb_cell.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        widths = hb_cell.arch_of(cfg).port_widths(cfg)
        assert widths and not set(widths) & set(cfg["reduced"])
        port = get_config(c["name"])
        assert {k: getattr(port, a) for k, a in widths.items()} == \
            {k: cfg[k] for k in widths}


def test_benchmark_file_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for g in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[g]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for w in BENCH["workloads"]:
        got = [m["name"] for m in BENCH["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in got and len(got) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024
