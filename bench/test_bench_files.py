"""Every file the benchmark finds by name loads, and the manifest keeps
to the benchmark's contract."""
import json
import re

import pytest

from bench import manifest as mf

MAN = mf.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_manifest_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["bench"]
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((mf.REPO / "BENCHMARK.json").read_bytes()) <= 64 << 10
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    assert len(CELLS) == len(set(CELLS))
    assert "setup_s" in names


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_config_file_loads(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and cfg["file"].startswith("bench/")
    data = mf.config(cfg["name"])
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"] == []
    h, w, c = data["image_shape"]
    assert h % data["proxy_factor"] == 0 and w % data["proxy_factor"] == 0
    lim = data["limits"]
    assert set(lim) == {"gap_median", "image_tol", "off_share"}
    assert 0 < lim["gap_median"] < lim["image_tol"] < 1
    assert 0 < lim["off_share"] < 1
    assert data.get("host_threads") is None or data["host_threads"] >= 1
    assert set(data["golddiff"]) == {"m_min_frac", "m_max_frac",
                                     "k_min_frac", "k_max_frac"}


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_names_its_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    mf.config(cell["config"])
    mix = mf.traffic(cell["traffic"])
    assert mix["name"] == cell["traffic"] and mix["loop"] == "closed"
    assert max(mix["images_per_request"]) <= mix["max_batch"]
    for m in METRICS:
        if "workloads" in m:
            assert set(m["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_has_a_reader(metric):
    allowed = {"name", "unit", "better", "bound", "source", "workloads"}
    if metric in MAN["per_layer"]:
        allowed = {"name", "unit", "better", "source", "layer", "moves",
                   "workloads"}
        assert metric["moves"] in {m["name"] for m in MAN["end_to_end"]}
    else:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in {"host_clock", "device_trace"}
    assert set(metric) <= allowed
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    assert callable(mf.reader(metric["name"]))


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_where_read(metric):
    for cell in metric.get("workloads", CELLS):
        reported = {m["name"] for m in mf.metrics_for(cell, False, MAN)}
        assert metric["moves"] in reported, cell


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_enough(cell):
    e2e = {m["name"] for m in mf.metrics_for(cell, False, MAN)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert mf.metrics_for(cell, True, MAN)


@pytest.mark.parametrize("path", sorted((mf.BENCH / "kernels").glob(
    "*.json")), ids=lambda p: p.stem)
def test_kernel_file_names_a_stage(path):
    assert NAME.match(path.stem)
    assert json.loads(path.read_text())["stage"] in ("select", "aggregate",
                                                     "previous")


def test_previous_takes_the_launching_stage():
    from bench.timing import event_stages
    stages = {"sqdist_mark": "select", "sagg_mark": "aggregate",
              "union_count": "previous"}
    ev = [(n, float(i), i + 0.5) for i, n in enumerate(
        ["union_count", "void sqdist_mark<4>(float*)", "memset32",
         "union_count", "sagg_mark", "union_count"])]
    assert event_stages(ev, stages) == [None, "select", None, "select",
                                        "aggregate", "aggregate"]


def test_traffic_cycles_sizes_by_seed():
    mix = dict(mf.traffic("b16"), images_per_request=[1, 2, 4, 4])
    a, b = mf.Traffic(mix, 2 ** 31 + 5), mf.Traffic(mix, 7)
    sa = [a.next_group()[0] for _ in range(8)]
    sb = [b.next_group()[0] for _ in range(8)]
    assert sorted(r[1] for r in sa) == sorted(r[1] for r in sb)
    assert [r[0] for r in sa] == list(range(8))
    assert sa == [mf.Traffic(mix, 2 ** 31 + 5).next_group()[0]
                  for _ in range(1)] + sa[1:]
    assert len({r[2] for r in sa}) == 8
    warm = a.warmup_requests()
    assert sorted({r[1] for r in warm}) == [1, 2, 4]
    assert not {r[2] for r in warm} & {r[2] for r in sa}
