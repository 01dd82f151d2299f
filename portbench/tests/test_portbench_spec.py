"""Every file ``BENCHMARK.json`` names loads by its name, and a cell, a
configuration, a mix and a metric are added by adding files and entries."""
import json
import shutil

import pytest

from portbench import spec
from portbench.conftest import bench_with_kept

BENCH = spec.benchmark()
KEPT = bench_with_kept()


@pytest.mark.parametrize("cell", [w["name"] for w in KEPT["workloads"]])
def test_cell_files_load(cell):
    """Each cell's files, the kept ML-32M cell's too, load by name."""
    w = spec.workload(KEPT, cell)
    cfg = spec.config(KEPT, w["config"])
    mix = spec.traffic(w["traffic"])
    assert cfg["decoder"]["attn_embed_dim"] > 0 and cfg["source"].startswith("https://")
    assert (spec.HERE / "kinds" / f"{mix['kind']}.py").exists()
    assert spec.limits(cell)
    e2e = {m["name"] for m in spec.end_to_end(KEPT, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.per_layer(KEPT, cell)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_readers_load(metric):
    mod = spec.reader(metric)
    assert mod.read({}) is None   # finds nothing to read: no value, not 0


def test_contract_shape():
    names = [c["name"] for c in BENCH["configs"]]
    assert names == ["decoder_amazon"]
    assert {m["name"] for m in BENCH["end_to_end"]} == {
        "train_examples_per_s", "queries_per_s", "search_p95_ms", "setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for c in BENCH["configs"]:
        assert (spec.ROOT / c["file"]).exists()


def test_added_files_load_by_name(tmp_path):
    """A later change adds a configuration, a mix, a metric and a cell as
    new files and entries only; the harness finds each by its name."""
    base = tmp_path / "portbench"
    shutil.copytree(spec.HERE, base, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((base / "configs" / "decoder_amazon.json").read_text())
    cfg["decoder"]["attn_layers"] = 4
    (base / "configs" / "decoder_new.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic" / "train_amazon.json").read_text())
    mix["batch"] = 128
    (base / "traffic" / "train_new.json").write_text(json.dumps(mix))
    (base / "limits" / "new_train.json").write_text(json.dumps({"limits": {"loss_gap": 1.0}}))
    (base / "metrics" / "steps.train.py").write_text(
        "def read(record):\n    return record.get('window', {}).get('steps')\n")
    bench["configs"].append({"name": "decoder_new", "source": "https://example.org",
                             "file": "portbench/configs/decoder_new.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "new_train", "config": "decoder_new",
                               "traffic": "train_new", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "steps.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "decoder loop",
                               "moves": "train_examples_per_s", "workloads": ["new_train"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "train_examples_per_s":
            m["workloads"].append("new_train")
    assert spec.config(bench, "decoder_new", tmp_path)["decoder"]["attn_layers"] == 4
    assert spec.traffic("train_new", base)["batch"] == 128
    assert spec.limits("new_train", base) == {"loss_gap": 1.0}
    got = spec.read_per_layer(bench, "new_train", {"window": {"steps": 7}}, base)
    assert got["steps.train"] == {"value": 7, "unit": "steps"}
