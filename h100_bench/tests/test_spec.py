"""BENCHMARK.json against the contract's shapes, and the harness finding
each cell's files by name."""

import json
import os
import re

import pytest

from h100_bench import harness, work
from h100_bench.tests.small import small_cell

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["paths"] == ["h100_bench"]
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_and_units_use_allowed_characters():
    names = [c["name"] for c in SPEC["configs"]] + CELLS + [
        m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    for c in SPEC["configs"]:
        for k in c["reduced"]:
            assert NAME.match(k), k
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in SPEC["configs"]]
                 + [c["source"] for c in SPEC["configs"]]
                 + [w["why"] for w in SPEC["workloads"]]
                 + [m["layer"] for m in SPEC["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metrics_keep_the_contract():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert set(e2e) == {"serve_img_s", "serve_p95_ms", "train_img_s",
                        "setup_s"}
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_resolves_by_name(name):
    cell = harness.Cell(SPEC, name)
    assert cell.chips == 1
    assert cell.config["file" if False else "system"]
    harness.system(cell.config["system"])
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    assert cell.limits


def test_config_files_lie_under_paths():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith("h100_bench/") and os.path.exists(
            os.path.join(os.path.dirname(HERE), f))


def test_an_added_cell_is_found_from_new_files_alone(tmp_path):
    """A new mix, limits and metric as files, a new cell as an entry:
    the harness finds them without an edit to any file it has."""
    added = {os.path.join(HERE, "traffic", "zz_added.json"):
             json.dumps({"task": "serve", "input": "crops", "crop": 32,
                         "pool": 16}),
             os.path.join(HERE, "limits", "capsule.zz_added.json"):
             json.dumps({"score_err": 1.0}),
             os.path.join(HERE, "metrics", "zz_added.py"):
             "def read(ctx):\n    return 42.0\n"}
    try:
        for path, text in added.items():
            with open(path, "w") as f:
                f.write(text)
        spec = json.loads(json.dumps(SPEC))
        spec["workloads"].append({"name": "capsule.zz_added",
                                  "config": "capsule",
                                  "traffic": "zz_added", "chips": 1,
                                  "why": "added by a test"})
        spec["per_layer"].append({"name": "zz_added", "unit": "1",
                                  "better": "higher",
                                  "source": "program_counter",
                                  "layer": "test", "moves": "serve_img_s",
                                  "workloads": ["capsule.zz_added"]})
        cell = harness.Cell(spec, "capsule.zz_added")
        assert cell.traffic["pool"] == 16
        assert [m["name"] for m in cell.per_layer] == ["zz_added"]
        assert harness.metric_reader("zz_added")(None) == 42.0
        assert cell.limits == {"score_err": 1.0}
    finally:
        for path in added:
            if os.path.exists(path):
                os.remove(path)


def test_darknet_train_flop_matches_the_published_count():
    """2.096 TFLOP a darknet_r train step at batch 32 (PERF.md)."""
    step = 32 * work.darknet_flop(448, 1, 43, train=True)
    assert step == 2_095_696_576_512
    assert work.darknet_flop(448, 1, 43) == 21_945_778_176


def test_kernel_work_by_hand():
    # K2: 32 x 448^2 x 32 outputs x 27 MACs; bytes: the image, the pooled
    # map, the weights and bias
    assert work.k2_work(32, 448) == (
        2 * 32 * 448 * 448 * 32 * 27,
        4 * (32 * 448 * 448 * 3 + 32 * 224 * 224 * 32 + 27 * 32 + 32))
    # K1: pools of 224^2 x 64, 112^2 x 128, 56^2 x 256, 28^2 x 512 inputs
    n = [32 * 224 * 224 * 64, 32 * 112 * 112 * 128, 32 * 56 * 56 * 256,
         32 * 28 * 28 * 512]
    assert work.k1_work(32, 448) == (sum(n), 4 * sum(m + m // 4 for m in n))
    # K3 at CapsuleNet's serving shape
    votes = 2 * 64 * 1296 * 43 * 8 * 16
    passes = 5 * 2 * 64 * 1296 * 43 * 16
    assert work.k3_work(64) == (
        votes + passes,
        4 * (64 * 1296 * 8 + 1296 * 43 * 8 * 16 + 64 * 43 * 16))
    flop, _ = work.k4_work(64)
    assert flop == 3 * votes + 11 * 2 * 64 * 1296 * 43 * 16
    # K1's four pools: 0.2876 ms at HBM's rate (PERF.md's bound)
    assert work.roofline_s(*work.k1_work(32, 448)) == pytest.approx(
        2.876e-4, rel=1e-3)


def test_capsule_flop_by_hand():
    cfg = harness.Cell(SPEC, "capsule.serve").config
    conv1 = 2 * 24 * 24 * 256 * 243
    primary = 2 * 81 * 128 * 256 * 64
    routing = 2 * 1296 * 43 * 128 + 5 * 2 * 1296 * 43 * 16
    assert work.capsule_flop(cfg, recon=False) == conv1 + primary + routing
    assert work.capsule_flop(cfg, train=True) == \
        3 * work.capsule_flop(cfg) - conv1
    # the widths come from the configuration: one routing iteration
    # fewer takes two node-sized passes off
    assert work.capsule_flop({**cfg, "n_iter": 2}, recon=False) == \
        conv1 + primary + routing - 2 * 2 * 1296 * 43 * 16


def test_small_cells_build():
    for name in CELLS:
        assert small_cell(name).config["batch_size"] <= 4
