"""A run's outer contract, on the CPU: no card, no result; nothing of
JAX loaded; the result line's keys."""

import json
import os
import subprocess
import sys
import time
import types

from h100_bench import harness
from h100_bench.tests.small import SEED, small_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_without_a_card_it_exits_non_zero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload",
         "darknet_r.serve", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no CUDA card" in res.stderr


def test_jax_names_are_compared_whole(monkeypatch):
    for name in ("cs231_capsule_yolo_traffic_sign_detection_tpu_torch",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.jax_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert harness.jax_modules() == ["jax"]


def test_a_run_loads_nothing_of_jax():
    code = (
        "import sys, time\n"
        "from h100_bench import harness\n"
        "from h100_bench.tests.small import SEED, small_cell\n"
        "for name in ('darknet_r.serve', 'capsule.train'):\n"
        "    harness.run_cell(small_cell(name), SEED, 0.2, False, 'cpu',\n"
        "                     time.time())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    loaded = set(json.loads(res.stdout.strip().splitlines()[-1]
                            .replace("'", '"')))
    assert not loaded & harness.JAX_NAMES
    assert "cs231_capsule_yolo_traffic_sign_detection_tpu_torch" in loaded


def test_the_result_line_has_the_contract_s_keys():
    for trace in (False, True):
        r = harness.run_cell(small_cell("capsule.serve"), SEED, 0.2, trace,
                             "cpu", time.time())
        keys = KEYS + (["breakdown"] if trace else []) + ["checks"]
        assert list(r) == keys
        assert r["correct"] is True
        json.dumps(r)
        for c in r["checks"].values():
            assert set(c) == {"value", "limit"}
