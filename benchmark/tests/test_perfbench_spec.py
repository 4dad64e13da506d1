"""BENCHMARK.json's form, and the files the harness finds by name."""

import json
import os
import re
import subprocess
import sys

import pytest

from benchmark import harness

SPEC = harness.spec()


BENCHES = pytest.mark.parametrize("bench", [SPEC], ids=["committed"])
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head)_size$|_dim$|_rank$|"
                   r"expansion|experts_per_tok")


def one_line(text, most=200):
    return isinstance(text, str) and 1 <= len(text) <= most and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    with open(os.path.join(harness.CHECKOUT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(one_line(w) and not w.startswith("/") and ".." not in w
               for w in SPEC["command"])


@BENCHES
@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_names_and_text(bench, section):
    entries = bench[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for text in ("why", "layer"):
            if text in e:
                assert one_line(e[text]), (e["name"], text)
        if section == "configs":
            assert one_line(e["source"])


@BENCHES
def test_metric_sources_and_bounds(bench):
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
    setup = [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25 and "workloads" not in setup[0]


@BENCHES
def test_configs_files_and_cuts(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert c["name"] in used and c["source"].startswith("https://")
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        with open(os.path.join(harness.CHECKOUT, c["file"])) as f:
            body = json.load(f)
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key


@BENCHES
def test_workloads_find_their_files_and_report_enough(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(bench["workloads"])
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        cell = harness.cell(w["name"], bench=bench)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in reported, (w["name"], m["name"])
            assert callable(harness.reader(m["name"]))
        assert set(cell.limits) and all(v >= 0 for v in cell.limits.values())
    for m in bench["per_layer"]:
        assert m["moves"] in e2e


def test_run_seconds_fits_a_full_check_of_24_cells():
    s = SPEC["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_resiliency_torch_fake.x", object())
    monkeypatch.setitem(sys.modules, "jaxfake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tpu_resiliency.fake", object())
    assert harness.forbidden_modules() == ["tpu_resiliency"]


CHILD = """
import dataclasses, sys, time
import torch
torch.set_num_threads(1)
from benchmark import harness
t = harness.cell("mistral7b-l2.train")
tiny = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_attention_heads=4,
            num_key_value_heads=2, torch_dtype="float32",
            assumed=dict(t.config["assumed"], seq_len=16, micro_batch=2))
t = dataclasses.replace(t, config=dict(t.config, **tiny))
harness.run_cell(t, 5, 0.2, False, "cpu", time.time())
import benchmark.control, benchmark.run
print(harness.forbidden_modules())
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=harness.CHECKOUT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
