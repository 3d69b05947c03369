"""BENCHMARK.json and the per-name files it points at: names, units and
keys as BENCHMARK.json's format has them, every metric's reader agreeing
with its entry, every cell's files present, and a throwaway cell added by
new files alone running end to end on the CPU."""

from __future__ import annotations

import dataclasses
import json
import re
import time
from pathlib import Path

import pytest

from perfbench.harness.manifest import Manifest, load_module
from perfbench.tests import smoke

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_check_time_fits_with_24_cells():
    run = BENCH["run_seconds"] + 60
    assert 2 * run + 14 * 24 * run + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in seen
            seen.add(e["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"]) and NAME.match(w["traffic"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]


def test_end_to_end_bounds_and_setup():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert {"setup_s", "tokens_per_s", "ttft_p90_ms", "itl_mean_ms"} <= names
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_config_has_a_cell_and_every_cell_its_files():
    man = Manifest(REPO)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        st = man.cell_settings(w["name"])
        assert set(st) == {"engine", "warmup", "check", "trace_span_s"}
        cfg = man.config(w["config"])
        man.traffic(w["traffic"])
        assert hasattr(man.reference_module(cfg), "logits")
        assert hasattr(man.counts_module(cfg), "flops")
        reported = {m["name"] for m in man.end_to_end(w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        assert man.per_layer(w["name"]), w["name"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_reader_agrees(metric):
    m = next(e for e in BENCH["per_layer"] if e["name"] == metric)
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    mod = load_module(REPO / "perfbench/metrics" / f"{metric}.py")
    assert (mod.LAYER, mod.UNIT, mod.BETTER, mod.MOVES) == (m["layer"], m["unit"],
                                                          m["better"], m["moves"])
    assert _line(m["layer"]) and m["layer"] in (REPO / "PERF.md").read_text()
    if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
        assert m["unit"] == "%"
    man = Manifest(REPO)
    for cell in m["workloads"]:
        man.cell(cell)
        assert m["moves"] in {e["name"] for e in man.end_to_end(cell)}


def test_kernel_rooflines_have_an_mfu_beside_them():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert any("mfu" in o["name"] and o["moves"] == m["moves"]
                       and set(m["workloads"]) <= set(o["workloads"])
                       for o in BENCH["per_layer"])


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_model_block_matches_the_port(name):
    """The reference reads ``model``, the engine is built from ``port``:
    they describe one model, and the port's config takes every field."""
    from perfbench.harness.engine import port_config

    cfg_file = Manifest(REPO).config(name)
    m, cfg = cfg_file["model"], port_config(cfg_file)
    if cfg_file["family"] == "transformer":
        want = dict(d_model=m["hidden_size"], n_layers=m["num_hidden_layers"],
                    n_heads=m["num_attention_heads"], n_kv_heads=m["num_key_value_heads"],
                    head_dim=m["head_dim"], d_ff=m["intermediate_size"],
                    vocab_size=m["vocab_size"], rope_theta=m["rope_theta"],
                    tie_embeddings=m["tie_word_embeddings"])
    else:
        want = dict(d_model=m["d_model"], n_layers=m["n_layer"], ssm_state=m["d_state"],
                    mamba_headdim=m["headdim"], mamba_expand=m["expand"],
                    ssd_chunk=m["chunk_size"], vocab_size=m["vocab_size"],
                    tie_embeddings=m["tie_embeddings"])
    got = {k: getattr(cfg, k) for k in want}
    assert got == want
    assert {k: v for k, v in dataclasses.asdict(cfg).items()
            if k in cfg_file["port"]["fields"] and not k.endswith("dtype")} == {
        k: v for k, v in cfg_file["port"]["fields"].items() if not k.endswith("dtype")}


def test_throwaway_cell_runs_from_new_files_alone(tmp_path):
    """A cell added by new files and BENCHMARK.json entries only runs end to
    end (CPU, smoke size) and reports the end-to-end metrics its entries
    name."""
    from perfbench.harness.bench import run_cell

    root = smoke.build(tmp_path)
    result, compared = run_cell(root, "i2-closed", seed=2**33 + 5, seconds=1.0, trace=False,
                                t_start=time.perf_counter(), device="cpu")
    assert set(result["metrics"]) == {"tokens_per_s", "setup_s"}
    assert result["metrics"]["tokens_per_s"]["value"] > 0
    assert result["correct"], compared
    assert list(compared) == ["max_gap", "short"]
