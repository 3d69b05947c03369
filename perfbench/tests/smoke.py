"""A throwaway copy of the benchmark with cells at the configurations'
CPU smoke sizes (f32, 2 layers), built by adding files and entries only:
how a later change adds a cell."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

CONFIGS = {
    "i2-smoke": {
        "name": "i2-smoke", "family": "transformer", "reference": "internlm2_20b",
        "model": {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
                  "num_key_value_heads": 2, "head_dim": 16, "num_hidden_layers": 2,
                  "vocab_size": 512, "rope_theta": 1e6, "rms_norm_eps": 1e-6},
        "port": {"arch": "internlm2-20b", "fields": {
            "n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
            "d_ff": 128, "vocab_size": 512, "param_dtype": "float32",
            "compute_dtype": "float32", "attn_chunk": 16}}},
    "m2-smoke": {
        "name": "m2-smoke", "family": "mamba2", "reference": "mamba2_2_7b",
        "model": {"d_model": 64, "n_layer": 2, "vocab_size": 512, "d_state": 16, "d_conv": 4,
                  "expand": 2, "headdim": 8, "chunk_size": 8, "rms_norm_eps": 1e-6},
        "port": {"arch": "mamba2-2.7b", "fields": {
            "n_layers": 2, "d_model": 64, "ssm_state": 16, "mamba_headdim": 8,
            "mamba_expand": 2, "ssd_chunk": 8, "vocab_size": 512, "param_dtype": "float32",
            "compute_dtype": "float32"}}},
}
MIXES = {
    "smoke-open": {"loop": "open", "rate_per_s": 10,
                   "prompt_len": {"dist": "lognormal", "median": 24, "sigma": 0.8,
                                  "min": 4, "max": 40},
                   "output_len": {"dist": "uniform", "min": 2, "max": 8}},
    "smoke-closed": {"loop": "closed", "clients": 3, "requests_per_client": 40,
                     "prompt_len": {"dist": "uniform", "min": 20, "max": 60},
                     "output_len": {"dist": "uniform", "min": 2, "max": 5}},
}
PAGED = {"max_batch": 4, "max_seq": 128, "prefill_chunk": 16, "block_size": 8, "paged": True,
         "decode_interleave": 1}
SLOTS = {"max_batch": 4, "max_seq": 128, "prefill_chunk": 16, "paged": False,
         "decode_interleave": 1}
CELLS = {  # cell: (config, mix, engine)
    "i2-open": ("i2-smoke", "smoke-open", PAGED),
    "i2-closed": ("i2-smoke", "smoke-closed", PAGED),
    "m2-open": ("m2-smoke", "smoke-open", SLOTS),
}
LIMITS = {"max_gap": 1e-3, "short": 0}  # f32 at smoke size: the served token is the best


def build(tmp: Path) -> Path:
    """A checkout at ``tmp`` holding BENCHMARK.json and perfbench/ with the
    smoke cells added as new files and entries."""
    shutil.copytree(REPO / "perfbench", tmp / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, cfg in CONFIGS.items():
        (tmp / "perfbench/configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, mix in MIXES.items():
        (tmp / "perfbench/traffic" / f"{name}.json").write_text(json.dumps(mix))
    for name, (cfg, mix, engine) in CELLS.items():
        (tmp / "perfbench/workloads" / f"{name}.json").write_text(json.dumps(
            {"engine": engine, "warmup": {"requests": 2, "prompt_len": 40, "max_new_tokens": 2},
             "trace_span_s": 1, "check": {"sample_tokens": 200, "max_requests": 12,
                                          "limits": LIMITS}}))
        bench["workloads"].append({"name": name, "config": cfg, "traffic": mix, "chips": 1,
                                   "why": "CPU smoke"})
        for m in bench["end_to_end"]:
            if "workloads" in m and MIXES[mix]["loop"] == "open":
                m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
