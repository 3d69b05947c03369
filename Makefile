# Test entry points.  Tier-1 is the gate every PR must keep green; the slow
# tier covers the heavy end-to-end paths, including the prefix-sharing
# serving bench smoke (tests/test_serving.py -m slow).  lint-streams is the
# stream-safety analyzer (required in CI alongside tier-1).
PYTHONPATH := src

.PHONY: test test-slow lint-streams bench bench-check tune trace doctor

test:  ## tier-1 gate (pytest.ini already excludes -m slow)
	PYTHONPATH=$(PYTHONPATH) python -m pytest -x -q -m "not slow"

test-slow:  ## heavy end-to-end paths + the sharing bench smoke
	PYTHONPATH=$(PYTHONPATH) python -m pytest -q -m slow

lint-streams:  ## stream-safety analyzer: sync audit, kernel lint, pool audit
	PYTHONPATH=$(PYTHONPATH) JAX_PLATFORMS=cpu python -m repro.analysis

.PHONY: lint-streams-torch
lint-streams-torch:  ## the port's analyzer, static passes on the CPU (on a card: drop --device cpu for the live sync audit)
	PYTHONPATH=$(PYTHONPATH) python -m repro_torch.analysis --device cpu

bench:  ## paper-figure benchmarks (CSV to stdout; refreshes BENCH_serving.json)
	PYTHONPATH=$(PYTHONPATH) python -m benchmarks.run

bench-check:  ## perf-regression sentinel: fresh bench vs committed BENCH_*.json
	PYTHONPATH=$(PYTHONPATH) JAX_PLATFORMS=cpu python -m repro.obs.baseline --run

doctor:  ## diagnose the last traced run (make trace writes trace.json)
	PYTHONPATH=$(PYTHONPATH) python -m repro.obs.doctor trace.json

trace:  ## traced serving smoke: writes trace.json (open at ui.perfetto.dev)
	PYTHONPATH=$(PYTHONPATH) JAX_PLATFORMS=cpu python -m repro.launch.serve \
	    --arch qwen3-4b --requests 4 --prompt-len 64 --new-tokens 8 \
	    --prefill-chunk 16 --max-batch 2 --paged \
	    --trace trace.json --metrics

tune:  ## capped-budget smoke tune on CPU; plan persists to .tuning-cache/
	PYTHONPATH=$(PYTHONPATH) JAX_PLATFORMS=cpu python -m repro.launch.serve \
	    --arch qwen3-4b --requests 4 --prompt-len 64 --new-tokens 8 \
	    --prefill-chunk 16 --max-batch 2 --paged \
	    --autotune --tune-budget 6 --tuning-db .tuning-cache/tuning.json
