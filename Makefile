# CI analog of the reference's Makefile (Makefile:44-70: per-package
# unit tests, -race variants, lint) for a no-external-deps environment.

PY ?= python

.PHONY: test test-race chaos lint verify bench autotune autotune-check all

all: lint test

test:
	$(PY) -m pytest tests/ -q

# Race-amplified run: tests/conftest.py lowers the interpreter's thread
# switch interval to force frequent preemption at the concurrency seams
# (the Go -race analog available to pure Python — races surface as
# corrupted state/assertions in the stress tests rather than reports).
test-race:
	VPP_TPU_RACE=1 $(PY) -m pytest tests/test_concurrency.py tests/test_io.py \
		tests/test_native_ring.py tests/test_kvserver.py \
		tests/test_vcl_preload.py tests/test_multihost_unit.py \
		tests/test_kvstore_fencing.py -q

# Seeded fault-injection schedules (ISSUE 8): kvstore partitions,
# ring fault → dispatch fallback, dispatch fetch/tx faults, torn
# snapshots, reconnect storms — each asserting exact packet/session
# conservation after recovery. Seeds default inside the tests
# (override: VPPT_CHAOS_SEED=n); bounded runtime; also marked `slow`
# so the tier-1 `-m 'not slow'` timing budget never pays for it.
chaos:
	$(PY) -m pytest tests/test_chaos.py -q -m chaos

# Base style pass + the pure-AST analysis passes (tools/analysis/):
# --jax tracer/recompile hygiene, --threads lock discipline,
# --partitions rule completeness (pure import, no jax arrays), and the
# ISSUE 20 device-boundary dataflow passes: --uploads group-staleness,
# --transfers host-fetch allowlisting, --donate use-after-donate. The
# registry passes (--metrics/--counters/--tables) import jax, so
# tier-1 runs them from tests instead (test_exposition / test_acl_bv).
# autotune-check rides along: a drifted tuned/cpu.json is a lint-class
# failure (the committed profile must round-trip the config loader).
lint: autotune-check
	$(PY) tools/lint.py --jax --threads --partitions --uploads \
		--transfers --donate

# Driver-facing headline benchmark (real TPU; one JSON line).
bench:
	$(PY) bench.py

# Config-knob autotuner (ISSUE 16; tools/autotune.py): sweep the
# backend-dependent geometry knobs and write tuned/<backend>.json.
autotune:
	$(PY) tools/autotune.py

# Validate the committed CPU profile round-trips through the SAME
# config loader the agent boots with (knobs land, floor clamps).
autotune-check:
	$(PY) tools/autotune.py --check tuned/cpu.json

# The PyTorch/CUDA port (vpp_tpu_torch/): its static-analysis gate (the
# style pass and every pass of vpp_tpu_torch/analysis/, exit 1 on any
# finding), its CPU tests, and its smoke on one H100 (chip_smoke.py
# exits nonzero without a card).
.PHONY: lint-torch test-torch smoke

lint-torch:
	$(PY) -m vpp_tpu_torch.analysis --all

test-torch:
	$(PY) -m pytest tests/test_torch_*.py -q

smoke:
	python3 chip_smoke.py
