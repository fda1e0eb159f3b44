# Single-entry targets for the tier-1 verify command and the perf benches.
# PYTHONPATH=src is pinned here so nobody has to remember it.

PY ?= python
export PYTHONPATH := src

.PHONY: test test-cov test-faults test-tenancy test-journal test-ingest \
	bench bench-multipart bench-smoke bench-migration bench-group \
	bench-serve bench-fault bench-multitenant bench-journal bench-ingest \
	bench-all lint lint-invariants

# Line-coverage floor for src/repro/core (the CI gate behind `make test-cov`).
# Baseline'd under the current suite; ratchet UP as coverage grows, never down.
COV_FLOOR ?= 80

test:           ## tier-1 verify: the command CI and the roadmap pin
	$(PY) -m pytest -x -q

# REPRO_FAULT_SEED=n selects the seeded fault schedule; CI sweeps 0..3.
test-faults:    ## fault-injection + durability suites under one seed
	$(PY) -m pytest -x -q tests/test_faults.py tests/test_durability.py \
		tests/test_faults_property.py

test-tenancy:   ## multi-tenant serve suites (fault-seed aware, CI matrix)
	$(PY) -m pytest -x -q tests/test_tenancy.py \
		tests/test_tenancy_property.py

test-journal:   ## WAL + integrity-scrub suites under one seed (CI matrix)
	$(PY) -m pytest -x -q tests/test_journal.py tests/test_scrub.py

test-ingest:    ## fused commit-wave suite under one seed (CI matrix)
	$(PY) -m pytest -x -q tests/test_ingest.py

test-cov:       ## tier-1 + line-coverage floor on src/repro/core (CI gate)
	@if $(PY) -c "import pytest_cov" >/dev/null 2>&1; then \
	  $(PY) -m pytest -x -q --cov=repro.core \
	    --cov-report=term-missing:skip-covered \
	    --cov-fail-under=$(COV_FLOOR); \
	else \
	  echo "pytest-cov not installed - running plain tier-1 suite"; \
	  $(PY) -m pytest -x -q; \
	fi

# Live engine code only: the unused seed modules (models/, configs/,
# data/) are out of lint scope so dead seed code can't mask real
# findings; tests/fixtures/ holds deliberately-broken analyzer fixtures.
LINT_PATHS := src/repro/core src/repro/serve src/repro/kernels \
	src/repro/train src/repro/launch src/repro/sharding.py \
	src/repro_torch tools benchmarks $(wildcard tests/*.py)

lint: lint-invariants ## syntax/undefined-name gate + invariant suite
	@$(PY) -c "import pyflakes" 2>/dev/null || \
	  { echo "ERROR: pyflakes missing - install with: pip install pyflakes"; exit 1; }
	$(PY) -m pyflakes $(LINT_PATHS)

lint-invariants: ## repro-analyze AST invariant suite (REPRO001-006, stdlib-only)
	$(PY) -m tools.analyze src/repro
	$(PY) -m tools.analyze src/repro_torch

bench:          ## batched checkout perf trajectory (BENCH_batched_checkout.json)
	$(PY) -m benchmarks.batched_checkout

bench-multipart: ## cross-partition wave vs P-launch loop (BENCH_multipart_checkout.json)
	$(PY) -m benchmarks.multipart_checkout

bench-smoke:    ## tiny-shape kernel-path canary (CI): wave engine + online migration
	BENCH_SMOKE=1 $(PY) -m benchmarks.multipart_checkout
	BENCH_SMOKE=1 $(PY) -m benchmarks.online_migration
	BENCH_SMOKE=1 $(PY) -m benchmarks.group_superblock
	BENCH_SMOKE=1 $(PY) -m benchmarks.pipelined_serve
	BENCH_SMOKE=1 $(PY) -m benchmarks.fault_recovery
	BENCH_SMOKE=1 $(PY) -m benchmarks.multitenant_serve
	BENCH_SMOKE=1 $(PY) -m benchmarks.journal_recovery
	BENCH_SMOKE=1 $(PY) -m benchmarks.commit_ingest

bench-migration: ## incremental vs rebuild migration (BENCH_online_migration.json)
	$(PY) -m benchmarks.online_migration

bench-group:    ## budget-aware partial fusion vs perpart fallback (BENCH_group_superblock.json)
	$(PY) -m benchmarks.group_superblock

bench-serve:    ## pipelined vs synchronous serve stream (BENCH_pipelined_serve.json)
	$(PY) -m benchmarks.pipelined_serve

bench-fault:    ## snapshot overhead + kill/restore recovery (BENCH_fault_recovery.json)
	$(PY) -m benchmarks.fault_recovery

bench-multitenant: ## N-tenant serve vs one server: throughput/fairness/shed (BENCH_multitenant_serve.json)
	$(PY) -m benchmarks.multitenant_serve

bench-journal:  ## journal write overhead + RPO + recovery curve (BENCH_journal_recovery.json)
	$(PY) -m benchmarks.journal_recovery

bench-ingest:   ## fused commit wave vs serial commit loop (BENCH_commit_ingest.json)
	$(PY) -m benchmarks.commit_ingest

bench-all:      ## every paper-figure benchmark
	$(PY) -m benchmarks.run
