# merpcr-tpu build/test harness (parity with reference Makefile:18-45)

PY ?= python
# tests and the fuzzer run on the CPU backend; `make smoke` needs a GPU
CPUENV = JAX_PLATFORMS=cpu

.PHONY: test test-unit test-integration test-cli test-parallel test-perf \
        bench smoke fuzz scaling baseline deps native clean help

help:
	@echo "targets: test test-unit test-integration test-cli test-parallel"
	@echo "         test-perf bench smoke fuzz scaling baseline deps native clean"

test:
	$(CPUENV) $(PY) -m pytest tests/ -q

test-unit:
	$(CPUENV) $(PY) -m pytest tests/ -q -m unit

test-integration:
	$(CPUENV) $(PY) -m pytest tests/ -q -m integration

test-cli:
	$(CPUENV) $(PY) -m pytest tests/ -q -m cli

test-parallel:
	$(CPUENV) $(PY) -m pytest tests/ -q -m parallel

test-perf:
	$(CPUENV) $(PY) -m pytest tests/ -q -m performance

bench:
	$(PY) bench.py

smoke:
	$(PY) chip_smoke.py

fuzz:
	$(CPUENV) $(PY) tools/difffuzz.py 30 0

scaling:
	$(CPUENV) XLA_FLAGS=--xla_force_host_platform_device_count=8 \
	    $(PY) tools/scaling_report.py

baseline:
	$(PY) scripts/performance_baseline.py establish

deps:
	$(PY) scripts/dependency_validation.py

native:
	$(PY) -c "from merpcr_tpu.native import get_lib; print('native codec:', bool(get_lib()))"

clean:
	rm -rf build dist *.egg-info .pytest_cache
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
	rm -f merpcr_tpu/native/libmp_fasta_codec.so
