# Developer workflow (mirrors the reference's Makefile roles: init/test/dist,
# plus the native formatter and benchmark targets).

PYTHON ?= python

.PHONY: test test-fast native bench baseline clean dist

native:
	$(PYTHON) -m ptmcmcsampler_tpu.io.build_native

test: native
	$(PYTHON) -m pytest tests/ -x -q

test-fast:
	$(PYTHON) -m pytest tests/ -x -q -m "not slow"

bench:
	$(PYTHON) bench.py

baseline:
	$(PYTHON) tools/measure_baseline.py 100000

dist:
	$(PYTHON) -m pip wheel --no-deps -w dist .

clean:
	rm -rf dist build csrc/libchainio.so **/__pycache__
