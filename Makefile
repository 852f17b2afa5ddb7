# Convenience targets mirroring the reference's Makefile contract
# (all/cpu/test/clean).

PY ?= python

.PHONY: all test bench native dryrun clean

all: native

native:
	cc -O2 -shared -fPIC native/fourspl.c -o native/libfourspl.so
	cc -O3 -march=native -ffp-contract=off -shared -fPIC native/hypersonic2d_cpu.c \
		-o native/libhypersonic2d_cpu.so -lm
	cc -O2 -shared -fPIC native/nbody_bh.c -o native/libnbody_bh.so \
		-lpthread -lm

# write-baseline / verify-baseline round trip (the reference's `make test`
# contract, Makefile:39-43)
regression:
	$(PY) -m fluidsims_tpu.cli regression --nx 512 --ny 256 --steps 24 \
		--baseline /tmp/fst_baseline.snap --write-baseline
	$(PY) -m fluidsims_tpu.cli regression --nx 512 --ny 256 --steps 24 \
		--baseline /tmp/fst_baseline.snap

test:
	$(PY) -m pytest tests/ -q

bench:
	$(PY) bench.py

dryrun:
	JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
		$(PY) -c "import __graft_entry__ as g; g.dryrun_multichip(8)"

clean:
	rm -f native/libfourspl.so native/libhypersonic2d_cpu.so \
		native/libnbody_bh.so
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
