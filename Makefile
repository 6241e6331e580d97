# Top-level build for phaserotate_tpu (the reference Makefile's role, C25):
# native library, LV2-style TTL bundle, tests, benchmarks, man pages.

PREFIX  ?= /usr/local
DESTDIR ?=
PYTHON  ?= python

VERSION := $(shell git describe --tags --always 2>/dev/null || echo 0.1.0)

all: native bundle

native:
	$(MAKE) -C native

bundle:
	$(PYTHON) -c "from phaserotate_tpu.plugin.ttl import write_bundle; \
	write_bundle('build/phaserotate_tpu.lv2')"

test:
	$(PYTHON) -m pytest tests/ -x -q

# on-card suite: the compiled sweep kernel and the runtime paths on the
# GPU backend (each test skips, with its reason, on any other)
test-gpu:
	$(PYTHON) -m pytest tests_gpu/ -x -q

bench:
	$(PYTHON) bench.py

man: doc/phase-rotate.1 doc/prt_bridge.1 doc/phaserotate-bridge.1 doc/phase-rotate-fleet.1

install: native bundle
	install -d $(DESTDIR)$(PREFIX)/lib/lv2/phaserotate_tpu.lv2
	install -m644 build/phaserotate_tpu.lv2/*.ttl \
	  $(DESTDIR)$(PREFIX)/lib/lv2/phaserotate_tpu.lv2/
	install -m755 build/phaserotate_tpu.lv2/phaserotate_tpu.so \
	  $(DESTDIR)$(PREFIX)/lib/lv2/phaserotate_tpu.lv2/
	install -d $(DESTDIR)$(PREFIX)/bin
	install -m755 native/prt_bridge $(DESTDIR)$(PREFIX)/bin/
	install -d $(DESTDIR)$(PREFIX)/share/man/man1
	install -m644 doc/*.1 $(DESTDIR)$(PREFIX)/share/man/man1/

clean:
	$(MAKE) -C native clean
	rm -rf build

.PHONY: all native bundle test test-gpu bench man install clean
