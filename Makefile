.PHONY: all native test test-fast bench lint clean

all: native test

native:
	$(MAKE) -C native

test: native
	python -m pytest tests/ -q

test-fast: native
	python -m pytest tests/ -q -m "not slow"

bench:
	python bench.py

lint:
	python -c "import ast, os, sys; \
files = [os.path.join(r, f) for r, _, fs in os.walk('whisper_ipa') for f in fs if f.endswith('.py')]; \
[ast.parse(open(f).read(), f) for f in files]; \
print(len(files), 'files parse cleanly')"

clean:
	$(MAKE) -C native clean
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
