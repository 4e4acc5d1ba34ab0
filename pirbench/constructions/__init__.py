"""Files found by name from BENCHMARK.json (see ../__init__.py)."""
