"""Tests of the benchmark harness (run: python -m pytest pirbench/tests -q)."""
