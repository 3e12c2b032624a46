"""Experiment runners, the CLI entry point and the curriculum chain."""
