"""Evaluation loop and checkpoints (training is ROADMAP queue 3)."""
