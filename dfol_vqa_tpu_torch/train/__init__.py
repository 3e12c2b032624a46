"""Training and evaluation loop, optimizer and checkpoints."""
