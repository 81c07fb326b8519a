"""The benchmark's plain reference: a frozen copy of the port's plain PyTorch version."""
