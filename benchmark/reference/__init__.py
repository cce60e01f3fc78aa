"""Plain references of the benchmark's configurations: plain PyTorch,
importing nothing of the program under test (nor JAX)."""
