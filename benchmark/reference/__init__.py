"""The plain reference the benchmark's check holds the port against: plain
PyTorch, imports nothing of the port."""
