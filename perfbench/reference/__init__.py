"""Plain float32 PyTorch references of the benchmark's models; they import
nothing of the program."""
