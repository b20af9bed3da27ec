"""Plain PyTorch reference of the tracked model, its render, its tracking
step and its training step. It imports nothing of the program under test:
the benchmark hands the same inputs (mesh, weights, frames, draws) to both
sides and the reference works out everything else itself."""
