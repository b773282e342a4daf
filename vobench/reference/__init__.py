"""The plain reference of the benchmark's check: the VO step, the
windowed VO step and the layers under them in plain PyTorch, frozen from
the port's plain code with each CUDA kernel replaced by its plain form
(`twins.py`).  It imports nothing of the port or of JAX, and takes
nothing the port has made: it starts from the same uint8 pairs and the
same RANSAC seed and works every intermediate out again."""
