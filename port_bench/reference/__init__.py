"""The plain reference: PyTorch in float64, importing nothing of the
port, the JAX package or JAX.  It judges what the timed calls returned
against the benchmark's own inputs."""
