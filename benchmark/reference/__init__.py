"""The benchmark's plain reference of the IDR training step: frozen copies
of the port's plain modules (imports rewritten, weights drawn on the
device, the fused SDF MLP as its plain twin, the tracer's loops as host
loops) and the step (``step.py``).  Imports neither JAX nor the port."""
