"""PyTorch/CUDA port of the GradESTC federated-learning system.

The JAX package ``repro`` is the reference; this package imports nothing of
it and never imports jax.  Entry point: ``repro_torch.fl.simulation.run_fl``.
"""
