"""Optimizers as (init, update) pairs over {path: tensor} dicts."""
