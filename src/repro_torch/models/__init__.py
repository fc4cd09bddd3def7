"""Transformer families (dense, MoE, VLM): config, layers, MoE FFN, stack, loss."""
