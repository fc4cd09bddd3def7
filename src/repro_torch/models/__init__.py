"""Dense transformer: config, layers, stack, loss."""
