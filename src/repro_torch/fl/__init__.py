"""Federated round loop and the compression methods it runs."""
