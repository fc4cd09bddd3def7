"""Ranks, meshes and sharding rules for the sharded FL engine."""
