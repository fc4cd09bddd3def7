"""Compressor core: PRNG chains, policy, rSVD, GradESTC, codecs, ledger."""
