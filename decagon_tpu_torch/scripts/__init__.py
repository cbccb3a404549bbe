"""Probes of the port's kernels on the card (ports of the JAX package's ``scripts/probe_*``)."""
