"""Logical-axis sharding rules and the ambient mesh of the port."""
