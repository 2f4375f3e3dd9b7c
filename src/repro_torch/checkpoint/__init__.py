"""Checkpoints of a session (``checkpointer``): the reference's layout on
disk, the port's tensors and generators."""
