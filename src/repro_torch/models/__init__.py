"""Language-model layers of the port (``layers``: attention through K6,
SwiGLU MLP, norms and rotary embeddings)."""
