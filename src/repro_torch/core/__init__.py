"""Core of the port: model parameters, connectome, neuron, delivery,
stimulus and the engine's phases."""
