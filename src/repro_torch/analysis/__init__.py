"""Runtime checks of the port: the capture guard (``sanitize``)."""
