"""Validation of the port's activity statistics.  So far only the moment
carry of the ``spike_stats`` stream probe (``stats``); the finalizers, the
reference bands and the report wait for the validation slice."""
