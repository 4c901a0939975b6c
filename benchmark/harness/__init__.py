"""The general parts of a run: environment, devices, weights from the seed,
the measured window, the trace and the import check."""
