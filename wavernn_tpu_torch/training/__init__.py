"""Training runtimes of the port (ports ``wavernn_tpu/training``)."""
