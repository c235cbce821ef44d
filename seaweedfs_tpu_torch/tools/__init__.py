"""tools — command-line experiments that run the port's kernels on the card."""
