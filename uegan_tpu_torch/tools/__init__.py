"""Command-line tools of the port: ``export_model`` (a ``torch.export``
program of the inference forward)."""
