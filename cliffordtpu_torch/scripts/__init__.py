"""The port's command-line entry points, run as ``python -m
cliffordtpu_torch.scripts.<name>`` (ports of ``scripts/<name>.py``)."""
