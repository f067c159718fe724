"""The port's command line for monthly data (``python -m csmom_tpu_torch.cli``)."""
