"""Command-line tools that run on the card (``python -m
linr_pcgc_tpu_torch.tools.<name>``)."""
