"""Training substrate: AdamW, checkpoints, the fault supervisor and
gradient compression (the port of ``repro.train``)."""
