"""Training substrate (counterpart of ``repro.training``): AdamW with a
cosine schedule and global-norm clipping, and flat-file checkpoints."""
