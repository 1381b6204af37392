"""Ops of the port: the paged-attention kernel and its plain version."""
