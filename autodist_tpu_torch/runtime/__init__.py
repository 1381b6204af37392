"""Runtime layer of the port: the ``torch.distributed`` process group."""
