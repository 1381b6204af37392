"""Paged-KV serving of the port: page pool, engine, continuous batcher and
HTTP front end (``python -m autodist_tpu_torch.serve``)."""
