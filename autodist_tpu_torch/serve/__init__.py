"""Paged-KV serving of the port: page pool, engine, continuous batcher and
HTTP front end (``python -m autodist_tpu_torch.serve``), with counter-based
stochastic sampling (``sampling.py``), speculative decode (``spec.py``) and
copy-on-write prefix sharing (``prefix.py``)."""
