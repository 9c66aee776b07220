"""Serving stack of the port: quantized weights, cache pool, engine, API,
scheduler. Import the submodules directly (``repro_torch.serving.engine``)."""
