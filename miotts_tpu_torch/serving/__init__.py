"""HTTP serving of the port (miotts_tpu/serving/): continuous batching of
LLM lanes over replayed chunk graphs, codec micro-batching over the
pipeline's codec graphs, and the HTTP server."""
