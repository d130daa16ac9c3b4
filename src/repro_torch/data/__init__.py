"""Data: deterministic synthetic LM batches with an SMR-managed prefetch
ring (``pipeline``) and a byte tokenizer (``tokenizer``), verbatim copies
of the JAX package's modules."""
