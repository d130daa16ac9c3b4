"""Plain PyTorch references of what the benchmark serves, one module per
architecture (:mod:`reference.qwen3`: the Qwen3 forward in fp32), each
handed to the harness by ``archs/<model_type>.py``.  Written from the
published equations; they import nothing of the program under test."""
