"""Plain PyTorch reference of what the benchmark serves: the Qwen3 forward
in fp32 (:mod:`reference.qwen3`).  Written from the published equations;
it imports nothing of the program under test."""
